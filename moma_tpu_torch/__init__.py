"""moma_tpu_torch — the MoMA distillation framework on PyTorch + CUDA.

A port of the JAX package `moma_tpu` to PyTorch, with the Pallas TPU
kernels of its main path rewritten as hand-written CUDA C++ kernels for
NVIDIA Hopper (sm_90a).  The module layout mirrors `moma_tpu`, so each
module's counterpart sits at the same relative path there:

    core/    config tree, LR schedule, metrics, checkpoints and stat files,
             TensorBoard writer, preemption guard, profiling
    models/  EfficientNet B0-B7 and the ViT / DeiT family with the
             feature-list contract, pretrained weights (--std_pre /
             --tec_pre), augreg .npz loading
    losses/  CE / KD losses
    moma/    MoCo queue state machine (MoCo, MoCoAtt, MoCoST, MoCoSSTT),
             CMO heads (cross-arch EmaTec heads, RFF head), batch-token
             attention and its maps
    data/    device-side augmentation (resized crop, RandAugment layers,
             normalize), host pipeline, histo manifests and packed cache
    ops/     kernel wrappers: CUDA kernel on a CUDA tensor, plain PyTorch
             version on a CPU tensor (csrc/ holds the CUDA sources)
    train/   train state, MoMA step (same-arch and cross-arch), the run
             around it (checkpoints, resume, preemption), epoch loop,
             evaluation
    cli/     entry points (train_student, test_eval, profile_step, ab_runs)

The package imports torch, never jax and nothing of `moma_tpu`: where it
needs one of that package's modules without JAX (the histo dataset reader,
the checkpoint converter behind `interop`, the TensorBoard writer, the
preemption guard) it keeps its own copy under the same name.
"""

__version__ = "0.1.0"
