"""moma_tpu_torch — the MoMA distillation framework on PyTorch + CUDA.

A port of the JAX package `moma_tpu` to PyTorch, with the Pallas TPU
kernels of its main path rewritten as hand-written CUDA C++ kernels for
NVIDIA Hopper (sm_90a).  The module layout mirrors `moma_tpu`, so each
module's counterpart sits at the same relative path there:

    core/    config tree, LR schedule, metrics
    models/  EfficientNet B0-B7 with the feature-list contract
    losses/  CE / KD losses
    moma/    MoCo queue state machine (MoCo, MoCoAtt, MoCoST, MoCoSSTT),
             CMO heads, batch-token attention
    data/    device-side augmentation (RandAugment layers, normalize),
             host pipeline, histo manifests and packed cache
    ops/     kernel wrappers: CUDA kernel on a CUDA tensor, plain PyTorch
             version on a CPU tensor (csrc/ holds the CUDA sources)
    train/   train state, MoMA step, epoch loop, evaluation
    cli/     entry points

The package imports torch, never jax and nothing of `moma_tpu`: where it
needs one of that package's numpy-only modules (the histo dataset reader,
the checkpoint converter behind `interop`) it keeps its own copy under the
same name.
"""

__version__ = "0.1.0"
