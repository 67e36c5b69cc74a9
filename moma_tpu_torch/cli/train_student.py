"""CLI: knowledge-distillation student training on PyTorch.

Counterpart of moma_tpu/cli/train_student.py: --distill moma routes to the
paper's method (train/moma.run_moma), every other method to the
comparison distillers (train/student.run_student):

    python -m moma_tpu_torch.cli.train_student --distill moma \
        --dataset prostate_hv --model_s effiB0 --model_t effiB0 \
        -c 1 -d 1 -b 1 --feat_dim 512 --head mlp --attn self --mem MoCo \
        --nce_k 16384 --batch_size 64 --image_size 512 --synthetic \
        --save_dir ./save
    python -m moma_tpu_torch.cli.train_student --distill crd -c 1 -d 1 \
        -b 0.8 --dataset prostate_hv --model_s effiB0 --model_t effiB0 \
        --path_t save/teacher_<run>/ckpt/best_acc.pt --batch_size 64 \
        --image_size 512 --synthetic

The run writes `<save_dir>/moma_<run name>/` (or `student_<run name>/`):
`ckpt/{latest,best_acc,best_f1}.pt` with their `.meta.json`, `stat.json`,
`scalars.jsonl`, `tb/events.out.tfevents.*` and `parameters.json`; the
same command with `--resume` continues from `ckpt/latest.pt`, also
mid-epoch after SIGTERM.  --std_pre / --tec_pre / --path_t take a path (a
run's `ckpt/best_acc.pt`, a teacher run's too, a torch state dict) or a
preset tag ($MOMA_PRETRAIN_REGISTRY, $MOMA_PRETRAIN_DIR).

--device cuda (default) runs on the GPU and fails when there is none;
--device cpu runs everything on the CPU with the kernels' plain versions.

On N GPUs of one host, one process per GPU (NCCL; gloo with --device cpu):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m moma_tpu_torch.cli.train_student ... --batch_size <global batch>

Without torchrun's variables the run is one process with no group.
"""

from __future__ import annotations

import sys

from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.core.mesh import init_distributed, shutdown
from moma_tpu_torch.train.student import run_student


def main(argv=None):
    """Parse, train, print the summary line; returns (state, result)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    synthetic = "--synthetic" in argv
    if synthetic:
        argv.remove("--synthetic")
    cfg = parse_student_args(argv)
    grouped = init_distributed(cfg.run.device)
    try:
        state, result = run_student(cfg, synthetic=synthetic)
    finally:
        if grouped:
            shutdown()
    print(f"done: best val acc {result['best_acc']:.2f} "
          f"f1 {result['best_f1']:.4f} (trial {cfg.run.trial}) "
          f"run_dir {result['run_dir']}", flush=True)
    return state, result


if __name__ == "__main__":
    main()
