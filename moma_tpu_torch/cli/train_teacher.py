"""CLI: supervised teacher training on PyTorch.

Counterpart of moma_tpu/cli/train_teacher.py, with the flags of
scripts/run_vanilla.sh:

    python -m moma_tpu_torch.cli.train_teacher --dataset prostate_hv \
        --model effiB0 --batch_size 64 --image_size 512 --epochs 50 \
        --learning_rate 0.05 --cosine --weight_decay 1e-4 --synthetic

The run writes `<save_dir>/teacher_<run name>/`: `ckpt/{latest,best_acc,
best_f1}.pt` with their `.meta.json`, `stat.json`, `scalars.jsonl`,
`tb/events.out.tfevents.*` and `parameters.json`.  `--path_t` /
`--tec_pre` of train_student take its `ckpt/best_acc.pt`.

--device cuda (default) runs on the GPU and fails when there is none;
--device cpu runs everything on the CPU with the kernels' plain versions.

On N GPUs of one host, one process per GPU (NCCL; gloo with --device cpu):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m moma_tpu_torch.cli.train_teacher ... --batch_size <global batch>

Without torchrun's variables the run is one process with no group.
"""

from __future__ import annotations

import sys

from moma_tpu_torch.core.config import parse_teacher_args
from moma_tpu_torch.core.mesh import init_distributed, shutdown
from moma_tpu_torch.train.teacher import run_teacher


def main(argv=None):
    """Parse, train, print the summary line; returns (state, result)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    synthetic = "--synthetic" in argv
    if synthetic:
        argv.remove("--synthetic")
    cfg = parse_teacher_args(argv)
    grouped = init_distributed(cfg.run.device)
    try:
        state, result = run_teacher(cfg, synthetic=synthetic)
    finally:
        if grouped:
            shutdown()
    print(f"done: best val acc {result['best_acc']:.2f} "
          f"f1 {result['best_f1']:.4f} (trial {cfg.run.trial}) "
          f"run_dir {result['run_dir']}", flush=True)
    return state, result


if __name__ == "__main__":
    main()
