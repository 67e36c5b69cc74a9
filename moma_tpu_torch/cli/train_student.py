"""CLI: MoMA student training on PyTorch.

Counterpart of moma_tpu/cli/train_student.py for --distill moma (the only
method ported so far; other --distill values raise):

    python -m moma_tpu_torch.cli.train_student --distill moma \
        --dataset prostate_hv --model_s effiB0 --model_t effiB0 \
        -c 1 -d 1 -b 1 --feat_dim 512 --head mlp --attn self --mem MoCo \
        --nce_k 16384 --batch_size 64 --image_size 512 --synthetic \
        --save_dir ./save

The run writes `<save_dir>/moma_<run name>/`: `ckpt/{latest,best_acc,
best_f1}.pt` with their `.meta.json`, `stat.json`, `scalars.jsonl`,
`tb/events.out.tfevents.*` and `parameters.json`; the same command with
`--resume` continues from `ckpt/latest.pt`, also mid-epoch after SIGTERM.
--std_pre / --tec_pre take a path (a run's `ckpt/best_acc.pt`, a torch
state dict) or a preset tag ($MOMA_PRETRAIN_REGISTRY, $MOMA_PRETRAIN_DIR).

--device cuda (default) runs on the GPU and fails when there is none;
--device cpu runs everything on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import sys

from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.train.moma import run_moma


def main(argv=None):
    """Parse, train, print the summary line; returns (state, result)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    synthetic = "--synthetic" in argv
    if synthetic:
        argv.remove("--synthetic")
    cfg = parse_student_args(argv)
    state, result = run_moma(cfg, synthetic=synthetic)
    print(f"done: best val acc {result['best_acc']:.2f} "
          f"f1 {result['best_f1']:.4f} (trial {cfg.run.trial}) "
          f"run_dir {result['run_dir']}", flush=True)
    return state, result


if __name__ == "__main__":
    main()
