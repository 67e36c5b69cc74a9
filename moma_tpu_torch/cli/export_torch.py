"""Export the port's weights into a reference-loadable torch .pth.

Counterpart of moma_tpu/cli/export_torch.py: fill a torch state-dict
TEMPLATE (the reference model's own .state_dict(), saved to a .pth) with
this package's weights and write `{'model': state_dict, ...}`, the shape
the reference's load_pretrained_weights (helper/util.py:141-162) and
test.py unwrap.  The weights go through the same converter as in the JAX
package (models/torch_import.export_state_dict, the port's copy) from the
model's flax-layout view (models/pretrained._flax_view), so the file is
the JAX package's for the same weights, but for its `framework` entry.

Make a template on the reference side with:

    import torch
    from model_def import load_model            # reference repo
    m = load_model('effiB0', 'NULL', n_cls, True, None, False)
    torch.save(m.state_dict(), 'template.pth')

Then:

    python -m moma_tpu_torch.cli.export_torch --model effiB0 --n_cls 4 \\
        --run RUNDIR --ckpt_tag best_acc \\
        --template template.pth --out weights.pth
"""

from __future__ import annotations

import argparse
import os

import torch

from moma_tpu_torch.core.config import DATASET_NUM_CLASSES
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.pretrained import _flax_view, load_pretrained
from moma_tpu_torch.models.torch_import import (_torch_modules,
                                                export_state_dict,
                                                save_torch_checkpoint)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moma_tpu_torch export_torch")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--n_cls", type=int, default=0)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--run", type=str, default=None,
                   help="run dir containing ckpt/<tag>.pt; omit to export a "
                        "fresh init (smoke)")
    p.add_argument("--ckpt_tag", type=str, default="best_acc",
                   choices=["best_acc", "best_f1", "latest"])
    p.add_argument("--pretrain", type=str, default=None,
                   help="direct checkpoint path or preset tag instead of "
                        "--run (a .pt of this package or a torch .pth)")
    p.add_argument("--template", type=str, required=True,
                   help="torch .pth holding the REFERENCE model's "
                        ".state_dict() (key names and shapes; the module "
                        "docstring says how to make one)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--skip_classifier", action="store_true",
                   help="cross-task mode: leave the template's classifier "
                        "untouched (the reference's strict=False load)")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.run and a.pretrain:
        raise SystemExit("pass ONE of --run / --pretrain")
    n_cls = a.n_cls or DATASET_NUM_CLASSES.get(a.dataset, 100)
    model = create_model(a.model, n_cls,
                         generator=torch.Generator().manual_seed(0),
                         image_size=a.image_size)
    src = "fresh init"
    ckpt = a.pretrain or (os.path.join(a.run, "ckpt", a.ckpt_tag + ".pt")
                          if a.run else None)
    if ckpt:
        load_pretrained(model, ckpt, strict=True)
        src = ckpt

    obj = torch.load(a.template, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"],
                                                                dict):
        obj = obj["model"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    template = dict(obj)

    sd = export_state_dict(_flax_view(model), template,
                           skip_classifier=a.skip_classifier)
    kinds = {}
    for m in _torch_modules({k: (v.numpy() if hasattr(v, "numpy") else v)
                             for k, v in template.items()}):
        kinds[m["kind"]] = kinds.get(m["kind"], 0) + 1
    save_torch_checkpoint(a.out, sd, meta={"source": src,
                                           "framework": "moma_tpu_torch"})
    filled = {k: v for k, v in kinds.items()
              if k in ("conv", "bn", "linear", "ln")}
    print(f"exported {a.model} ({src}) -> {a.out} "
          f"({len(sd)} tensors; modules filled: {filled}"
          f"{'; classifier kept from template' if a.skip_classifier else ''})")


if __name__ == "__main__":
    main()
