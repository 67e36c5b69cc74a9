"""CLI: batch inference with an exported serving artifact.

Counterpart of moma_tpu/cli/serve.py: run an artifact of `export_model`
(`core/export.py`: no model zoo, no checkpoint code, just the artifact)
over a glob of images, or over N random images, and write a predictions
CSV with the JAX package's columns (name, pred, prob, top<k>).

    python -m moma_tpu_torch.cli.export_model --run ./save/teacher_x \\
        --model effiB0 --dataset prostate_hv --image_size 512 \\
        --bf16 --out ./serve/teacher_x
    python -m moma_tpu_torch.cli.serve --artifact ./serve/teacher_x \\
        --images './patches/*.jpg' --out preds.csv

The artifact serves on the device it was exported on (export_model's
--device, the card by default).  Decode: the port's native libjpeg pool
(data/native.decode_files), PIL (data/histo._decode_resize) for the rows
it could not decode; a background thread decodes batch i+1 while the
device runs batch i, into a pool of 2 buffers; every batch is padded to
--bs (its tail rows copies of the last image).  --data_parallel serves
each batch over every visible card of the artifact's device type
(ExportedClassifier.shard).  The TPU's --scoped_vmem_kib has nothing to
tune here, so argparse refuses it.
"""

from __future__ import annotations

import argparse
import csv
import glob
import queue
import sys
import threading
import time

import numpy as np
import torch


def _decode_batch(paths, size: int, out=None) -> np.ndarray:
    """(len(paths), size, size, 3) uint8: the native decoder, PIL for the
    rows it failed (or all of them where it is unavailable)."""
    from moma_tpu_torch.data.histo import _decode_resize
    from moma_tpu_torch.data.native import decode_files

    res = decode_files(paths, size, out=out)
    if res is None:
        return np.stack([_decode_resize(p, size) for p in paths])
    imgs, failed = res
    for i in np.nonzero(failed)[0]:   # non-JPEG / corrupt rows
        imgs[i] = _decode_resize(paths[i], size)
    return imgs


def _batch_stream(get, n: int, bs: int, size: int, file_mode: bool):
    """Yield (lo, hi, imgs) with the decode one batch ahead of the
    consumer; in file mode imgs comes from a pool of 2 buffers, so the
    consumer is done with batch i's array before it pulls batch i+2 (the
    serve loop is: it materializes each batch's logits)."""
    starts = list(range(0, n, bs))
    if len(starts) <= 1:
        for lo in starts:
            yield lo, min(lo + bs, n), get(lo, min(lo + bs, n), None)
        return
    free: "queue.Queue" = queue.Queue()
    for _ in range(2):
        free.put(np.empty((bs, size, size, 3), np.uint8) if file_mode
                 else None)
    done: "queue.Queue" = queue.Queue()

    def worker():
        try:
            for lo in starts:
                hi = min(lo + bs, n)
                buf = free.get()
                out = buf[: hi - lo] if buf is not None else None
                done.put((lo, hi, get(lo, hi, out), buf))
        except Exception as e:   # surface decode errors in the consumer
            done.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    for _ in starts:
        item = done.get()
        if isinstance(item, Exception):
            raise item
        lo, hi, imgs, buf = item
        yield lo, hi, imgs
        free.put(buf)   # the consumer is done with this array: recycle
    t.join()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moma_tpu_torch serve")
    p.add_argument("--artifact", required=True,
                   help="path from export_model (with or without .pt2)")
    p.add_argument("--images", type=str, default=None,
                   help="glob of image files to classify")
    p.add_argument("--synthetic", type=int, default=0,
                   help="classify N random images instead (no files)")
    p.add_argument("--bs", type=int, default=64,
                   help="serving batch size (every batch padded to it)")
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over every visible card "
                        "(ExportedClassifier.shard)")
    p.add_argument("--out", type=str, default="./preds.csv")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    from moma_tpu_torch.core.export import ExportedClassifier

    return run(ExportedClassifier(a.artifact), a)


def run(clf, a):
    """Serve the loaded artifact `clf` as the parsed flags `a` say (main's
    work after the load); returns {'n', 'img_per_s', 'out'}."""
    if a.data_parallel:
        clf.shard()
        print(f"[serve] data-parallel over "
              f"{torch.cuda.device_count() if clf.device.type == 'cuda' else 1}"
              f" {clf.device.type} device(s)")
    size = clf.meta.get("image_size")
    if size is None:
        print("artifact has no meta json (image_size unknown); re-export or "
              "pass images already sized", file=sys.stderr)
        return {}
    if a.synthetic:
        rs = np.random.RandomState(0)
        names = [f"synthetic_{i}" for i in range(a.synthetic)]
        pixels = rs.randint(0, 256, (a.synthetic, size, size, 3), np.uint8)

        def get(lo, hi, out):
            return pixels[lo:hi]
        file_mode = False
    elif a.images:
        names = sorted(glob.glob(a.images))
        if not names:
            print(f"no files match {a.images}", file=sys.stderr)
            return {}

        def get(lo, hi, out):
            return _decode_batch(names[lo:hi], size, out=out)
        file_mode = True
    else:
        raise SystemExit("need --images or --synthetic")

    n = len(names)
    rows, t0 = [], time.perf_counter()
    for lo, hi, imgs in _batch_stream(get, n, a.bs, size, file_mode):
        if hi - lo < a.bs:   # pad the ragged tail: one batch shape
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], a.bs - (hi - lo), axis=0)])
        probs = torch.softmax(clf(imgs), dim=-1).cpu().numpy()[: hi - lo]
        top = np.argsort(-probs, axis=-1)[:, : a.topk]
        for i, name in enumerate(names[lo:hi]):
            rows.append([name, int(top[i, 0]), f"{probs[i, top[i, 0]]:.4f}",
                         " ".join(str(int(c)) for c in top[i])])
    dt = time.perf_counter() - t0
    with open(a.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "pred", "prob", f"top{a.topk}"])
        w.writerows(rows)
    meta = {k: clf.meta.get(k) for k in ("model", "dataset", "quantized")}
    print(f"served {n} images @ {size}px with {meta} on {clf.device} -> "
          f"{a.out} ({n / dt:.1f} img/s incl. decode+host IO)")
    return {"n": n, "img_per_s": n / dt, "out": a.out}


if __name__ == "__main__":
    main()
