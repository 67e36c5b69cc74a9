"""Attention-map extraction from trained MoMA checkpoints.

Counterpart of moma_tpu/moma/viz.py: `dump_attention_maps` rebuilds the
student, the teacher and the CMO heads of a run from its parameters.json
and a checkpoint of this package (`<run>/ckpt/<tag>.pt`), runs one batch
of eval-mode embeds and writes every plain-attention module's (H, N, N)
map to an .npz under the JAX package's keys: `labels` and `<module>_map`
(atts_q over the student's embeds, atts_k over embed_t of the teacher's
features, atts_queue over the first `n_queue` saved queue rows; the dual,
qk and all modes take the student's embeds, atts_n the teacher's).
Cross-arch runs work the same way: their heads hold embed_ema too.

Entry: wired as `cli/test_eval --dump_attn`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _load_run_config(run_dir: str) -> Optional[dict]:
    pj = os.path.join(run_dir, "parameters.json")
    if not os.path.exists(pj):
        return None
    with open(pj) as f:
        payload = json.load(f)
    cfg = payload.get("config", payload)
    if isinstance(cfg, str):   # StatsWriter stores cfg.to_json(), a string
        cfg = json.loads(cfg)
    return cfg


@torch.no_grad()
def dump_attention_maps(ckpt_path: str, run_dir: str, images: torch.Tensor,
                        labels, out_path: str,
                        n_queue: int = 256) -> Optional[dict]:
    """Write an .npz of the CMO attention maps for one batch.

    images: NORMALIZED (B, H, W, 3) float32 batch on the device to run on;
    labels: (B,) ints.  Returns {module: map shape}, or None when the run
    has no map to show (no parameters.json, attn 'none' or an Attention2
    mode, or a checkpoint that is no MoMA full state)."""
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.moma.cmo import ATTN2_MODES, ATTN_SETS, CMOHeads

    cfg = _load_run_config(run_dir)
    if cfg is None:
        print(f"[dump_attn] skip {run_dir}: no parameters.json")
        return None
    moma = cfg.get("moma", {})
    attn = moma.get("attn", "self")
    if attn not in ATTN_SETS or not ATTN_SETS[attn] or attn in ATTN2_MODES:
        print(f"[dump_attn] skip {run_dir}: attn={attn!r} exposes no maps")
        return None
    saved = torch.load(ckpt_path, map_location=images.device,
                       weights_only=True)
    if not isinstance(saved, dict) or "heads" not in saved:
        print(f"[dump_attn] skip {run_dir}: not a MoMA full-state checkpoint")
        return None

    n_cls = int(cfg["model_s"]["n_cls"])
    nets = []
    for which in ("model_s", "model_t"):
        net = create_model(cfg[which]["name"], n_cls,
                           image_size=images.shape[1])
        net.load_state_dict(saved["student" if which == "model_s"
                                  else "teacher"])
        nets.append(net.to(images.device,
                           memory_format=torch.channels_last).eval())
    student, teacher = nets
    heads_sd = saved["heads"]
    # feat_dim from the checkpoint itself (any attention module's qkv
    # in-dim), parameters.json's only where the checkpoint has none
    qkv = [v for k, v in heads_sd.items()
           if k.startswith("attn.") and k.endswith("qkv.weight")]
    feat_dim = int(qkv[0].shape[1]) if qkv else int(moma["feat_dim"])
    heads = CMOHeads(moma.get("head", "mlp"), attn, feat_dim,
                     s_dim=student.feat_dim, t_dim=teacher.feat_dim,
                     include_ema=any(k.startswith("embed_ema.")
                                     for k in heads_sd))
    heads.load_state_dict(heads_sd)
    heads = heads.to(images.device).eval()

    q_in = heads.embed_s(student(images)[0][-1])
    k_in = heads.embed_t(teacher(images)[0][-1])
    inputs = {"atts_q": q_in, "atts_k": k_in, "atts": q_in, "atts_p": q_in,
              "atts_n": k_in}
    memory = saved.get("queue", {}).get("memory", {})
    if "memory" in memory:
        inputs["atts_queue"] = memory["memory"][:n_queue].to(images.device)
    maps = heads.attn_maps(inputs)
    payload: Dict[str, np.ndarray] = {"labels": np.asarray(labels)}
    shapes = {}
    for name, (_, amap) in maps.items():
        payload[f"{name}_map"] = amap.float().cpu().numpy()
        shapes[name] = tuple(payload[f"{name}_map"].shape)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, **payload)
    print(f"[dump_attn] {out_path}: "
          + ", ".join(f"{k} {v}" for k, v in shapes.items()))
    return shapes
