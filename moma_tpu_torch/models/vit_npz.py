"""ViT .npz checkpoint loading (augreg / big_vision layout) and the
position-embedding resize.

Counterpart of moma_tpu/models/vit_npz.py: `resize_pos_embed` (the grid
resized as `jax.image.resize(..., "bilinear")` does it, antialiased when
it shrinks; the cls token kept) and `load_vit_npz`, which fills the port's
VisionTransformer in place from the same npz names.  A library function,
as in the JAX package: no CLI flag reaches it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image's 'bilinear' (triangle kernel,
    antialias on) along one axis, translation 0 (jax/_src/image/scale.py
    compute_weight_mat)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_pos_embed(pos: np.ndarray, new_len: int) -> np.ndarray:
    """(1, 1+old_grid^2, D) -> (1, 1+new_grid^2, D), bilinear over the grid;
    the cls token kept."""
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    old = int(math.sqrt(grid.shape[1]))
    new = int(math.sqrt(new_len - 1))
    if old == new:
        return pos
    g = grid.reshape(old, old, -1).astype(np.float64)
    w = _resize_weights(old, new)
    g = np.einsum("hwd,hi,wj->ijd", g, w, w).astype(pos.dtype)
    return np.concatenate([cls_tok, g.reshape(1, new * new, -1)], axis=1)


def load_vit_npz(model, path: str):
    """Fill `model` (a moma_tpu_torch VisionTransformer) in place from an
    augreg-layout npz; the classifier only where the npz head has its
    shape.  Returns the model."""
    w = np.load(path)
    D = model.feat_dim
    pos_key = ("Transformer/posembed_input/pos_embedding"
               if "Transformer/posembed_input/pos_embedding" in w
               else "pos_embedding")
    new = {
        "patch_embed.weight": np.transpose(w["embedding/kernel"],
                                           (3, 2, 0, 1)),
        "patch_embed.bias": w["embedding/bias"],
        "cls_token": w["cls"],
        "pos_embed": resize_pos_embed(w[pos_key],
                                      model.pos_embed.shape[1]),
        "norm.weight": w["Transformer/encoder_norm/scale"],
        "norm.bias": w["Transformer/encoder_norm/bias"],
    }
    for i in range(len(model.blocks)):
        pre = f"Transformer/encoderblock_{i}"
        att = f"{pre}/MultiHeadDotProductAttention_1"
        blk = f"blocks.{i}"
        # augreg stores q / k / v as (D, H, hd): fused into one (3D, D) qkv
        new[f"{blk}.attn.qkv.weight"] = np.concatenate(
            [w[f"{att}/{n}/kernel"].reshape(D, D)
             for n in ("query", "key", "value")], axis=1).T
        new[f"{blk}.attn.qkv.bias"] = np.concatenate(
            [w[f"{att}/{n}/bias"].reshape(-1)
             for n in ("query", "key", "value")])
        new[f"{blk}.attn.proj.weight"] = w[f"{att}/out/kernel"].reshape(
            D, D).T
        new[f"{blk}.attn.proj.bias"] = w[f"{att}/out/bias"]
        for ours, theirs in (("norm1", "LayerNorm_0"),
                             ("norm2", "LayerNorm_2")):
            new[f"{blk}.{ours}.weight"] = w[f"{pre}/{theirs}/scale"]
            new[f"{blk}.{ours}.bias"] = w[f"{pre}/{theirs}/bias"]
        for ours, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            new[f"{blk}.{ours}.weight"] = w[
                f"{pre}/MlpBlock_3/{theirs}/kernel"].T
            new[f"{blk}.{ours}.bias"] = w[f"{pre}/MlpBlock_3/{theirs}/bias"]
    if ("head/kernel" in w
            and w["head/kernel"].T.shape == tuple(model.classifier.weight.shape)):
        new["classifier.weight"] = w["head/kernel"].T
        new["classifier.bias"] = w["head/bias"]
    own = model.state_dict()
    with torch.no_grad():
        for k, v in new.items():
            v = np.asarray(v)
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"npz tensor for {k} has shape {v.shape}, "
                                 f"the model's is {tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
    return model
