"""moma_tpu_torch RandAugment layer on the CPU against moma_tpu's kernel.

The port's `ra_layer_from_draws` takes its plain PyTorch version for CPU
tensors; moma_tpu's `ra_layer_from_draws` runs its Pallas kernel in
interpret mode.  Both get the same images and the same per-image draws
(op, magnitude, sign, gate, flip), made with numpy.  Tolerance: exact for
the LUT ops, flips, the gate and the identity op; atol 1 for enhance,
sharpness and the shear/translate warps (the JAX package's own kernel
tolerance, tests/test_pallas_randaugment.py:27-30) — each test prints its
count of differing pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.data import randaugment as JRA
from moma_tpu.ops import pallas_randaugment as JPR
from moma_tpu_torch.data import randaugment as RA
from moma_tpu_torch.ops import randaugment as RK

from torch_port_helpers import quick_jit

FILL = (124.0, 116.0, 104.0)
EXACT_OPS = (0, 1, 2, 4, 5, 6, RA.IDENTITY_OP)


def _draws(seed, B, op=None, prob=1.0, flip_p=0.5):
    rs = np.random.RandomState(seed)
    return {
        "op": (rs.randint(0, RA.N_OPS, B) if op is None
               else np.asarray(op)).astype(np.int32),
        "mag": np.clip(10.0 + 0.5 * rs.randn(B), 0, 10).astype(np.float32),
        "sign": rs.rand(B) < 0.5,
        "apply": rs.rand(B) < prob,
        "hflip": rs.rand(B) < flip_p,
    }


def _jax_layer(x, op, mag, sign, apply, hflip):
    return JPR.ra_layer_from_draws(x, op, mag, sign, apply, FILL,
                                   interpret=True, hflip=hflip)


def _both(x, d):
    # one program (eagerly, every op and kernel call compiles alone)
    want = quick_jit(_jax_layer)(
        jnp.asarray(x), jnp.asarray(d["op"]), jnp.asarray(d["mag"]),
        jnp.asarray(d["sign"]), jnp.asarray(d["apply"]),
        jnp.asarray(d["hflip"]))
    got = RK.ra_layer_from_draws(
        torch.from_numpy(x), torch.from_numpy(d["op"]).long(),
        torch.from_numpy(d["mag"]), torch.from_numpy(d["sign"]),
        torch.from_numpy(d["apply"]), FILL,
        hflip=torch.from_numpy(d["hflip"]))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_every_op_forced_matches_pallas_interpret(seed):
    """Sixteen images, one per op (the 15 ops and the identity), all gated
    on, with a flip mix."""
    B = RA.N_OPS + 1
    x = np.random.RandomState(100 + seed).randint(
        0, 256, (B, 3, 32, 32)).astype(np.float32)
    d = _draws(seed, B, op=np.arange(B), prob=1.0)
    got, want = _both(x, d)
    for b in range(B):
        diff = np.abs(got[b] - want[b])
        print(f"op {b:2d}: {int((diff > 0).sum())} differing pixels")
        if b in EXACT_OPS:
            np.testing.assert_array_equal(got[b], want[b], err_msg=f"op {b}")
        else:
            np.testing.assert_allclose(got[b], want[b], atol=1.0,
                                       err_msg=f"op {b}")


@pytest.mark.parametrize("prob,flip_p", [(0.0, 0.0), (0.0, 1.0), (0.5, 0.5)])
def test_gate_and_flip_mixes_match_pallas_interpret(prob, flip_p):
    B = 8
    x = np.random.RandomState(7).randint(0, 256, (B, 3, 32, 32)).astype(
        np.float32)
    d = _draws(11, B, prob=prob, flip_p=flip_p)
    got, want = _both(x, d)
    print(f"{int((got != want).sum())} differing pixels")
    gated_off = ~d["apply"]
    np.testing.assert_array_equal(got[gated_off], want[gated_off])
    np.testing.assert_allclose(got, want, atol=1.0)
    if prob == 0.0:  # copy / flip only, exactly
        ref = np.where(d["hflip"][:, None, None, None], x[..., ::-1], x)
        np.testing.assert_array_equal(got, ref)


def test_enhance_ops_at_main_path_size_match_pallas_interpret():
    """Color and Contrast on 512^2 images.  Contrast adds the image's mean
    luma: moma_tpu sums the luma in float32, which is inexact past 2^24
    (about 64 grey levels of mean at 512^2), while the port sums it exactly
    in integers.  The rounded mean can then differ by one level, which
    moves a pixel by at most |c_mean| <= 1 grey level: the atol-1 bound.
    (Color, which has no mean term, differs by 1 on pixels whose blend
    lands within float32 rounding of .5; the Contrast images here match
    exactly.)"""
    B, S = 3, 512
    rs = np.random.RandomState(3)
    x = rs.randint(0, 256, (B, 3, S, S)).astype(np.float32)
    x[2] = np.clip(x[2] + 120.0, 0.0, 255.0)        # a bright image
    assert (x.mean((1, 2, 3)) * S * S > 2 ** 24).all()
    d = {"op": np.array([7, 8, 8], np.int32),
         "mag": np.array([10.0, 10.0, 7.3], np.float32),
         "sign": np.array([True, True, False]),
         "apply": np.ones(B, bool),
         "hflip": np.array([False, False, True])}
    got, want = _both(x, d)
    print(f"{int((got != want).sum())} differing pixels")
    np.testing.assert_allclose(got, want, atol=1.0)


def test_layer_scalars_match_jax():
    B = 16
    d = _draws(3, B, op=np.arange(B), prob=0.5)
    want = JPR.layer_scalars(
        jnp.asarray(d["op"]), jnp.asarray(d["mag"]), jnp.asarray(d["sign"]),
        jnp.asarray(d["apply"]), 64, FILL, W=48,
        hflip=jnp.asarray(d["hflip"]))
    got = RK.layer_scalars(
        torch.from_numpy(d["op"]).long(), torch.from_numpy(d["mag"]),
        torch.from_numpy(d["sign"]), torch.from_numpy(d["apply"]), 64, FILL,
        W=48, hflip=torch.from_numpy(d["hflip"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rand_augment_matches_chained_kernel_layers():
    """rand_augment: f32 round on entry, bf16 carry, flip folded into layer
    1 — replayed on the JAX kernel with rand_augment's own draws."""
    B, S = 6, 32
    images = np.random.RandomState(5).randint(0, 256, (B, S, S, 3)).astype(
        np.float32) + 0.3
    got = RA.rand_augment(torch.from_numpy(images),
                          torch.Generator().manual_seed(21), hflip=True,
                          fill=FILL).numpy()
    g = torch.Generator().manual_seed(21)      # replay the same draws
    flips = (torch.rand(B, generator=g) < 0.5).numpy()
    x = jnp.round(jnp.transpose(jnp.asarray(images), (0, 3, 1, 2)))
    x = x.astype(jnp.bfloat16)
    for i in range(2):
        d = RA.draw_layer(B, g, 10.0, 0.5)
        layer = quick_jit(lambda x, op, mag, sign, apply, *flip:
                          JPR.ra_layer_from_draws(
                              x, op, mag, sign, apply, FILL, interpret=True,
                              out_dtype=jnp.bfloat16,
                              hflip=flip[0] if flip else None))
        x = layer(x, *(jnp.asarray(d[k].numpy()) for k in
                       ("op", "mag", "sign", "apply")),
                  *((jnp.asarray(flips),) if i == 0 else ()))
    want = np.asarray(jnp.transpose(x.astype(jnp.float32), (0, 2, 3, 1)))
    assert got.shape == (B, S, S, 3) and got.dtype == np.float32
    print(f"{int((got != want).sum())} differing pixels")
    np.testing.assert_allclose(got, want, atol=1.0)


@pytest.mark.parametrize("cfg", ["rand-n2-m10-mstd0.5", "rand-m9-n3",
                                 "rand-n2-m10-mstd0.5-w0", "rand-x-n1"])
def test_parse_ra_config_matches_jax(cfg):
    assert RA.parse_ra_config(cfg) == JRA.parse_ra_config(cfg)
    assert RA.CMC_OP_IDS == JRA.CMC_OP_IDS
    assert RA.OP_NAMES == JRA.OP_NAMES
