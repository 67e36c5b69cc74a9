"""moma_tpu_torch's CUDA kernels against their plain PyTorch versions.

Needs a CUDA device and nvcc (the kernels build at first use); every test
skips without a card.  This file imports no JAX, so on a machine without
it run it past tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Edge shapes the main path does not reach (odd channel counts, few rows,
non-square images) and the wrappers' refusals are covered here; the
main-path shapes are held by chip_smoke.py.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True


def _shifted(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# channel_sums and grad_channel_sums load 16 bytes a thread where C and the
# base pointers allow it, else 4-byte (2 bf16 or 1 f32 channels) or, for
# bf16 of odd C, 2-byte loads: odd C (7, 33, 97), many rows at a
# vector-width C (2,64,64,96), C = 1280 with few rows (3 and 2*4*4), every
# effiB0 BatchNorm width (16 .. 1280) over 4551 rows, and views off 16-byte
# alignment
_EFFIB0_BN_WIDTHS = (16, 24, 32, 40, 80, 96, 112, 144, 192, 240, 320, 480,
                     672, 1152, 1280)


@pytest.mark.parametrize("shape", [(4, 8, 8, 24), (2, 5, 3, 7), (3, 1000),
                                   (2, 4, 4, 1280), (1, 1, 1, 33),
                                   (2, 64, 64, 96), (3, 1280), (5, 9, 7, 40),
                                   (4, 33, 31, 97)]
                         + [(3, 37, 41, C) for C in _EFFIB0_BN_WIDTHS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_bn_sums_match_plain(dev, shape, dtype, aligned):
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    if not aligned:
        x, dy = _shifted(x), _shifted(dy)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    mean = x.float().reshape(-1, shape[-1]).mean(0)
    for got, want in ((FB.channel_sums(x), FB.channel_sums_plain(x)),
                      (FB.grad_channel_sums(dy, x, mean),
                       FB.grad_channel_sums_plain(dy, x, mean))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_channel_sums_repeats_bit_for_bit(dev, dtype):
    """Per-block partials and a fixed-order second pass, no atomics: two
    launches on the same inputs give the same bits."""
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(10)
    x = (torch.randn(4, 64, 64, 96, generator=g, device=dev) + 0.5).to(dtype)
    dy = torch.randn(4, 64, 64, 96, generator=g, device=dev).to(dtype)
    mean = x.float().mean((0, 1, 2))
    a = FB.grad_channel_sums(dy, x, mean)
    b = FB.grad_channel_sums(dy, x, mean)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(4, 64, 64, 96), (8, 64, 64, 16),
                                   (4, 9, 9, 1280), (2, 33, 31, 97)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_sums_repeats_bit_for_bit(dev, shape, dtype):
    """Per-block partials, a fixed tree inside a block and a fixed-order
    second pass, no atomics: two launches on the same inputs give the same
    bits."""
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(12)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    a = FB.channel_sums(x)
    b = FB.channel_sums(x)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bn_wrappers_refuse_what_the_kernel_does_not_take(dev):
    from moma_tpu_torch.ops import fused_bn as FB

    x = torch.randn(2, 8, 4, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        FB.channel_sums(x.permute(0, 2, 3, 1))
    with pytest.raises(TypeError):
        FB.channel_sums(x.half())
    with pytest.raises(TypeError):
        FB.grad_channel_sums(x.bfloat16(), x, torch.zeros(4, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_batchnorm_cuda_matches_cpu(dev, dtype):
    from moma_tpu_torch.ops.fused_bn import FusedBatchNorm

    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 24, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(4, 24, 8, 8, generator=g)
    out = {}
    for d in ("cpu", dev):
        bn = FusedBatchNorm(24, eps=1e-3, dtype=dtype).to(d)
        xi = x.to(d, dtype).detach().requires_grad_(True)
        y = bn(xi)
        (y.float() * w.to(d)).sum().backward()
        out[str(d)] = [t.detach().float().cpu() for t in
                       (y, xi.grad, bn.weight.grad, bn.bias.grad,
                        bn.running_mean, bn.running_var)]
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, rtol=tol, atol=tol)


# the RandAugment kernel against its plain version: no pixel may differ
# (atol 1.0 is the ceiling chip_smoke.py holds; the count of differing
# pixels must be 0).  Every op (and the identity) at square and non-square
# sizes, Rotate and the other warps at H != W, a width of 8k + 3 (runs of 8
# pixels with a ragged end, rows off 16 bytes), 7x5 (no whole run)
def _ra_scalars(dev, op, H, W, g, apply_p=0.8, mag=None):
    from moma_tpu_torch.data import randaugment as RA
    from moma_tpu_torch.ops import randaugment as RK

    B = op.shape[0]
    d = RA.draw_layer(B, g, 10.0, 0.5)
    apply = torch.rand(B, generator=g) < apply_p
    flip = torch.rand(B, generator=g) < 0.5
    return RK.layer_scalars(op, d["mag"] if mag is None else mag, d["sign"],
                            apply, H, (124.0, 116.0, 104.0), W=W,
                            hflip=flip).to(dev)


def _ra_same(x, scal):
    from moma_tpu_torch.ops import randaugment as RK

    got = RK.ra_layer(x, scal)
    want = RK.ra_layer_plain(x, scal)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1.0)
    assert int((got.float() != want.float()).sum()) == 0


@pytest.mark.parametrize("hw", [(32, 32), (24, 40), (40, 24), (7, 5),
                                (16, 43), (64, 64)])
@pytest.mark.parametrize("B", [2 * 16, 1])
def test_ra_layer_matches_plain(dev, hw, B):
    from moma_tpu_torch.data import randaugment as RA

    H, W = hw
    g = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        # B = 1 walks the 16 ops one launch each
        for first in range(0, RA.N_OPS + 1, B):
            op = (torch.arange(B) + first) % (RA.N_OPS + 1)
            scal = _ra_scalars(dev, op, H, W, g)
            x = torch.randint(0, 256, (B, 3, H, W), generator=g).to(dev,
                                                                   dtype)
            _ra_same(x, scal)


@pytest.mark.parametrize("op", range(16))
def test_ra_layer_every_op_at_magnitudes_0_and_10(dev, op):
    """Each op gated on at 64^2, magnitudes 0 and 10, both signs, flip on
    and off."""
    H = W = 64
    g = torch.Generator().manual_seed(3 + op)
    mag = torch.tensor([0.0, 0.0, 10.0, 10.0])
    scal = _ra_scalars(dev, torch.full((4,), op), H, W, g, apply_p=1.0,
                       mag=mag)
    scal[:, 19] = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randint(0, 256, (4, 3, H, W), generator=g).to(dev, dtype)
        _ra_same(x, scal)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw", [(32, 32), (16, 43)])
def test_ra_layer_gate_off_copies_or_flips(dev, flip, hw):
    from moma_tpu_torch.ops import randaugment as RK

    H, W = hw
    g = torch.Generator().manual_seed(4)
    scal = _ra_scalars(dev, torch.arange(16), H, W, g, apply_p=0.0)
    scal[:, 19] = float(flip)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand(16, 3, H, W, generator=g) * 255).to(dev, dtype)
        _ra_same(x, scal)
        got = RK.ra_layer(x, scal)
        torch.testing.assert_close(got, x.flip(3) if flip else x, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("hw", [(24, 40), (40, 24), (16, 43)])
def test_ra_layer_matches_plain_on_mixed_vectors(dev, hw):
    """Scalar vectors no single draw gives: the op, enhance, sharpness and
    pass columns each taken from another image, so LUT ops meet the
    contrast mean, sharpness meets the warps."""
    H, W = hw
    g = torch.Generator().manual_seed(8)
    B = 48
    scal = _ra_scalars(dev, torch.arange(B) % 16, H, W, g, apply_p=1.0)
    mixed = scal.clone()
    for cols in ([0, 1, 2], [3], [4, 5, 6, 7, 8, 9, 10], [15, 16, 17, 18]):
        mixed[:, cols] = scal[torch.randperm(B, generator=g).to(dev)][:, cols]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randint(0, 256, (B, 3, H, W), generator=g).to(dev, dtype)
        _ra_same(x, mixed)


def test_ra_layer_from_cpu_draws_matches_cpu(dev):
    """The training path's entry: draws on the host, images on the card."""
    from moma_tpu_torch.data import randaugment as RA
    from moma_tpu_torch.ops import randaugment as RK

    B, H, W = 32, 48, 40
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (B, 3, H, W), generator=g).to(torch.bfloat16)
    d = RA.draw_layer(B, g, 10.0, 0.5, prob=0.8)
    flip = torch.rand(B, generator=g) < 0.5
    args = (d["op"], d["mag"], d["sign"], d["apply"], (124.0, 116.0, 104.0))
    want = RK.ra_layer_from_draws(x, *args, out_dtype=torch.bfloat16,
                                  hflip=flip)
    got = RK.ra_layer_from_draws(x.to(dev), *args, out_dtype=torch.bfloat16,
                                 hflip=flip)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_ra_layer_launches_at_most_two_kernels(dev):
    from moma_tpu_torch.ops import randaugment as RK
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(6)
    scal = _ra_scalars(dev, torch.arange(16), 32, 32, g)
    x = torch.randint(0, 256, (16, 3, 32, 32), generator=g).to(dev,
                                                               torch.float32)
    RK.ra_layer(x, scal)
    reset_launch_counts()
    RK.ra_layer(x, scal)
    counts = launch_counts()
    assert counts["ra_layer"] == 1 and 1 <= counts["ra_layer_kernels"] <= 2


def test_ra_layer_makes_no_float32_scratch_image(dev):
    """Peak memory of one call: the output and the statistics scratch, no
    image-sized scratch (each allocation rounds up to 512 bytes)."""
    from moma_tpu_torch.ops import randaugment as RK

    B, H, W = 16, 128, 128
    g = torch.Generator().manual_seed(7)
    scal = _ra_scalars(dev, torch.arange(B), H, W, g)
    x = torch.randint(0, 256, (B, 3, H, W), generator=g).to(dev,
                                                           torch.bfloat16)
    RK.ra_layer(x, scal)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = RK.ra_layer(x, scal)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before

    def rounded(n):
        return -(-n // 512) * 512

    assert peak <= rounded(out.numel() * out.element_size()) + rounded(
        RK.scratch_bytes(B))


def test_ra_layer_refuses_bad_layout(dev):
    from moma_tpu_torch.ops import randaugment as RK

    x = torch.zeros(2, 3, 8, 8, device=dev)
    scal = torch.zeros(2, RK.N_SCALARS, device=dev)
    with pytest.raises(ValueError):
        RK.ra_layer(x.permute(0, 1, 3, 2), scal)
    with pytest.raises(TypeError):
        RK.ra_layer(x, scal, out_dtype=torch.bfloat16)


def _flash_inputs(dev, H, Nq, Nk, d, dtype, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    scale = d ** -0.5
    qs = (rn(H, Nq, d) * scale).to(dtype)
    return (qs, rn(H, Nk, d).to(dtype), rn(H, Nk, d).to(dtype),
            rn(H, Nq, d).to(dtype))


# f32: the kernel and the plain version differ only in the order of their
# float32 sums; bf16: p and ds are rounded to bf16 in both, so one ulp of
# bf16 in a few of them is the difference
_FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


# (H, Nq, Nk, d): Nq and Nk that cut the 128-row and the 32- / 64-key tiles
# raggedly, Nq != Nk, and head dims whose rows are no multiple of 16 bytes
# (d = 41: 4-byte copies in f32, plain loads in bf16; d = 36: 4-byte copies
# in bf16)
@pytest.mark.parametrize("shape", [(4, 64, 64, 16), (2, 100, 100, 8),
                                   (4, 300, 300, 32), (1, 70, 257, 128),
                                   (2, 513, 200, 40), (2, 200, 333, 41),
                                   (3, 129, 97, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(dev, shape, dtype):
    from moma_tpu_torch.ops import flash_attention as FA

    H, Nq, Nk, d = shape
    qs, k, v, do = _flash_inputs(dev, H, Nq, Nk, d, dtype)
    o, m, l = FA.flash_fwd(qs, k, v)
    o_p, m_p, l_p = FA._forward_stats(qs, k, v, chunk=96)
    torch.cuda.synchronize()
    tol = _FLASH_TOL[dtype]

    def close(got, want, what):
        err = float((got.float() - want.float()).abs().max())
        ref = float(want.float().abs().max())
        assert err <= tol * max(ref, 1e-3), (what, err, ref)

    close(o, o_p, "o")
    close(m, m_p, "m")
    close(l, l_p, "l")
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    close(FA.flash_dq(qs, k, v, do, m_p, l_p, delta),
          FA.flash_dq_plain(qs, k, v, do, m_p, l_p, delta, chunk=96), "dq")
    dk, dv = FA.flash_dkv(qs, k, v, do, m_p, l_p, delta)
    dk_p, dv_p = FA.flash_dkv_plain(qs, k, v, do, m_p, l_p, delta, chunk=96)
    torch.cuda.synchronize()
    close(dk, dk_p, "dk")
    close(dv, dv_p, "dv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_repeat_bit_for_bit(dev, dtype):
    """One owner per output element and no atomics: two launches on the
    same inputs give the same bits."""
    from moma_tpu_torch.ops import flash_attention as FA

    qs, k, v, do = _flash_inputs(dev, 2, 300, 260, 64, dtype, seed=8)
    runs = []
    for _ in range(2):
        o, m, l = FA.flash_fwd(qs, k, v)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        dq = FA.flash_dq(qs, k, v, do, m, l, delta)
        runs.append((o, m, l, dq) + FA.flash_dkv(qs, k, v, do, m, l, delta))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_kernels_take_rows_off_16_byte_alignment(dev):
    """Contiguous views that start 4 bytes past an aligned address take the
    4-byte copies and give what aligned copies of the same values give."""
    from moma_tpu_torch.ops import flash_attention as FA

    qs, k, v, do = _flash_inputs(dev, 2, 150, 90, 128, torch.float32, seed=9)
    q2, k2, v2, do2 = (_shifted(t) for t in (qs, k, v, do))
    assert q2.data_ptr() % 16 != 0 and q2.is_contiguous()
    o, m, l = FA.flash_fwd(qs, k, v)
    o2, m2, l2 = FA.flash_fwd(q2, k2, v2)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dq = FA.flash_dq(qs, k, v, do, m, l, delta)
    dq2 = FA.flash_dq(q2, k2, v2, do2, m, l, delta)
    dk, dv = FA.flash_dkv(qs, k, v, do, m, l, delta)
    dk2, dv2 = FA.flash_dkv(q2, k2, v2, do2, m, l, delta)
    torch.cuda.synchronize()
    for a, b in ((o, o2), (m, m2), (l, l2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


def test_streaming_attention_cuda_matches_cpu(dev):
    from moma_tpu_torch.ops import flash_attention as FA
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(4)
    q, k, v, w = (torch.randn(4, 200, 32, generator=g) for _ in range(4))
    out = {}
    reset_launch_counts()
    for d in ("cpu", dev):
        leaves = [t.clone().to(d).requires_grad_(True) for t in (q, k, v)]
        o = FA.streaming_attention(*leaves, 32 ** -0.5)
        (o * w.to(d)).sum().backward()
        out[str(d)] = [o.detach().cpu()] + [t.grad.cpu() for t in leaves]
    assert launch_counts() == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from moma_tpu_torch.ops import flash_attention as FA

    x = torch.randn(2, 16, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_fwd(x.transpose(0, 1), x, x)
    with pytest.raises(TypeError):
        FA.flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        FA.flash_fwd(x, x.bfloat16(), x)
    big = torch.randn(1, 8, 160, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd(big, big, big)
    with pytest.raises(ValueError):
        FA.flash_fwd(x, x.cpu(), x)


# (C, expand, k, stride, Cout, N, H, W): the five effiB0 block classes at
# ragged sizes (pixel counts, channel counts and output tiles that do not
# divide the kernels' tiles), plus one wider than a reduction chunk; then
# each of effiB0's 12 distinct (C, E, k, stride, Cout) at its full channel
# widths on a small image (E from 32 to 1152, Cout 320 spanning several
# column tiles); then rows whose bytes are no multiple of 16 (C = 12 in
# bf16 takes 4-byte copies; C = 41, odd, plain loads in bf16 and 4-byte
# copies in f32) and Cout 320 behind them
_FE_CASES = [(32, 1, 3, 1, 16, 2, 12, 16), (16, 6, 3, 2, 24, 3, 13, 11),
             (24, 6, 3, 1, 24, 2, 9, 20), (24, 6, 5, 2, 40, 2, 16, 14),
             (40, 6, 5, 1, 40, 1, 7, 5), (80, 6, 5, 2, 112, 2, 5, 6),
             (8, 6, 3, 1, 8, 5, 33, 35)]
_FE_CASES += [(C, x, k, s, Co, 2, 10, 9) for C, x, k, s, Co in (
    (32, 1, 3, 1, 16), (16, 6, 3, 2, 24), (24, 6, 3, 1, 24),
    (24, 6, 5, 2, 40), (40, 6, 5, 1, 40), (40, 6, 3, 2, 80),
    (80, 6, 3, 1, 80), (80, 6, 5, 1, 112), (112, 6, 5, 1, 112),
    (112, 6, 5, 2, 192), (192, 6, 5, 1, 192), (192, 6, 3, 1, 320))]
_FE_CASES += [(12, 6, 3, 1, 320, 1, 5, 6), (41, 1, 5, 2, 8, 1, 7, 9),
              (41, 6, 3, 1, 20, 2, 7, 9)]
# odd C and odd E (21, 165, 315: K1's last column tile part empty) over
# pixel counts that are no multiple of K1's 128-pixel tile, and block 1's
# widths over enough pixels (126500) that each K1 block walks several tiles
_FE_CASES += [(7, 3, 3, 1, 12, 2, 9, 7), (33, 5, 5, 2, 24, 3, 15, 13),
              (45, 7, 3, 1, 16, 1, 31, 29), (16, 6, 3, 2, 24, 2, 250, 253)]


def _fe_inputs(dev, case, dtype, seed=5):
    """y, w_exp, ab1 (both None without expand conv), w_dw, ab2, se,
    w_proj for a _FE_CASES entry."""
    C, expand, k, stride, Cout, N, H, W = case
    E = C * expand
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    y = rn(N, C, H, W).to(dtype).contiguous(memory_format=torch.channels_last)
    w_exp = ab1 = None
    if expand != 1:
        w_exp = rn(E, C, scale=C ** -0.5).to(dtype)
        ab1 = torch.stack([1.0 + 0.1 * rn(E), 0.1 * rn(E)])
    w_dw = rn(E, k, k, scale=1.0 / k)
    ab2 = torch.stack([1.0 + 0.1 * rn(E), 0.1 * rn(E)])
    se = torch.sigmoid(rn(N, E))
    w_proj = rn(Cout, E, scale=E ** -0.5).to(dtype)
    return y, w_exp, ab1, w_dw, ab2, se, w_proj


def _shifted_map(t):
    """A channels_last copy of the (N, C, H, W) map t whose data starts one
    element past a 16-byte aligned address."""
    return _shifted(t.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", _FE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_effnet_kernels_match_plain(dev, case, dtype):
    """K1 / K2 / K4 against their plain versions.  f32: the two differ in
    the order of their float32 sums.  bf16: a sum that lands on the other
    side of a rounding edge moves an element by one bf16 ulp, and one such
    input can move a depthwise output by another."""
    from moma_tpu_torch.ops import fused_effnet as FE
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    C, expand, k, stride, Cout, N, H, W = case
    y, w_exp, ab1, w_dw, ab2, se, w_proj = _fe_inputs(dev, case, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7

    def close(got, want, what, rtol=tol):
        err = float((got.float() - want.float()).abs().max())
        ref = float(want.float().abs().max())
        assert err <= rtol * ref + 1e-6, (what, err, ref)

    def sums_close(got, want, x, what):
        # the bound of an f32 sum's error is a share of sum|x| (of sum x^2)
        xf = x.float()
        for gt, wt, bound in zip(got, want, (xf.abs().sum((0, 2, 3)),
                                             (xf * xf).sum((0, 2, 3)))):
            rel = float(((gt - wt).abs() / (bound + 1e-3)).max())
            assert rel <= (1e-4 if dtype == torch.float32 else 1e-2), (
                what, rel)

    reset_launch_counts()
    if expand != 1:
        got = FE.k1_expand_stats(y, w_exp)
        sums_close(got, FE.k1_expand_stats_plain(y, w_exp),
                   FE._pw(y, w_exp), "k1")
    dw, s2, q2 = FE.k2_depthwise(y, w_exp, ab1, w_dw, stride)
    dw_p, s2_p, q2_p = FE.k2_depthwise_plain(y, w_exp, ab1, w_dw, stride)
    torch.cuda.synchronize()
    assert dw.shape == dw_p.shape and dw.dtype == dtype
    assert dw.is_contiguous(memory_format=torch.channels_last)
    close(dw, dw_p, "dwout")
    sums_close((s2, q2), (s2_p, q2_p), dw_p, "k2 sums")
    tmp, s3, q3 = FE.k4_project(dw_p, ab2, se, w_proj)
    tmp_p, s3_p, q3_p = FE.k4_project_plain(dw_p, ab2, se, w_proj)
    torch.cuda.synchronize()
    assert tmp.shape == (N, Cout) + tuple(dw.shape[2:])
    close(tmp, tmp_p, "tmp")
    sums_close((s3, q3), (s3_p, q3_p), tmp_p, "k4 sums")
    assert launch_counts() == {
        "k2_depthwise": 1, "k4_project": 1,
        **({"k1_expand_stats": 1} if expand != 1 else {})}


@pytest.mark.parametrize("case", [(16, 6, 3, 2, 24, 2, 9, 10),
                                  (32, 1, 5, 1, 40, 2, 11, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_effnet_kernels_take_rows_off_16_byte_alignment(dev, case,
                                                              dtype):
    """K1, K2 and K4 read y, W_exp, dwout and W_proj from base pointers one
    element past 16-byte alignment (4-byte copies in f32, plain loads in
    bf16) and agree with the plain versions as the aligned cases do."""
    from moma_tpu_torch.ops import fused_effnet as FE

    y, w_exp, ab1, w_dw, ab2, se, w_proj = _fe_inputs(dev, case, dtype, 9)
    dw_p, s2_p, q2_p = FE.k2_depthwise_plain(y, w_exp, ab1, w_dw, case[3])
    tmp_p, s3_p, q3_p = FE.k4_project_plain(dw_p, ab2, se, w_proj)
    ys, dws = _shifted_map(y), _shifted_map(dw_p)
    assert ys.data_ptr() % 16 and dws.data_ptr() % 16
    sums = []
    if w_exp is not None:
        sums.append((FE.k1_expand_stats(ys, _shifted(w_exp)),
                     FE.k1_expand_stats_plain(y, w_exp), FE._pw(y, w_exp)))
    dw, s2, q2 = FE.k2_depthwise(
        ys, None if w_exp is None else _shifted(w_exp), ab1, w_dw, case[3])
    tmp, s3, q3 = FE.k4_project(dws, ab2, se, _shifted(w_proj))
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for got, want in ((dw, dw_p), (tmp, tmp_p)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()) + 1e-6
    for got, want, x in sums + [((s2, q2), (s2_p, q2_p), dw_p),
                                ((s3, q3), (s3_p, q3_p), tmp_p)]:
        xf = x.float()
        for gt, wt, bound in zip(got, want, (xf.abs().sum((0, 2, 3)),
                                             (xf * xf).sum((0, 2, 3)))):
            rel = float(((gt - wt).abs() / (bound + 1e-3)).max())
            assert rel <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_effnet_kernels_repeat_bit_for_bit(dev, dtype):
    """Per-block partials and a fixed-order second pass, no atomics: two
    launches of K1, of K2 and of K4 on the same inputs give the same
    bits."""
    from moma_tpu_torch.ops import fused_effnet as FE

    case = (40, 6, 5, 1, 40, 4, 33, 30)
    y, w_exp, ab1, w_dw, ab2, se, w_proj = _fe_inputs(dev, case, dtype, 11)
    a = FE.k2_depthwise(y, w_exp, ab1, w_dw, 1)
    b = FE.k2_depthwise(y, w_exp, ab1, w_dw, 1)
    c = FE.k4_project(a[0], ab2, se, w_proj)
    d = FE.k4_project(a[0], ab2, se, w_proj)
    e = FE.k1_expand_stats(y, w_exp)
    f = FE.k1_expand_stats(y, w_exp)
    torch.cuda.synchronize()
    for u, v in zip(a + c + e, b + d + f):
        assert torch.equal(u, v)


@pytest.mark.parametrize("train", [False, True])
def test_fused_forward_cuda_matches_cpu(dev, train):
    from moma_tpu_torch.models.efficientnet import EfficientNet
    from moma_tpu_torch.ops import fused_effnet as FE

    model = EfficientNet("b0", num_classes=5,
                         generator=torch.Generator().manual_seed(6))
    model = model.to(memory_format=torch.channels_last)
    x = torch.randn(3, 64, 48, 3, generator=torch.Generator().manual_seed(7))
    out = {}
    for d in ("cpu", dev):
        m = model.to(d)
        params, specs = FE.extract_params(m)
        out[str(d)] = FE.fused_forward(params, specs, x.to(d), train,
                                       torch.float32)
    (pc, lc, cc), (pg, lg, cg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(pg.cpu(), pc, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-4)
    assert len(cc) == len(cg) == (49 if train else 0)
    for (mc, vc), (mg, vg) in zip(cc, cg):
        torch.testing.assert_close(mg.cpu(), mc, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(vg.cpu(), vc, rtol=1e-3, atol=1e-4)


def test_fused_effnet_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from moma_tpu_torch.ops import fused_effnet as FE

    y = torch.randn(2, 8, 6, 6, device=dev)
    w = torch.randn(48, 8, device=dev)
    yc = y.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        FE.k1_expand_stats(y, w)
    with pytest.raises(TypeError):
        FE.k1_expand_stats(yc.half(), w.half())
    with pytest.raises(ValueError, match="w_exp"):
        FE.k1_expand_stats(yc, w.bfloat16())
    w_dw = torch.randn(48, 3, 3, device=dev)
    with pytest.raises(ValueError, match="go together"):
        FE.k2_depthwise(yc, w, None, w_dw, 1)
    with pytest.raises(ValueError, match="stride"):
        FE.k2_depthwise(yc, None, None, torch.randn(8, 3, 3, device=dev), 3)
    with pytest.raises(ValueError, match="se"):
        FE.k4_project(yc, torch.zeros(2, 8, device=dev),
                      torch.zeros(3, 8, device=dev), w[:4].contiguous())


# the run around the step: checkpoints restore onto the card bit for bit,
# and the crop computes on the card what it computes on the CPU
def _small_moma_cfg(save_dir, device):
    from moma_tpu_torch.core.config import parse_student_args

    return parse_student_args([
        "--distill", "moma", "--dataset", "prostate_hv", "--model_s",
        "effiB0", "--model_t", "effiB0", "--image_size", "32",
        "--batch_size", "4", "--nce_k", "64", "--feat_dim", "16", "--head",
        "mlp", "--attn", "self", "-b", "1", "--fp32", "--epochs", "1",
        "--device", device, "--save_dir", str(save_dir)])


def _assert_same(saved, restored, path="state"):
    if isinstance(saved, dict):
        assert set(saved) == set(restored), path
        for k in saved:
            _assert_same(saved[k], restored[k], f"{path}/{k}")
    elif isinstance(saved, (list, tuple)):
        for i, (a, b) in enumerate(zip(saved, restored)):
            _assert_same(a, b, f"{path}/{i}")
    elif isinstance(saved, torch.Tensor):
        assert restored.device.type == "cuda", path
        assert restored.dtype == saved.dtype, path
        assert torch.equal(restored.cpu(), saved.cpu()), path
    else:
        assert saved == restored, path


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A trained state saved from the card and restored onto it: every
    tensor on the card, equal bit for bit."""
    from moma_tpu_torch.core.checkpoint import CheckpointManager
    from moma_tpu_torch.data.pipeline import synthetic_dataset
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.moma import (build_state, full_state,
                                           load_full_state,
                                           make_moma_train_step)
    from moma_tpu_torch.train.teacher import augment_fns

    cfg = _small_moma_cfg(tmp_path, "cuda")
    state = build_state(cfg, dev, steps_per_epoch=2, seed=0)
    step = make_moma_train_step(cfg, augment_fns(cfg)[0],
                                kl_train_bn_override=True)
    ds = synthetic_dataset(4, 32, 4, seed=0)
    batch = to_device({"image": ds.images, "label": ds.labels}, dev)
    for i in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), map_location=dev)
    saved = full_state(state)
    ckpt.save("latest", saved, {"epoch": 1})
    restored = ckpt.restore("latest")
    _assert_same(saved, restored)
    fresh = build_state(cfg, dev, steps_per_epoch=2, seed=1)
    load_full_state(fresh, restored)
    _assert_same(saved, full_state(fresh))


def test_cpu_checkpoint_restores_onto_the_card(dev, tmp_path):
    """map_location follows --device: a checkpoint written by a CPU run
    loads onto the card, never onto the CPU."""
    from moma_tpu_torch.core.checkpoint import CheckpointManager
    from moma_tpu_torch.train.moma import (build_state, full_state,
                                           load_full_state)

    cpu_state = build_state(_small_moma_cfg(tmp_path, "cpu"),
                            torch.device("cpu"), steps_per_epoch=2, seed=0)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        "latest", full_state(cpu_state), {"epoch": 1})
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), map_location=dev)
    restored = ckpt.restore("latest")
    state = build_state(_small_moma_cfg(tmp_path, "cuda"), dev,
                        steps_per_epoch=2, seed=1)
    _assert_same(full_state(cpu_state), restored)
    load_full_state(state, restored)
    _assert_same(full_state(cpu_state), full_state(state))


@pytest.mark.parametrize("shape,out", [((8, 96, 96, 3), 64),
                                       ((4, 120, 80, 3), 96)])
def test_random_resized_crop_cuda_matches_cpu(dev, shape, out):
    """The crop's float32 products on the card against the CPU's, 1e-4 of
    the largest value (TF32 off: the dev fixture)."""
    from moma_tpu_torch.data.augment import random_resized_crop

    x = torch.randint(0, 256, shape, dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3)).float()
    want = random_resized_crop(x, torch.Generator().manual_seed(4), out,
                               scale=(0.2, 1.0))
    got = random_resized_crop(x.to(dev), torch.Generator().manual_seed(4),
                              out, scale=(0.2, 1.0))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


# the cross-arch path (config #5: ViT-S/16 teacher, effiB0 student, 224^2,
# batch 64): the BN reductions at the effiB0@224 widths, from the stem's
# 112^2 maps to the head's 3136 rows of 1280 channels, and the RandAugment
# layer on 224-wide images (448-byte bf16 rows)
@pytest.mark.parametrize("shape", [(64, 112, 112, 32), (64, 112, 112, 96),
                                   (64, 56, 56, 144), (64, 14, 14, 672),
                                   (64, 7, 7, 1280)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_match_plain_at_effib0_224(dev, shape, dtype):
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    mean = x.float().reshape(-1, shape[-1]).mean(0)
    for got, want in ((FB.channel_sums(x), FB.channel_sums_plain(x)),
                      (FB.grad_channel_sums(dy, x, mean),
                       FB.grad_channel_sums_plain(dy, x, mean))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("apply_p", [0.5, 1.0])
def test_ra_layer_matches_plain_at_224(dev, apply_p):
    """Every op at (64, 3, 224, 224) bf16, the cross-arch path's shape,
    bit for bit."""
    g = torch.Generator().manual_seed(4)
    op = torch.arange(64) % 16
    scal = _ra_scalars(dev, op, 224, 224, g, apply_p=apply_p)
    x = torch.randint(0, 256, (64, 3, 224, 224), generator=g).to(
        dev, torch.bfloat16)
    _ra_same(x, scal)


def test_vit_small_cuda_matches_cpu(dev):
    """ViT-S/16 at 224^2 (dim 384, depth 12, 6 heads, 197 tokens) on the
    card against its CPU run, float32 with TF32 off (the dev fixture):
    features and logits within 1e-4 of their largest magnitude."""
    from moma_tpu_torch.models import create_model

    model = create_model("vit_small_patch16_224", 4, image_size=224,
                         generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        (grid, cls), logits = model(x)
        (g_grid, g_cls), g_logits = model.to(dev)(x.to(dev))
    assert g_grid.shape == (4, 14, 14, 384) and g_cls.dtype == torch.float32
    for got, want in ((g_grid, grid), (g_cls, cls), (g_logits, logits)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_cross_arch_step_cuda_matches_cpu(dev, tmp_path):
    """One cross-arch step (vit_tiny teacher, effiB0 student, 64^2, batch 4,
    float32, augment included) on the card against the CPU: losses within
    1e-3, the student, the EMA copy and the queue within 1e-3 of each
    tensor's scale (floored at 1e-3 of the largest)."""
    import numpy as np

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.moma import build_state, make_moma_train_step
    from moma_tpu_torch.train.teacher import augment_fns

    cfg = parse_student_args([
        "--distill", "moma", "--dataset", "prostate_hv", "--model_s",
        "effiB0", "--model_t", "vit_tiny_patch16_224", "--image_size", "64",
        "--batch_size", "4", "--nce_k", "64", "--feat_dim", "32", "--head",
        "mlp", "--attn", "self", "-b", "1", "--fp32", "--epochs", "1",
        "--save_dir", str(tmp_path)])
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "label": rs.randint(0, 4, (4,)).astype(np.int32)}
    out = {}
    for device in (torch.device("cpu"), dev):
        state = build_state(cfg, device, steps_per_epoch=4, seed=0)
        step = make_moma_train_step(cfg, augment_fns(cfg)[0],
                                    kl_train_bn_override=True,
                                    cross_arch=True)
        out[device.type] = step(state, to_device(batch, device),
                                torch.Generator().manual_seed(5))
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        assert abs(float(mc[k]) - float(mg[k])) <= 1e-3 * abs(float(mc[k]))
    for a, b in ((sc.student, sg.student), (sc.ema, sg.ema)):
        pairs = [(p.detach(), q.detach().cpu()) for p, q in
                 zip(a.parameters(), b.parameters())]
        floor = 1e-3 * max(float(p.abs().max()) for p, _ in pairs)
        for p, q in pairs:
            assert float((p - q).abs().max()) <= 1e-3 * max(
                float(p.abs().max()), floor)
    torch.testing.assert_close(sg.queue.memory["memory"].cpu(),
                               sc.queue.memory["memory"], rtol=0, atol=1e-3)


def _step_on_both(dev, build, batch):
    """One step (augmentation included) built by `build(device) -> (state,
    step)` from one seed, on the CPU and on the card, same batch and
    draws."""
    from moma_tpu_torch.train.loop import to_device

    out = {}
    for device in (torch.device("cpu"), dev):
        state, step = build(device)
        out[device.type] = step(state, to_device(batch, device),
                                torch.Generator().manual_seed(5))
    return out["cpu"], out["cuda"]


def _close_modules(pairs):
    """Each parameter within 1e-3 of its largest magnitude (floored at
    1e-3 of the largest of all)."""
    pairs = [(p.detach(), q.detach().cpu()) for a, b in pairs
             for p, q in zip(a.parameters(), b.parameters())]
    floor = 1e-3 * max(float(p.abs().max()) for p, _ in pairs)
    for p, q in pairs:
        assert float((p - q).abs().max()) <= 1e-3 * max(
            float(p.abs().max()), floor)


def _small_batch(n_data=16):
    import numpy as np

    rs = np.random.RandomState(0)
    idx = rs.permutation(n_data)[:4].astype(np.int32)
    cidx = rs.randint(0, n_data, (4, 17)).astype(np.int32)
    cidx[:, 0] = idx
    return {"image": rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
            "label": rs.randint(0, 4, (4,)).astype(np.int32),
            "index": idx, "contrast_idx": cidx}


def test_vanilla_step_cuda_matches_cpu(dev):
    """One supervised step of effiB0 (64^2, batch 4, float32, augment
    included) on the card against the CPU: loss within 1e-3, every
    parameter within 1e-3 of its scale."""
    from moma_tpu_torch.core.config import parse_teacher_args
    from moma_tpu_torch.train.steps import make_vanilla_train_step
    from moma_tpu_torch.train.teacher import augment_fns, build_teacher_state

    cfg = parse_teacher_args([
        "--dataset", "prostate_hv", "--model", "effiB0", "--image_size",
        "64", "--batch_size", "4", "--fp32", "--epochs", "1"])
    (sc, mc), (sg, mg) = _step_on_both(
        dev, lambda d: (build_teacher_state(cfg, d, 4, 0),
                        make_vanilla_train_step(augment_fns(cfg)[0])),
        _small_batch())
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-3 * abs(
        float(mc["loss"]))
    _close_modules([(sc.model, sg.model)])


def test_crd_step_cuda_matches_cpu(dev):
    """One --distill crd step (effiB0 -> effiB0, 64^2, batch 4, K 16,
    float32) on the card against the CPU: the four losses within 1e-3, the
    student and the embeds within 1e-3 of their scale, the banks within
    1e-3 and Z within 1e-4 of theirs."""
    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train.distill import make_distill_train_step
    from moma_tpu_torch.train.student import build_distill_state
    from moma_tpu_torch.train.teacher import augment_fns

    cfg = parse_student_args([
        "--distill", "crd", "--dataset", "prostate_hv", "--model_s",
        "effiB0", "--model_t", "effiB0", "--image_size", "64",
        "--batch_size", "4", "--nce_k", "16", "--feat_dim", "32", "-b",
        "0.8", "--fp32", "--epochs", "1"])

    def build(d):
        state, distiller = build_distill_state(cfg, d, 4, 0, 16)
        return state, make_distill_train_step(distiller, augment_fns(cfg)[0])

    (sc, mc), (sg, mg) = _step_on_both(dev, build, _small_batch())
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        assert abs(float(mc[k]) - float(mg[k])) <= 1e-3 * abs(float(mc[k]))
    _close_modules([(sc.student, sg.student), (sc.aux, sg.aux)])
    for k, tol in (("v1", 1e-3), ("v2", 1e-3), ("z_v1", 1e-4),
                   ("z_v2", 1e-4)):
        want, got = getattr(sc.extra, k), getattr(sg.extra, k).cpu()
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


# the model zoo on CIFAR (32^2 maps, batch 64): the CIFAR ResNets' widths
# and the odd ones of MobileNetV2 half (8, 12), ShuffleV1 (54, 216) and
# ShuffleV2 (116), whose bf16 rows are no multiple of 16 bytes; held to
# 1e-4 of sum|.| per channel, as chip_smoke.py holds them
@pytest.mark.parametrize("C", [32, 64, 128, 256, 8, 12, 54, 116, 216])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_match_plain_at_zoo_shapes(dev, C, dtype):
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(2)
    shape = (64, 32, 32, C)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    mean = x.float().mean((0, 1, 2))
    xf, dyf = x.float(), dy.float()
    for got, want, bounds in (
            (FB.channel_sums(x), FB.channel_sums_plain(x),
             (xf.abs().sum((0, 1, 2)), (xf * xf).sum((0, 1, 2)))),
            (FB.grad_channel_sums(dy, x, mean),
             FB.grad_channel_sums_plain(dy, x, mean),
             (dyf.abs().sum((0, 1, 2)),
              (dyf * (xf - mean)).abs().sum((0, 1, 2))))):
        for a, b, bound in zip(got, want, bounds):
            assert float(((a - b).abs() / (bound + 1e-6)).max()) <= 1e-4


@pytest.mark.parametrize("name", ["ShuffleV1", "ShuffleV2"])
def test_zoo_forward_cuda_matches_cpu(dev, name):
    """ShuffleV1 / ShuffleV2 at 32^2, batch 4, float32 with TF32 off (the
    dev fixture): the eval-mode features and logits within 1e-4 of their
    largest magnitude; the train-mode ones and the updated running
    statistics within 1e-3 of it, or 8 times the CPU float32 run's
    distance from its float64 run where that is larger (train-mode
    BatchNorm over the 64 values a channel of the last 4x4 maps holds
    amplifies rounding)."""
    import copy

    from moma_tpu_torch.models import create_model

    model = create_model(name, 100,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    m64 = copy.deepcopy(model).double()
    card = copy.deepcopy(model).to(dev)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def close(got, want, ref, tol, what):
        want = want.float()
        lim = max(tol * float(want.abs().max()),
                  8 * float((want - ref.float()).abs().max()))
        err = float((got.cpu().float() - want).abs().max())
        assert err <= lim, (what, err, lim)

    with torch.no_grad():
        for train, tol in ((False, 1e-4), (True, 1e-3)):
            outs = []
            for m, xx in ((model, x), (card, x.to(dev)), (m64, x.double())):
                m.train(train)
                feats, logits = m(xx)
                outs.append((*feats, logits))
            assert outs[1][-1].dtype == torch.float32
            for i, (got, want, ref) in enumerate(zip(outs[1], outs[0],
                                                     outs[2])):
                close(got, want, ref, tol, f"train={train} output {i}")
    sd, sd_card, sd64 = (m.state_dict() for m in (model, card, m64))
    for k, want in sd.items():
        close(sd_card[k], want, sd64[k], 1e-3, k)


def test_avg_pool_with_padding_backward_on_the_card(dev):
    """The ShuffleV1 shortcut's 3x3 / 2 average pool with zero padding
    counted: F.avg_pool2d(padding=1) on a channels_last CUDA tensor gives
    wrong input gradients (PyTorch 2.11), the explicitly padded form the
    port uses gives the CPU's."""
    import torch.nn.functional as F

    x0 = torch.randn(4, 24, 16, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(4, 24, 8, 8, generator=torch.Generator().manual_seed(1))
    grads = []
    for device in ("cpu", dev):
        x = x0.to(device, memory_format=torch.channels_last)
        x.requires_grad_(True)
        (F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2) * w.to(device)).sum(
            ).backward()
        grads.append(x.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["v1-24-216", "v1-240-240", "v2-116"])
def test_shufflenet_units_backward_cuda_matches_cpu(dev, case):
    """One ShuffleV1 stride-2 bottleneck (the first stage's, from the
    24-channel stem, and a later one) and one ShuffleV2 DownBlock, train
    mode, float32, batch 4 at 16^2: the input's and every parameter's
    gradient of a fixed weighting of the output on the card within 1e-4
    of its largest magnitude of the CPU's, floored at 1e-2 of the largest
    gradient of all (a BN bias before a 1x1 conv and a train-mode BN has
    a zero gradient up to float noise), as the distillers' tests floor
    gradient groups."""
    import copy

    from moma_tpu_torch.models.shufflenet_v1 import Bottleneck
    from moma_tpu_torch.models.shufflenet_v2 import DownBlock

    g = torch.Generator().manual_seed(0)
    if case.startswith("v1"):
        cin, cout = map(int, case.split("-")[1:])
        unit, out_c = Bottleneck(cin, cout, 2, 3, generator=g), cout + cin
    else:
        cin, out_c = 116, 232
        unit = DownBlock(cin, out_c, generator=g)
    unit = unit.to(memory_format=torch.channels_last).train()
    x0 = torch.randn(4, cin, 16, 16, generator=g)
    w = torch.randn(4, out_c, 8, 8, generator=g)
    grads = []
    for device in ("cpu", dev):
        m = copy.deepcopy(unit).to(device)
        x = x0.to(device, memory_format=torch.channels_last)
        x.requires_grad_(True)
        (m(x) * w.to(device)).sum().backward()
        grads.append([x.grad.cpu()] + [p.grad.cpu() for p in m.parameters()])
    floor = 1e-2 * max(float(w.abs().max()) for w in grads[0])
    for got, want in zip(grads[1], grads[0]):
        assert float((got - want).abs().max()) <= 1e-4 * max(
            float(want.abs().max()), floor)


@pytest.mark.parametrize("consumer", ["device", "host"])
def test_packed_loader_through_the_pinned_ring(dev, tmp_path, consumer):
    """A train Loader over a packed file on a CUDA run: batches assembled
    into pinned slots and copied to the card without blocking the host.
    A slow consumer (the card busy 2 ms a batch while the host runs
    ahead, or the host sleeping) must still get every batch's own rows:
    a slot goes back to the batcher only after its copy has run.  Two
    epochs of 25 batches through a ring of 6 slots, an abandoned one in
    between; each batch equals numpy's rows."""
    import time

    import numpy as np

    from moma_tpu_torch.data.pipeline import ArrayDataset, Loader

    n, row, bs = 203, (16, 16, 3), 8
    rs = np.random.RandomState(0)
    arr = rs.randint(0, 256, (n, *row), dtype=np.uint8)
    path = str(tmp_path / "rows.bin")
    arr.tofile(path)
    labels = rs.randint(0, 4, n)
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, *row))
    ld = Loader(ArrayDataset(mm, labels, bin_path=path), bs, True, seed=1,
                num_workers=3, device=dev)
    ref = Loader(ArrayDataset(arr, labels), bs, True, seed=1)
    for epoch in range(2):
        if epoch == 1:
            for i, _ in enumerate(ld):   # abandoned after 3 batches
                if i == 2:
                    break
        ld.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = []
        for b in ld:
            assert b["image"].device.type == "cuda"
            if consumer == "device":
                torch.cuda._sleep(2_000_000)
            else:
                time.sleep(0.002)
            got.append(b)
        torch.cuda.synchronize()
        want = list(ref)
        assert len(got) == len(want) == n // bs
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"].cpu().numpy(),
                                          w["image"])
            np.testing.assert_array_equal(g["index"], w["index"])
    assert all(b.is_pinned() for b in ld._ring.bufs)


# ------------------------------------------------------------ data axis

def test_sync_bn_through_the_kernels_on_two_ranks(dev):
    """Two gloo ranks sharing the card, each a FusedBatchNorm on its rows
    under sync statistics: the channel-sum kernels run on each rank (their
    sums all-reduced), and y, dx, the summed dscale / dbias and the running
    statistics equal the plain version on the concatenated batch in one
    process."""
    import torch_dist_workers as W
    from moma_tpu_torch.core.mesh import spawn_ranks
    from moma_tpu_torch.ops.fused_bn import FusedBatchNorm

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 40, 9, 9, generator=g) * 2 + 0.5
    w = torch.randn(8, 40, 9, 9, generator=g)
    r0, r1 = spawn_ranks(W.sync_bn, 2, (x, w, "cuda"), backend="gloo",
                         timeout_s=240)
    for r in (r0, r1):
        assert r["launches"] == {"channel_sums": 1, "grad_channel_sums": 1}
    xc = x.clone().requires_grad_(True)
    bn = FusedBatchNorm(40)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 40))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 40))
    y = bn(xc)
    (y * w).sum().backward()
    got = {"y": torch.cat([r0["y"], r1["y"]]),
           "dx": torch.cat([r0["dx"], r1["dx"]]),
           "dscale": r0["dscale"] + r1["dscale"],
           "dbias": r0["dbias"] + r1["dbias"],
           "running_mean": r0["running_mean"],
           "running_var": r0["running_var"]}
    want = {"y": y.detach(), "dx": xc.grad, "dscale": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-5)


def test_two_rank_gloo_step_on_cuda_equals_the_accumulated_step(dev):
    """The 2-rank 'local' MoMA step on CUDA tensors (gloo, both ranks on
    the card; the RandAugment layer from each rank's stream) equals
    --grad_accum 2 in one process on the card, and the 2-rank 'global'
    step the one-process step: losses and every tensor of the state to
    1e-3 of its scale (floored at 1e-3 of its group's)."""
    import torch_dist_workers as W
    from moma_tpu_torch.core.mesh import spawn_ranks

    argv = ["--distill", "moma", "--dataset", "prostate_hv", "--model_s",
            "effiB0", "--model_t", "effiB0", "--image_size", "64",
            "--batch_size", "8", "--nce_k", "64", "--feat_dim", "32",
            "--head", "mlp", "--attn", "self", "-b", "1", "--fp32",
            "--kl_teacher_bn", "train", "--device", "cuda"]
    for bn, augment in (("local", True), ("global", False)):
        ranks = spawn_ranks(W.built_moma_step, 2,
                            (argv + ["--bn", bn], augment), backend="gloo",
                            timeout_s=300)
        want = W.built_moma_step(0, 1, argv + ["--grad_accum", "2" if
                                               bn == "local" else "1"],
                                 augment)
        (mg, sg), (mw, sw) = ranks[0], want
        for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
            assert abs(mg[k] - mw[k]) <= 1e-3 * abs(mw[k]), (bn, k)
        for part in sw:
            # tensors that are zero up to float noise (a bias feeding a
            # train-mode BN) are held to 1e-3 of their group's largest
            floor = 1e-3 * max(float(v.abs().max()) for v in sw[part].values()
                               if v.is_floating_point())
            for k, v in sw[part].items():
                if not v.is_floating_point():
                    continue
                scale = max(float(v.abs().max()), floor)
                gap = float((sg[part][k] - v).abs().max()) / scale
                assert gap <= 1e-3, (bn, part, k, gap)
                assert torch.equal(sg[part][k], ranks[1][1][part][k])


# ------------------------------------------------------------ model axis

def test_ring_attention_through_the_flash_kernels_on_two_ranks(dev):
    """The ring attention on two gloo ranks sharing the card (a 1 x 2
    grid, bank rows split over them): each rank runs flash_fwd twice on
    the forward (home keys, then the visiting shard) and flash_dq /
    flash_dkv twice on the backward; its outputs and every gradient equal
    dense attention over all the tokens in float64 on the CPU, to 1e-4 of
    each tensor's scale (the kernels are float32-accurate, TF32 off)."""
    import torch_model_axis_workers as W
    from moma_tpu_torch.core.mesh import spawn_ranks

    g = torch.Generator().manual_seed(3)
    nb, K, C, H = 24, 512, 64, 4
    inp = {"NB": nb, "H": H, "x_all": torch.randn(nb + K, C, generator=g),
           "kern": [torch.randn(C, 3 * C, generator=g) / C ** 0.5,
                    torch.randn(3 * C, generator=g) * 0.1,
                    torch.randn(C, C, generator=g) / C ** 0.5,
                    torch.randn(C, generator=g) * 0.1],
           "w_rep": torch.randn(nb, C, generator=g),
           "w_loc": torch.randn(K, C, generator=g)}
    r0, r1 = spawn_ranks(W.ring_on_grid, 2,
                         (inp, 2, nb, torch.float32, "cuda"),
                         backend="gloo", timeout_s=240)
    for r in (r0, r1):
        assert r["launches"] == {"flash_fwd": 2, "flash_dq": 2,
                                 "flash_dkv": 2}, r["launches"]
    x = inp["x_all"].double().requires_grad_(True)
    kern = [t.double().requires_grad_(True) for t in inp["kern"]]
    hd = C // H
    qkv = (x @ kern[0] + kern[1]).reshape(-1, 3, H, hd).permute(1, 2, 0, 3)
    att = torch.softmax(qkv[0] @ qkv[1].transpose(1, 2) * hd ** -0.5, -1)
    out = (att @ qkv[2]).permute(1, 0, 2).reshape(-1, C) @ kern[2] + kern[3]
    ((out[:nb] * inp["w_rep"].double()).sum()
     + (out[nb:] * inp["w_loc"].double()).sum()).backward()
    got = {"out_rep": r0["out_rep"],
           "out_loc": torch.cat([r0["out_loc"], r1["out_loc"]]),
           "dx_rep": r0["grads"][0],
           "dx_loc": torch.cat([r0["grads"][1], r1["grads"][1]])}
    want = {"out_rep": out[:nb], "out_loc": out[nb:], "dx_rep": x.grad[:nb],
            "dx_loc": x.grad[nb:]}
    # each rank's parameter gradients are whole (its ring order differs,
    # so the two agree up to float reassociation)
    for i, t in enumerate(kern):
        for r, res in enumerate((r0, r1)):
            got[f"dkern{i}_{r}"] = res["grads"][2 + i]
            want[f"dkern{i}_{r}"] = t.grad
    for k, w in want.items():
        w = w.detach().float()
        gap = float((got[k] - w).abs().max()) / float(w.abs().max())
        assert gap <= 1e-4, (k, gap)


def test_teacher_parallel_forwards_on_two_ranks(dev):
    """The tensor-parallel (TP), sequence-parallel (SP, 17 tokens padded
    to 18) and pipelined (1 and 2 microbatches) ViT teachers of
    moma_tpu_torch/models/vit_tp.py and vit_pp.py on two gloo ranks
    sharing the card (a 1 x 2 grid): each rank's forward equals the dense
    model's on the card to 1e-5 of max|ref|, float32 with TF32 off; a TP
    block runs two all_reduces, an SP block two reduce_scatters."""
    import torch_teacher_parallel_workers as W
    from moma_tpu_torch.core.mesh import spawn_ranks
    from moma_tpu_torch.models.vit import VisionTransformer

    vits = {"tp": dict(patch_size=8, dim=32, depth=2, num_heads=4),
            "pp": dict(patch_size=8, dim=32, depth=4, num_heads=4)}
    weights, dense = {}, {}
    for kind, dims in vits.items():
        m = VisionTransformer(**dims, num_classes=10, image_size=32,
                              generator=torch.Generator().manual_seed(1))
        weights[kind] = m.state_dict()
        dense[kind] = m.to(dev).eval()
    x = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    cases = [("tp", 0), ("sp", 0), ("pp", 1), ("pp", 2)]
    inp = {"vits": vits, "vit_weights": weights, "n_cls": 10, "HW": 32,
           "x": x, "forward_cases": cases}
    ranks = spawn_ranks(W.card_forwards, 2, (inp,), backend="gloo",
                        timeout_s=240)
    with torch.no_grad():
        want = {k: m(x.to(dev)) for k, m in dense.items()}
    for res in ranks:
        for (route, n_micro), got in res.items():
            (grid, cls), logits = want["pp" if route == "pp" else "tp"]
            for name, g, w in (("grid", got["grid"], grid),
                               ("cls", got["cls"], cls),
                               ("logits", got["logits"], logits)):
                w = w.float().cpu()
                gap = float((g - w).abs().max()) / float(w.abs().max())
                assert gap <= 1e-5, (route, n_micro, name, gap)
            comm = got["comm"]
            if route == "tp":
                assert comm["model_all_reduce"] == 4, comm
            elif route == "sp":
                assert comm["model_reduce_scatter"] == 4, comm


def test_moe_vit_cuda_matches_cpu(dev, monkeypatch):
    """The small MoE ViT of moma_tpu_torch/models/vit_moe.py (patch 8, dim
    32, depth 2, 2 heads, 4 experts, top-2 at capacity factor 0.5, so
    tokens drop) forward and backward on the card against its CPU run,
    float32 with TF32 off.  The card replays the CPU's expert choices
    (MoEMLP.choose, patched here): a choice within rounding of a tie may
    flip on another device, and under capacity pressure one flip moves
    every later token's slot.  Outputs and every parameter's gradient
    (the router's through the gates) within 1e-4 of their largest
    magnitude; the card's own choices equal the CPU's wherever the CPU's
    k-th and (k+1)-th probabilities are 1e-5 apart."""
    import torch.nn.functional as F

    from moma_tpu_torch.models.vit_moe import MoEMLP, MoEVisionTransformer

    model = MoEVisionTransformer(8, 32, 2, 2, 6, num_experts=4, top_k=2,
                                 capacity_factor=0.5, image_size=32,
                                 generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.rand(8, 32, 32, 3, generator=g)
    labels = torch.randint(0, 6, (8,), generator=g)
    choose, cpu, card = MoEMLP.choose, [], []

    def run(m, x, labels):
        (grid, cls), logits = m(x)
        loss = F.cross_entropy(logits, labels) + grid.square().mean()
        loss.backward()
        return {"grid": grid.detach(), "cls": cls.detach(),
                "logits": logits.detach(),
                **{n: p.grad for n, p in m.named_parameters()}}

    def record(self, probs):
        vals, idx = choose(self, probs)
        top = probs.detach().sort(-1, descending=True)[0]
        cpu.append((idx, top[:, 1] - top[:, 2]))
        return vals, idx

    def replay(self, probs):
        idx = cpu[len(card)][0].to(probs.device)
        card.append(choose(self, probs)[1].cpu())
        return probs.gather(-1, idx), idx

    monkeypatch.setattr(MoEMLP, "choose", record)
    want = run(model, x, labels)
    monkeypatch.setattr(MoEMLP, "choose", replay)
    model.zero_grad(set_to_none=True)
    got = run(model.to(dev), x.to(dev), labels.to(dev))
    assert len(card) == len(cpu) == 1
    for own, (idx, gap) in zip(card, cpu):
        clear = gap > 1e-5
        assert clear.float().mean() > 0.9
        assert torch.equal(own[clear], idx[clear])
    assert list(got) == list(want)
    for name, w in want.items():
        w = w.float()
        gap = float((got[name].float().cpu() - w).abs().max()) / float(
            w.abs().max())
        assert gap <= 1e-4, (name, gap)
