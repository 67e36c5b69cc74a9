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


@pytest.mark.parametrize("shape", [(4, 8, 8, 24), (2, 5, 3, 7), (3, 1000),
                                   (2, 4, 4, 1280), (1, 1, 1, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_match_plain(dev, shape, dtype):
    from moma_tpu_torch.ops import fused_bn as FB

    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    mean = x.float().reshape(-1, shape[-1]).mean(0)
    for got, want in ((FB.channel_sums(x), FB.channel_sums_plain(x)),
                      (FB.grad_channel_sums(dy, x, mean),
                       FB.grad_channel_sums_plain(dy, x, mean))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


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


@pytest.mark.parametrize("hw", [(32, 32), (24, 40), (7, 5)])
def test_ra_layer_matches_plain(dev, hw):
    from moma_tpu_torch.data import randaugment as RA
    from moma_tpu_torch.ops import randaugment as RK

    B = 2 * (RA.N_OPS + 1)
    H, W = hw
    g = torch.Generator().manual_seed(2)
    op = torch.arange(B) % (RA.N_OPS + 1)
    d = RA.draw_layer(B, g, 10.0, 0.5)
    apply = torch.rand(B, generator=g) < 0.8
    flip = torch.rand(B, generator=g) < 0.5
    scal = RK.layer_scalars(op.to(dev), d["mag"].to(dev), d["sign"].to(dev),
                            apply.to(dev), H, (124.0, 116.0, 104.0), W=W,
                            hflip=flip.to(dev))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randint(0, 256, (B, 3, H, W), generator=g).to(dev, dtype)
        got = RK.ra_layer(x, scal)
        want = RK.ra_layer_plain(x, scal)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=1.0)


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


@pytest.mark.parametrize("shape", [(4, 64, 64, 16), (2, 100, 100, 8),
                                   (4, 300, 300, 32), (1, 70, 257, 128),
                                   (2, 513, 200, 40)])
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
