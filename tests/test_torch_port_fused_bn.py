"""moma_tpu_torch.ops.fused_bn on the CPU against moma_tpu.ops.fused_bn.

The port's wrappers take their plain PyTorch versions for CPU tensors; the
JAX package runs its Pallas reduction kernels in interpret mode, and its
FusedBatchNorm under both the custom-VJP ('xla') and plain flax autodiff
('flax') modes.  Inputs come from numpy with a seed.  Tolerances as the
JAX package's own tests (tests/test_fused_bn.py:60-112): channel sums
rtol 1e-4 / atol 1e-3; BN output atol 2e-5 in f32 (3e-2 in bf16);
gradients atol 2e-4 of their max magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from moma_tpu.ops import fused_bn as JFB
from moma_tpu_torch.ops import fused_bn as FB

from torch_port_helpers import quick_jit

SHAPES = [
    ((8, 16, 16, 24), "float32"),
    ((8, 16, 16, 32), "bfloat16"),
    ((4, 8, 8, 144), "float32"),
    ((4, 4, 2, 7), "float32"),
]


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    JFB.set_fused_bn("auto")


def _inputs(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32) + 0.3
    if dtype == "bfloat16":  # both sides round the same f32 values to bf16
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_channel_sums_matches_pallas_interpret(shape, dtype):
    jx, tx = _inputs(shape, dtype)
    js, jq = JFB.channel_sums(jx, interpret=True)
    ts, tq = FB.channel_sums(tx)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_grad_channel_sums_matches_pallas_interpret(shape, dtype):
    jx, tx = _inputs(shape, dtype, seed=1)
    jdy, tdy = _inputs(shape, dtype, seed=2)
    mean = np.random.RandomState(3).randn(shape[-1]).astype(np.float32)
    js, jp = JFB.grad_channel_sums(jdy, jx, jnp.asarray(mean), interpret=True)
    ts, tp = FB.grad_channel_sums(tdy, tx, torch.from_numpy(mean))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-3)


def _jax_bn(x, scale, bias, w, dtype, ra_mean, ra_var):
    mod = JFB.FusedBatchNorm(use_running_average=False, momentum=0.99,
                             epsilon=1e-3, dtype=dtype)
    bs0 = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}

    def loss(x, s, b):
        v = {"params": {"scale": s, "bias": b}, "batch_stats": bs0}
        y, mut = mod.apply(v, x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, mut["batch_stats"])

    (_, (y, bs)), g = quick_jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, scale, bias)
    return y, bs, g


@pytest.mark.parametrize("mode", ["xla", "flax"])
@pytest.mark.parametrize("shape,dtype", SHAPES[:3])
def test_fused_batchnorm_matches_jax(mode, shape, dtype):
    JFB.set_fused_bn(mode)
    C = shape[-1]
    rs = np.random.RandomState(4)
    scale = (rs.rand(C) + 0.5).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)
    ra_mean = rs.randn(C).astype(np.float32)
    ra_var = (rs.rand(C) + 0.5).astype(np.float32)
    jx, tx = _inputs(shape, dtype, seed=5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jy, jbs, jg = _jax_bn(jx, jnp.asarray(scale), jnp.asarray(bias),
                          jnp.asarray(w), jdt, ra_mean, ra_var)

    bn = FB.FusedBatchNorm(C, momentum=0.99, eps=1e-3,
                           dtype=torch.bfloat16 if dtype == "bfloat16"
                           else None)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    bn.train()
    # NHWC data as a channels_last NCHW tensor, the port's conv layout
    xin = tx.permute(0, 3, 1, 2).detach().requires_grad_(True)
    y = bn(xin)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y_nhwc = y.permute(0, 2, 3, 1)
    (y_nhwc.float() * torch.from_numpy(w)).sum().backward()

    assert str(y.dtype)[6:] == str(jy.dtype)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y_nhwc.detach().float().numpy(),
                               np.float32(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), jbs["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), jbs["var"], rtol=1e-5,
                               atol=1e-6)
    grads = (xin.grad.permute(0, 2, 3, 1), bn.weight.grad, bn.bias.grad)
    for got, want in zip(grads, jg):
        want = np.float32(want)
        s = np.abs(want).max() + 1e-3
        np.testing.assert_allclose(got.float().numpy() / s, want / s,
                                   atol=2e-4 if dtype == "float32" else tol)


def test_fused_batchnorm_eval_uses_running_stats():
    C = 16
    rs = np.random.RandomState(6)
    x = rs.randn(4, 8, 8, C).astype(np.float32)
    bn = FB.FusedBatchNorm(C, eps=1e-3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rs.randn(C).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rs.rand(C).astype(np.float32)
                                              + 0.5))
    bn.eval()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    mod = nn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3)
    jy = mod.apply({"params": {"scale": jnp.ones(C), "bias": jnp.zeros(C)},
                    "batch_stats": {"mean": bn.running_mean.numpy(),
                                    "var": bn.running_var.numpy()}}, x)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-5)
    # eval mode touches no running statistic and launches no reduction
    assert bn.running_var.min() >= 0.5


def test_cuda_wrapper_rejects_cpu_only_inputs_by_device():
    """The wrapper's plain path is chosen by the tensor's device alone:
    a CPU tensor never reaches the kernel loader (no nvcc here)."""
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    reset_launch_counts()
    FB.channel_sums(torch.randn(2, 3, 4, 8))
    FB.grad_channel_sums(torch.randn(2, 8), torch.randn(2, 8),
                         torch.zeros(8))
    assert launch_counts() == {}
