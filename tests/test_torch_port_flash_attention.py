"""Streaming attention: moma_tpu_torch against moma_tpu on the CPU.

The same numpy inputs go through the port's `streaming_attention` (on CPU
tensors: the plain versions of the three flash kernels) and through the JAX
package twice: its chunked route (`use_pallas=False`) and its Pallas
kernels in interpret mode (`_flash_forward` / `_flash_backward`, as
tests/test_flash_attention.py runs them; a ragged N pads the keys to a
block multiple and masks them with `n_real`).

Tolerances: float32 values atol 2e-5 (outputs are averages of N(0,1) values,
the packages differ in the order of their float32 sums only), gradients
rtol 2e-4 / atol 5e-5.  bf16 inputs: the tolerance of the JAX package's own
bf16 test (atol 0.15, rtol 0.1) against its chunked route, which keeps p in
float32 where the kernels round it to bf16, and one bf16 ulp (rtol 2^-7)
against the interpreted kernels, which round where the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.moma.cmo import BatchTokenAttention as JAttention
from moma_tpu.ops import flash_attention as JFA

from moma_tpu_torch.interop import load_jax_variables
from moma_tpu_torch.moma import cmo as tcmo
from moma_tpu_torch.ops import flash_attention as FA

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import ordered_numpy, quick_jit

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(64, 16), (100, 16), (512, 16), (64, 32), (100, 32), (512, 32)]


def _inputs(N, d, H=2, seed=0):
    rs = np.random.RandomState(seed + N + d)
    return [rs.randn(H, N, d).astype(np.float32) for _ in range(4)]


def _torch_run(q, k, v, w, dtype=torch.float32, chunk=48):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    scale = q.shape[-1] ** -0.5
    o = FA.streaming_attention(*leaves, scale, chunk)
    (o.float() * torch.from_numpy(w)).sum().backward()
    _, m, l = FA.flash_fwd((leaves[0] * scale).detach(), leaves[1].detach(),
                           leaves[2].detach(), chunk)
    return ([o.detach().float().numpy(), m.numpy(), l.numpy()]
            + [t.grad.float().numpy() for t in leaves])


def _interpret_run(q, k, v, w, dtype=jnp.float32):
    H, N, d = q.shape
    scale = d ** -0.5
    bq = 16 if N % 16 == 0 else 20
    bk = 16
    npad = -(-N // bk) * bk
    n_real = N if npad != N else None

    # one program (eagerly, every op and kernel call compiles alone)
    def run(q, k, v, w):
        kp = jnp.pad(k, ((0, 0), (0, npad - N), (0, 0)))
        vp = jnp.pad(v, ((0, 0), (0, npad - N), (0, 0)))
        o, m, l = JFA._flash_forward(q, kp, vp, scale, bq, bk,
                                     n_real=n_real, interpret=True)
        dq, dk, dv = JFA._flash_backward(q, kp, vp, o, m, l, w, scale, bq,
                                         bk, n_real=n_real, interpret=True)
        return o, m, l, dq, dk[:, :N], dv[:, :N]

    out = quick_jit(run)(*(jnp.asarray(a, dtype) for a in (q, k, v, w)))
    return [np.asarray(a, np.float32) for a in out]


def _chunked_run(q, k, v, w, dtype=jnp.float32, chunk=48):
    scale = q.shape[-1] ** -0.5
    q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))

    def loss(q, k, v):
        o = JFA.streaming_attention(q, k, v, scale, False, chunk)
        return jnp.sum(o.astype(jnp.float32) * w), o

    grads, o = quick_jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return [np.asarray(o, np.float32)] + [np.asarray(g, np.float32)
                                          for g in grads]


@pytest.mark.parametrize("N,d", SHAPES)
def test_streaming_attention_matches_jax_chunked(N, d):
    q, k, v, w = _inputs(N, d)
    o, _, _, dq, dk, dv = _torch_run(q, k, v, w)
    jo, jdq, jdk, jdv = _chunked_run(q, k, v, w)
    np.testing.assert_allclose(o, jo, atol=2e-5, rtol=0)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("N,d", SHAPES)
def test_streaming_attention_matches_pallas_interpret(N, d):
    q, k, v, w = _inputs(N, d, seed=1)
    o, m, l, dq, dk, dv = _torch_run(q, k, v, w)
    jo, jm, jl, jdq, jdk, jdv = _interpret_run(q, k, v, w)
    np.testing.assert_allclose(o, jo, atol=2e-5, rtol=0)
    np.testing.assert_allclose(m, jm, atol=2e-5, rtol=0)
    np.testing.assert_allclose(l, jl, rtol=2e-5)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("N,d", [(96, 16), (100, 32)])
def test_streaming_attention_bf16_inputs(N, d):
    q, k, v, w = _inputs(N, d, seed=2)
    got = _torch_run(q, k, v, w, torch.bfloat16, chunk=32)
    o, dq, dk, dv = got[0], got[3], got[4], got[5]
    for g, want in zip((o, dq, dk, dv),
                       _chunked_run(q, k, v, w, jnp.bfloat16, 32)):
        np.testing.assert_allclose(g, want, atol=0.15, rtol=0.1)
    jo, _, _, jdq, jdk, jdv = _interpret_run(q, k, v, w, jnp.bfloat16)
    for g, want in ((o, jo), (dq, jdq), (dk, jdk), (dv, jdv)):
        # one bf16 ulp of the largest entry: the two round p, ds and the
        # outputs at the same points, but sum in another order before
        np.testing.assert_allclose(g, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def test_forward_only_entry_points_agree():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(100, 16, seed=3))
    want = torch.softmax(q @ k.transpose(1, 2) * 0.25, -1) @ v
    torch.testing.assert_close(FA.flash_attention(q, k, v, 0.25), want,
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(FA.chunked_attention(q, k, v, 0.25, chunk=7),
                               want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("N", [40, 300])
def test_batch_token_attention_big_matches_dense(N, monkeypatch):
    """The streaming path against the dense module of both packages, with
    the JAX module's weights carried across: values and parameter
    gradients."""
    C, H = 32, 4
    rs = np.random.RandomState(N)
    x = rs.randn(N, C).astype(np.float32)
    w = rs.randn(N, C).astype(np.float32)
    jmod = JAttention(C, num_heads=H)
    params = ordered_numpy(jmod.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, C)))["params"])

    def jloss(p, big):
        if big:
            y = JFA.batch_token_attention_big(
                x, p["TorchLinear_0"]["kernel"], p["TorchLinear_0"]["bias"],
                p["TorchLinear_1"]["kernel"], p["TorchLinear_1"]["bias"], H,
                use_pallas=False)
        else:
            y = jmod.apply({"params": p}, x)
        return jnp.sum(y * w), y

    (jg_dense, jy_dense) = quick_jit(jax.grad(
        lambda p: jloss(p, False), has_aux=True))(params)
    (jg_big, jy_big) = quick_jit(jax.grad(
        lambda p: jloss(p, True), has_aux=True))(params)

    tmod = tcmo.BatchTokenAttention(C, num_heads=H)
    load_jax_variables(tmod, {"params": params})
    out = {}
    for big in (False, True):
        # the module takes the streaming path above DENSE_MAX_TOKENS tokens
        monkeypatch.setattr(tcmo, "DENSE_MAX_TOKENS", 8 if big else 10 ** 6)
        tmod.zero_grad()
        y = tmod(torch.from_numpy(x))
        (y * torch.from_numpy(w)).sum().backward()
        out[big] = (y.detach().numpy(), {
            "TorchLinear_0": {"kernel": tmod.qkv.weight.grad.t().numpy(),
                              "bias": tmod.qkv.bias.grad.numpy()},
            "TorchLinear_1": {"kernel": tmod.proj.weight.grad.t().numpy(),
                              "bias": tmod.proj.bias.grad.numpy()}})
    for big in (False, True):
        y, grads = out[big]
        for jy, jg in ((jy_dense, jg_dense), (jy_big, jg_big)):
            np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4, rtol=0)
            for mod in grads:
                for leaf in grads[mod]:
                    np.testing.assert_allclose(
                        grads[mod][leaf], np.asarray(jg[mod][leaf]),
                        atol=1e-4, rtol=1e-4, err_msg=f"{mod}/{leaf}")


def test_attention2_stays_dense_above_the_threshold(monkeypatch):
    monkeypatch.setattr(tcmo, "DENSE_MAX_TOKENS", 8)
    calls = []
    monkeypatch.setattr(tcmo, "batch_token_attention_big",
                        lambda *a, **k: calls.append(1))
    mod = tcmo.BatchTokenAttention2(16, num_heads=4)
    y = mod(torch.randn(20, 16, generator=torch.Generator().manual_seed(0)))
    assert y.shape == (20, 16) and not calls


def test_only_the_device_picks_the_route():
    """No flag chooses between kernel and plain version and nothing falls
    back from one to the other."""
    import inspect

    for fn in (FA.flash_fwd, FA.flash_dq, FA.flash_dkv,
               FA.streaming_attention, FA.batch_token_attention_big):
        assert "use_pallas" not in inspect.signature(fn).parameters
    src = inspect.getsource(FA)
    assert "try:" not in src and "except" not in src


# ------------------------------------------------- tensor-core numerics
# csrc/flash_attention.cu computes the forward and dq products of float32
# operands on the tensor cores as three TF32 products, a_hi b_hi + a_hi b_lo
# + a_lo b_hi with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi),
# accumulated in float32.  These tests emulate that arithmetic in numpy and
# show why three products are needed for the kernels' 1e-4 tolerance.


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero,
    on the float32 bit pattern."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_dot(a, b, products):
    """a @ b of float32 matrices as TF32 products summed in float32: one
    product (hi hi) or three (lo hi + hi lo + hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if products == 3:
        out = (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + out
    return out


def test_tf32_emulation_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -12, 3.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                    np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    lo = _tf32(x - _tf32(x))
    assert np.all(np.abs(x - _tf32(x) - lo) <= 2.0 ** -21 * np.abs(x))


@pytest.mark.parametrize("products,bound,within", [(3, 1e-5, True),
                                                   (1, 1e-4, False)])
def test_attention_on_tf32_products(products, bound, within):
    """softmax(qs k^T) v at (1, 2056, 128), as chip_smoke.py draws its
    inputs, against a float64 reference: three TF32 products per float32
    product stay within 1e-5 of max|ref|, one does not stay within 1e-4."""
    rs = np.random.RandomState(0)
    N, d = 2056, 128
    qs = (rs.randn(N, d) * d ** -0.5).astype(np.float32)
    k, v = (rs.randn(N, d).astype(np.float32) for _ in range(2))
    s64 = qs.astype(np.float64) @ k.T.astype(np.float64)
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    ref = (p64 @ v) / p64.sum(-1, keepdims=True)
    s = _tf32_dot(qs, k.T, products)
    p = np.exp(s - s.max(-1, keepdims=True))
    o = _tf32_dot(p, v, products) / p.sum(-1, keepdims=True)
    err = np.abs(o - ref).max() / np.abs(ref).max()
    assert (err <= bound) == within, err


@pytest.mark.parametrize("products,bound,within", [(3, 1e-5, True),
                                                   (1, 1e-4, False)])
def test_dkv_on_tf32_products(products, bound, within):
    """dk and dv as csrc/flash_attention.cu's dk/dv kernel computes them, on
    transposed scores: s^T = K qs^T and dp^T = V dO^T, p^T = exp(s^T - m) / l
    and ds^T = p^T (dp^T - delta) by query column, dv = p^T dO and
    dk = ds^T qs, every product of float32 operands as TF32 products.  At
    (1, 2056, 128), drawn as chip_smoke.py draws its inputs, three products
    stay within 1e-5 of max|ref| of a float64 reference for both, one does
    not stay within 1e-4."""
    rs = np.random.RandomState(0)
    N, d = 2056, 128
    qs = (rs.randn(N, d) * d ** -0.5).astype(np.float32)
    k, v, do = (rs.randn(N, d).astype(np.float32) for _ in range(3))
    q64, k64, v64, g64 = (t.astype(np.float64) for t in (qs, k, v, do))
    s64 = q64 @ k64.T
    m64 = s64.max(-1, keepdims=True)
    l64 = np.exp(s64 - m64).sum(-1, keepdims=True)
    p64 = np.exp(s64 - m64) / l64
    delta64 = ((p64 @ v64) * g64).sum(-1, keepdims=True)
    ds64 = p64 * (g64 @ v64.T - delta64)
    ref = {"dk": ds64.T @ q64, "dv": p64.T @ g64}
    # the kernel's inputs: the forward's statistics as float32 rows
    m, l, delta = (t.astype(np.float32).T for t in (m64, l64, delta64))
    pt = np.exp(_tf32_dot(k, qs.T, products) - m) / l
    dst = pt * (_tf32_dot(v, do.T, products) - delta)
    got = {"dk": _tf32_dot(dst, qs, products),
           "dv": _tf32_dot(pt, do, products)}
    for name in ("dk", "dv"):
        err = np.abs(got[name] - ref[name]).max() / np.abs(ref[name]).max()
        assert (err <= bound) == within, (name, err)
