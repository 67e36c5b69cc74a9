"""moma_tpu_torch's fused EfficientNet forward on the CPU against moma_tpu's.

(a) One MBConv block of each of effiB0's five (expand, kernel, stride)
    classes, train and eval mode, float32 and bfloat16: the port's
    `fused_block` (plain versions of K1 / K2 / K4 plus the SE and finalize
    torch ops) against `fused_effnet_pallas._fused_block(interpret=True)`,
    which runs the real Pallas kernels in interpret mode, on a tiny input.
    float32: 1e-5 absolute (both sum in float32, in another order).
    bfloat16: both round at the same points, so a value moves by a bf16 ulp
    only where a float32 sum lands on the other side of a rounding edge, and
    one such input can move an output by another: 2 bf16 ulps at max|ref|.
    Statistics: 1e-4 absolute in both.  XLA's CPU
    backend expands a bfloat16 logistic into bfloat16 ops (negate, exp, add,
    divide, each rounded), a property of that backend; the SE gate amplifies
    such an ulp into every pixel of a channel, so the bfloat16 cases give
    the JAX side's `jax.nn.sigmoid` / `jax.nn.silu` float32 internals
    rounded once, as torch computes them; one more bfloat16 case per class
    leaves the JAX side as it is and bounds the gap at 4 bf16 ulps.  An odd
    H x W (which the Pallas path's phase split cannot take) goes against the
    port's own `reference_block`.
(b) `fused_forward` of the whole effiB0 at 64^2, batch 3, float32, train and
    eval: against `fused_effnet_pallas.fused_forward(interpret=True)` and
    against the flax model, within 1e-3 of max|ref| (the bounds of
    tests/test_fused_effnet.py), 49 statistics pairs.
(c) `updated_batch_stats` against flax's mutated `batch_stats`, 1e-4.
(d) `extract_params` returns views: an in-place EMA on the module shows
    through, and the running-statistics update lands on the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.ops import fused_effnet as JFE
from moma_tpu.ops import fused_effnet_pallas as JFEP
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.ops import fused_effnet as FE
from moma_tpu_torch.train.moma import ema_update

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                make_init_ordered, quick_jit, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, C, H, W = 2, 8, 12, 16
# (expand, kernel, stride): block 0; 1; 2, 6, 7, 15; 3, 11; 4, 8-10, 12-14
CLASSES = [(1, 3, 1), (6, 3, 2), (6, 3, 1), (6, 5, 2), (6, 5, 1)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _block(expand, kernel, stride, seed):
    """One block's weights and statistics as numpy, and its spec fields."""
    rs = np.random.RandomState(seed)
    E, se = C * expand, 2
    out_f = C if stride == 1 else 12

    def bn(c):
        return {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
                "bias": (0.1 * rs.randn(c)).astype(np.float32),
                "mean": (0.05 * rs.randn(c)).astype(np.float32),
                "var": (0.5 + 0.5 * rs.rand(c)).astype(np.float32)}

    def w(*shape, fan):
        return (rs.randn(*shape) * fan ** -0.5).astype(np.float32)

    blk = {}
    if expand != 1:
        blk["w_exp"] = w(E, C, fan=C)
        blk["bn1"] = bn(E)
    blk.update(
        w_dw=w(E, kernel, kernel, fan=kernel * kernel), bn2=bn(E),
        w_se1=w(se, E, fan=E), b_se1=(0.1 * rs.randn(se)).astype(np.float32),
        w_se2=w(E, se, fan=se), b_se2=(0.1 * rs.randn(E)).astype(np.float32),
        w_proj=w(out_f, E, fan=E), bn3=bn(out_f))
    fields = dict(in_filters=C, out_filters=out_f, expand=expand,
                  kernel=kernel, stride=stride, se=se,
                  has_skip=stride == 1)
    return blk, fields, rs


def _tree(blk, leaf):
    return {k: ({kk: leaf(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v)) for k, v in blk.items()}


def _nchw(a, dtype):
    """numpy NCHW -> the port's layout: NCHW in channels_last memory."""
    return torch.from_numpy(a).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _both_blocks(cls, train, dt):
    """One block through moma_tpu's Pallas path (interpret mode) and through
    the port's `fused_block`: outputs as float32 numpy, statistics lists."""
    jdt, tdt = DTYPES[dt]
    blk, fields, rs = _block(*cls, seed=11)
    y = rs.randn(N, C, H, W).astype(np.float32)

    JFEP._set_compute_dtype(jdt)
    j_coll = []
    j_out, _ = JFEP._fused_block(
        _tree(blk, jnp.asarray), JFE.BlockSpec(**fields),
        jnp.asarray(y).astype(jdt), H, train, j_coll, True)
    JFEP._set_compute_dtype(jnp.bfloat16)

    t_coll = []
    t_out = FE.fused_block(_tree(blk, torch.from_numpy),
                           FE.BlockSpec(**fields), _nchw(y, tdt), train,
                           t_coll)
    assert t_out.dtype == tdt
    assert t_out.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(j_out.astype(jnp.float32))
    got = t_out.float().numpy()
    assert got.shape == want.shape
    n_bn = (3 if cls[0] != 1 else 2) if train else 0
    assert len(t_coll) == len(j_coll) == n_bn
    return got, want, t_coll, j_coll


def _assert_stats(t_coll, j_coll, atol):
    for (tm, tv), (jm, jv) in zip(t_coll, j_coll):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=atol)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol)


CLASS_IDS = [f"e{e}k{k}s{s}" for e, k, s in CLASSES]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("cls", CLASSES, ids=CLASS_IDS)
def test_fused_block_matches_pallas_interpret(cls, train, dt, monkeypatch):
    sigmoid, silu = jax.nn.sigmoid, jax.nn.silu
    monkeypatch.setattr(jax.nn, "sigmoid", lambda x: sigmoid(
        x.astype(jnp.float32)).astype(x.dtype))
    monkeypatch.setattr(jax.nn, "silu", lambda x: silu(
        x.astype(jnp.float32)).astype(x.dtype))
    got, want, t_coll, j_coll = _both_blocks(cls, train, dt)
    err = np.abs(got - want).max()
    if dt == "f32":
        assert err <= 1e-5, err
    else:
        assert err <= 2.0 ** -7 * np.abs(want).max(), (
            err, np.abs(want).max(), (got != want).mean())
    _assert_stats(t_coll, j_coll, 1e-4)


@pytest.mark.parametrize("cls", CLASSES, ids=CLASS_IDS)
def test_fused_block_bf16_against_unpatched_jax(cls):
    """The bfloat16 block against moma_tpu exactly as it runs on the CPU,
    its bfloat16 logistic left to XLA.  What the float32-internals pin of
    the case above hides is bounded here: over three seeds, the five classes
    and both modes the gap measured 0.9 to 2.9 units of 2^-8 max|ref|, with
    15 to 69 % of the elements differing, and statistics moved by at most
    9.1e-4.  Bounds: 4 bf16 ulps at max|ref| (2^-6 max|ref|) and 2e-3."""
    got, want, t_coll, j_coll = _both_blocks(cls, True, "bf16")
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    print(f"gap to the unpatched reference: {err / ref * 256:.2f} x 2^-8 "
          f"max|ref|, {(got != want).mean():.3f} of the elements differ")
    assert err <= 2.0 ** -6 * ref, (err, ref)
    _assert_stats(t_coll, j_coll, 2e-3)


@pytest.mark.parametrize("cls", [(6, 3, 2), (6, 5, 2), (6, 5, 1)],
                         ids=["e6k3s2", "e6k5s2", "e6k5s1"])
def test_fused_block_at_odd_size_matches_reference_block(cls):
    """11 x 13: TF-SAME pads stride 2 by (1, 1) for k3 and (2, 2) for k5
    here, not the (0, 1) / (1, 2) of an even size."""
    blk, fields, rs = _block(*cls, seed=12)
    y = _nchw(rs.randn(N, C, 11, 13).astype(np.float32), torch.float32)
    tblk, spec = _tree(blk, torch.from_numpy), FE.BlockSpec(**fields)
    for train in (True, False):
        c_f, c_r = [], []
        got = FE.fused_block(tblk, spec, y, train, c_f)
        want = FE.reference_block(tblk, spec, y, train, c_r, torch.float32)
        s = cls[2]
        assert got.shape == (N, fields["out_filters"], -(-11 // s),
                             -(-13 // s))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert len(c_f) == len(c_r) == (3 if train else 0)
        for (a, b), (c, d) in zip(c_f, c_r):
            torch.testing.assert_close(a, c, rtol=0, atol=1e-5)
            torch.testing.assert_close(b, d, rtol=0, atol=1e-5)


def test_reference_block_rounds_like_the_jax_reference_in_bf16():
    """The plain mirror keeps reference_block's two bf16 deviations from the
    fused path (taps rounded to bf16, SE pooled from the rounded map)."""
    blk, fields, rs = _block(6, 5, 1, seed=13)
    y = rs.randn(N, C, H, W).astype(np.float32)
    j_out = JFE.reference_block(
        _tree(blk, jnp.asarray), JFE.BlockSpec(**fields),
        jnp.asarray(y).astype(jnp.bfloat16), True, [], jnp.bfloat16)
    t_out = FE.reference_block(
        _tree(blk, torch.from_numpy), FE.BlockSpec(**fields),
        _nchw(y, torch.bfloat16), True, [], torch.bfloat16)
    want = np.asarray(j_out.astype(jnp.float32))
    err = np.abs(t_out.float().numpy() - want).max()
    assert err <= 2.0 ** -6 * np.abs(want).max(), err


# ------------------------------------------------------------ whole model

B, HW, N_CLS = 3, 64, 5


@pytest.fixture(scope="module")
def pair():
    jm = efficientnet_b0(num_classes=N_CLS)
    v = make_init_ordered(jm, (2, HW, HW, 3))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)

    def perturb(node):
        if "mean" in node:
            node["mean"] = (0.05 * rs.randn(*node["mean"].shape)).astype(
                np.float32)
            node["var"] = (0.5 + 0.5 * rs.rand(*node["var"].shape)).astype(
                np.float32)
        else:
            for child in node.values():
                perturb(child)

    perturb(v["batch_stats"])
    x = rs.randn(B, HW, HW, 3).astype(np.float32)
    return jm, v, x


def _port_model(v):
    tm = EfficientNet("b0", num_classes=N_CLS)
    load_jax_variables(tm, v)
    return tm.to(memory_format=torch.channels_last)


def _rel(got, want, floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + floor))


def test_block_specs_and_bn_order_match_jax():
    for variant in ("b0", "b3", "b7"):
        assert [tuple(s) for s in FE.block_specs(variant)] == [
            tuple(s) for s in JFE.block_specs(variant)]
    tm = EfficientNet("b0", num_classes=N_CLS)
    params, specs = FE.extract_params(tm)
    order = FE.bn_order(params, specs)
    assert len(order) == len(JFE.bn_order(JFE.block_specs("b0"))) == 49
    assert order[0]["mean"].data_ptr() == tm.bn0.running_mean.data_ptr()
    assert order[-1]["var"].data_ptr() == tm.bn1.running_var.data_ptr()
    with pytest.raises(ValueError, match="blocks"):
        FE.extract_params(tm, "b1")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_forward_matches_pallas_path_and_flax(pair, train):
    jm, v, x = pair
    jparams, jspecs = JFE.extract_params(v)
    # jitted: eager dispatch of a whole forward costs several times as much
    jp, jl, jc = quick_jit(lambda p, xx: JFEP.fused_forward(
        p, jspecs, xx, train=train, interpret=True,
        compute_dtype=jnp.float32))(jparams, jnp.asarray(x))
    if train:
        (ff, fl), _ = quick_jit(lambda vv, xx: jm.apply(
            vv, xx, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    else:
        ff, fl = quick_jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
            v, jnp.asarray(x))

    params, specs = FE.extract_params(_port_model(v))
    tp, tl, tc = FE.fused_forward(params, specs, torch.from_numpy(x), train,
                                  torch.float32)
    assert tp.dtype == tl.dtype == torch.float32
    assert tp.shape == (B, 1280) and tl.shape == (B, N_CLS)
    for want_p, want_l in ((jp, jl), (ff[-1], fl)):
        assert _rel(tp.numpy(), want_p) < 1e-3
        assert _rel(tl.numpy(), want_l) < 1e-3
    assert len(tc) == len(jc) == (49 if train else 0)
    for (tm_, tv), (jm_, jv) in zip(tc, jc):
        assert _rel(tm_.numpy(), jm_, 1e-2) < 1e-3
        assert _rel(tv.numpy(), jv, 1e-2) < 1e-3


def test_reference_forward_matches_jax_reference(pair):
    _, v, x = pair
    jparams, jspecs = JFE.extract_params(v)
    jp, jl, jc = quick_jit(lambda p, xx: JFE.reference_forward(
        p, jspecs, xx, train=True, compute_dtype=jnp.float32))(
        jparams, jnp.transpose(jnp.asarray(x), (0, 3, 1, 2)))
    params, specs = FE.extract_params(_port_model(v))
    tp, tl, tc = FE.reference_forward(params, specs, torch.from_numpy(x),
                                      True, torch.float32)
    assert _rel(tp.numpy(), jp) < 1e-4 and _rel(tl.numpy(), jl) < 1e-4
    assert len(tc) == len(jc) == 49
    for (tm_, tv), (jm_, jv) in zip(tc, jc):
        assert _rel(tm_.numpy(), jm_, 1e-2) < 1e-4
        assert _rel(tv.numpy(), jv, 1e-2) < 1e-4


def test_updated_batch_stats_match_flax(pair):
    jm, v, x = pair
    _, mut = quick_jit(lambda vv, xx: jm.apply(
        vv, xx, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = _port_model(v)
    params, specs = FE.extract_params(tm)
    _, _, coll = FE.fused_forward(params, specs, torch.from_numpy(x), True,
                                  torch.float32)
    FE.updated_batch_stats(params, specs, coll)
    got = jax_variables(tm, v)["batch_stats"]
    want = jax.device_get(mut["batch_stats"])
    n = 0
    for path, a, b in walk_pairs(got, want, "bs"):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, err_msg=path)
        n += 1
    assert n == 2 * 49
    floor = group_floor(want)
    before = v["batch_stats"]
    for path, a, b in walk_pairs(got, want, "bs"):
        assert_close_scaled(a, b, 1e-4, path, floor)
    moved = [np.abs(a - b).max() for _, a, b in walk_pairs(got, before, "bs")]
    assert min(moved) > 0          # every running statistic was updated
    with pytest.raises(ValueError, match="pairs"):
        FE.updated_batch_stats(params, specs, coll[:-1])


def test_extract_params_returns_views(pair):
    _, v, x = pair
    tm, src = _port_model(v), EfficientNet("b0", num_classes=N_CLS)
    params, specs = FE.extract_params(tm)
    leaves = [t for blk in params["blocks"] for t in blk.values()
              if isinstance(t, torch.Tensor)]
    leaves += [params[k] for k in ("stem_w", "head_w", "cls_w", "cls_b")]
    own = {p.data_ptr() for p in tm.parameters()}
    assert all(t.data_ptr() in own for t in leaves)
    assert params["blocks"][1]["w_exp"].shape == (96, 16)
    assert params["blocks"][3]["w_dw"].shape == (144, 5, 5)
    assert params["blocks"][0]["w_se1"].shape == (8, 32)
    assert "w_exp" not in params["blocks"][0]

    xt = torch.from_numpy(x)
    before = FE.fused_forward(params, specs, xt, False, torch.float32)[0]
    ema_update(tm, src, 0.5)       # in place, as the MoMA step does
    after = FE.fused_forward(params, specs, xt, False, torch.float32)[0]
    fresh = FE.fused_forward(*FE.extract_params(tm), xt, False,
                             torch.float32)[0]
    assert float((after - before).abs().max()) > 1e-3
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)
    tm.eval()
    with torch.no_grad():
        feats, _ = tm(xt)
    assert _rel(after.numpy(), feats[-1].numpy()) < 1e-3
