"""The Mixture-of-Experts ViT (moma_tpu_torch/models/vit_moe.py) against
moma_tpu/models/vit_moe.py on the CPU, one process, on the JAX tests'
shapes (tests/test_vit_moe.py): one test, its cases in turn (each a few
hundred milliseconds but the train step), so that the suite's collected
count stays put.

  * MoEMLP with the weights carried over, against JAX's MoEMLP at its
    tolerance (rtol 2e-5, atol 2e-6):
      - E = 1 is the dense MLP gelu(x @ w1 + b1) @ w2 + b2 (rtol / atol
        1e-5, tests/test_vit_moe.py:60-73), and JAX's;
      - capacity factor 0.25 (S 64, E 2): the same set of dropped tokens,
        whose outputs are exactly 0, and the same outputs;
      - top-2 (E 4, capacity factor 4): the gates renormalise (w2 = 0,
        b2 = 1 gives 1 for every token) and the outputs are JAX's, also at
        capacity factor 0.5, where second choices are dropped;
      - the Switch load-balance value equals JAX's sown `moe_aux` to 1e-6;
      - an exact router tie (integer inputs and router, two equal router
        columns, every sum exact in float32) goes to the lower expert
        index, in both packages;
  * the small MoE ViT (patch 8, dim 32, depth 2, 2 heads, 4 experts;
    capacity factor 2 and 0.5, the latter dropping tokens) forward in
    float32 from JAX's init, carried over by interop: grid, cls token and
    logits to rtol 2e-5 / atol 2e-6, and the carried weights back to JAX's
    tree bit for bit;
  * one step of run_teacher's train step (make_vanilla_train_step: SGD,
    momentum 0.9, weight decay 5e-4, capacity factor 1 so that tokens
    drop) against JAX's: the loss to 1e-3 of its size and every parameter,
    the router included, to 1e-3 of its group's scale, their updates to
    2e-3 of theirs.

Routing near-ties: a token whose top two router probabilities lie within
rounding of each other could route differently in the two packages; every
routed token here is asserted 1e-4 from a tie
(`torch_port_helpers.route_margin`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.models.vit_moe import MoEMLP as JMoEMLP
from moma_tpu.models.vit_moe import MoEVisionTransformer as JMoEViT
from moma_tpu.train.state import TrainState as JTrainState
from moma_tpu.train.state import make_sgd as j_make_sgd
from moma_tpu.train.steps import make_vanilla_train_step as j_vanilla_step

from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.models.vit_moe import (MoEMLP, MoEVisionTransformer,
                                           is_moe_model)
from moma_tpu_torch.train.state import TrainState, make_sgd
from moma_tpu_torch.train.steps import make_vanilla_train_step

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                make_init_ordered, quick_compiled,
                                quick_jit, route_margin, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_CLS, HW = 6, 32
RTOL, ATOL = 2e-5, 2e-6
# (label, S, dim, hidden, experts, top_k, capacity factor)
MLP_CASES = [("single_expert", 20, 16, 32, 1, 1, 1.0),
             ("drop", 64, 8, 16, 2, 1, 0.25),
             ("top2", 32, 8, 16, 4, 2, 4.0),
             ("top2_drop", 64, 8, 16, 4, 2, 0.5)]
TIE_MARGIN = 1e-4


def _small_moe(cf=2.0, num_experts=4):
    """tests/test_vit_moe.py's _small_moe, both packages."""
    dims = dict(patch_size=8, dim=32, depth=2, num_heads=2,
                num_classes=N_CLS, num_experts=num_experts,
                capacity_factor=cf)
    return JMoEViT(**dims), MoEVisionTransformer(**dims, image_size=HW)


def _port_mlp(params, dim, hidden, E, k, cf):
    m = MoEMLP(dim, hidden, E, k, cf)
    with torch.no_grad():
        for n in ("router", "w1", "b1", "w2", "b2"):
            getattr(m, n).copy_(torch.from_numpy(np.array(params[n])))
    return m


def _check_mlps():
    for label, S, dim, hidden, E, k, cf in MLP_CASES:
        jm = JMoEMLP(dim=dim, hidden=hidden, num_experts=E, top_k=k,
                     capacity_factor=cf)
        x = jax.random.normal(jax.random.PRNGKey(4), (1, S, dim))
        v = quick_jit(jm.init)(jax.random.PRNGKey(5), x)
        want, inter = quick_jit(lambda v, x: jm.apply(
            v, x, mutable=["intermediates"]))(v, x)
        want = np.asarray(want)
        m = _port_mlp(v["params"], dim, hidden, E, k, cf)
        xt = torch.from_numpy(np.array(x))
        with torch.no_grad():
            got, gap = route_margin(m, lambda: m(xt))
        got = got.numpy()
        assert gap > TIE_MARGIN, (label, gap)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=label)
        dropped = np.abs(want[0]).sum(-1) == 0
        assert np.array_equal(np.abs(got[0]).sum(-1) == 0, dropped), label
        if label.endswith("drop"):
            assert 0 < dropped.sum() < S, (label, dropped.sum())
        assert abs(float(m.aux) - float(
            inter["intermediates"]["moe_aux"][0])) <= 1e-6, label
        p = {n: np.array(a) for n, a in v["params"].items()}
        if E == 1:
            ref = torch.nn.functional.gelu(
                xt[0] @ torch.from_numpy(p["w1"][0])
                + torch.from_numpy(p["b1"][0]), approximate="none")
            ref = ref @ torch.from_numpy(p["w2"][0]) + torch.from_numpy(
                p["b2"][0])
            np.testing.assert_allclose(got[0], ref.numpy(), rtol=1e-5,
                                       atol=1e-5)
        if label == "top2":
            # constant expert outputs of 1: each token's combine mass
            p["w2"] = np.zeros_like(p["w2"])
            p["b2"] = np.ones_like(p["b2"])
            with torch.no_grad():
                mass = _port_mlp(p, dim, hidden, E, k, cf)(xt).numpy()
            np.testing.assert_allclose(mass, np.ones_like(mass), rtol=1e-5,
                                       atol=1e-5)


def _check_tie():
    """Non-negative integer tokens (none all zero) and an integer router
    whose columns 1 and 3 are equal and above every other entry: every
    token's top two logits tie exactly, so it routes to expert 1 first
    (top-1) and to (1, 3) (top-2), in JAX too."""
    dim, hidden, E, S = 8, 16, 4, 24
    rs = np.random.RandomState(3)
    x = rs.randint(0, 3, (1, S, dim)).astype(np.float32)
    x[0, :, 0] = np.maximum(x[0, :, 0], 1)
    router = rs.randint(-2, 3, (dim, E)).astype(np.float32)
    router[:, 1] = router[:, 3] = rs.randint(3, 6, dim)
    for k in (1, 2):
        jm = JMoEMLP(dim=dim, hidden=hidden, num_experts=E, top_k=k,
                     capacity_factor=4.0)
        v = quick_jit(jm.init)(jax.random.PRNGKey(6), jnp.asarray(x))
        params = {n: np.array(a) for n, a in v["params"].items()}
        params["router"] = router
        want = np.asarray(quick_jit(jm.apply)({"params": params},
                                              jnp.asarray(x)))
        m = _port_mlp(params, dim, hidden, E, k, 4.0)
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
            _, idx, _, _ = m.route(torch.from_numpy(x[0]))
        logits = x[0] @ router
        tied = logits[:, 1] == logits[:, 3]
        assert tied.all()
        assert (idx[:, 0] == 1).all(), idx
        if k == 2:
            assert (idx[:, 1] == 3).all(), idx
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"tie k={k}")


def _init():
    """JAX's init of the small MoE ViT (the capacity factor shapes no
    parameter: one init serves every factor)."""
    return make_init_ordered(_small_moe()[0], (2, HW, HW, 3))(
        jax.random.PRNGKey(0))


def _check_vit_forwards(v):
    x = np.random.RandomState(1).rand(4, HW, HW, 3).astype(np.float32)
    for cf in (2.0, 0.5):
        jvit, pvit = _small_moe(cf)
        load_jax_variables(pvit, v)
        assert is_moe_model(pvit) and not isinstance(pvit,
                                                     VisionTransformer)
        want = quick_jit(lambda v, x: jvit.apply(v, x, train=False))(v, x)
        (wg, wc), wl = [np.asarray(a) for a in want[0]], np.asarray(want[1])
        with torch.no_grad():
            ((g, c), lg), gap = route_margin(
                pvit, lambda: pvit(torch.from_numpy(x)))
        assert gap > TIE_MARGIN, (cf, gap)
        for name, a, b in (("grid", g, wg), ("cls", c, wc),
                           ("logits", lg, wl)):
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"cf {cf} {name}")
        back = jax_variables(pvit, v)
        for path, a, b in walk_pairs(back, v):
            assert np.array_equal(a, b), path


def _check_teacher_step(v0):
    jvit, pvit = _small_moe(cf=1.0)
    rs = np.random.RandomState(7)
    batch = {"image": rs.rand(4, HW, HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (4,)).astype(np.int32)}
    lr = 0.05
    tx = j_make_sgd(lr, 0.9, 5e-4)
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=v0["params"],
                     batch_stats={}, opt_state=jax.jit(tx.init)(
                         v0["params"]), tx=tx, apply_fn=jvit.apply)
    jstep = quick_compiled(j_vanilla_step(augment_fn=None, donate=False))
    js, jm = jstep(js, {k: jnp.asarray(a) for k, a in batch.items()},
                   jax.random.PRNGKey(9))

    load_jax_variables(pvit, v0)
    ts = TrainState(model=pvit, optimizer=make_sgd(pvit.parameters(), 0.9,
                                                   5e-4),
                    schedule=lambda s: lr)
    images = torch.from_numpy(batch["image"])
    with torch.no_grad():
        _, gap = route_margin(pvit, lambda: pvit(images))
    assert gap > TIE_MARGIN, gap
    ts, tm = make_vanilla_train_step(None)(
        ts, {k: torch.from_numpy(a) for k, a in batch.items()},
        torch.Generator().manual_seed(9))
    assert pvit.moe_layers()[0].aux is not None
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
        float(jm["loss"]))
    got = jax_variables(ts.model, v0)["params"]
    want = jax.device_get(js.params)
    floor = group_floor(want, 1.0)
    for path, g, w in walk_pairs(got, want, "params"):
        assert_close_scaled(g, w, 1e-3, path, floor)
    upd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                 want, v0["params"])
    floor = group_floor(upd)
    init = {p: w for p, _, w in walk_pairs(v0["params"], v0["params"],
                                           "params")}
    n_router = 0
    for path, g, w in walk_pairs(got, upd, "params"):
        assert_close_scaled(np.asarray(g) - init[path], w, 2e-3,
                            path + " update", floor)
        if path.endswith("/moe/router"):
            # the gates carry the router's gradient: it moved
            assert np.abs(w).max() > 0
            n_router += 1
    assert n_router == 1


def test_moe_matches_jax():
    _check_mlps()
    _check_tie()
    v = _init()
    _check_vit_forwards(v)
    _check_teacher_step(v)
