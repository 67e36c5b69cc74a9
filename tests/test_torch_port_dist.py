"""Data-parallel MoMA: the port's 2-rank steps against moma_tpu's 2-device
steps on the CPU.

The JAX package runs its `bn='local' | 'sync' | 'global'` steps on two of
tests/conftest.py's virtual CPU devices; the port runs two gloo processes
(moma_tpu_torch.core.mesh.spawn_ranks, the `spawn` start method, a hard
timeout), each on its half of the batch.  resnet8 at 32^2, global batch 8,
K=64, feat_dim 32, float32, the permutation PERM of
tests/test_moma_local_bn.py (it moves rows across the rank boundary), the
teacher's KL forward on running statistics, SGD without momentum at lr 0.1,
the same weights (moma_tpu_torch.interop) and queue.  One spawn runs every
port mode from the same initial state (tests/torch_dist_workers.py).

Compared, per mode, rank 0 against JAX: the losses, the student and CMO
head updates ((after - before) / lr: the averaged gradients), the EMA
teacher and key head, the queue rows and pointer, the student's and the
teacher's BN running statistics (averaged over the ranks under 'local');
and rank 1 against rank 0 (the replicas stay equal).  Tolerances are
those tests/test_moma_local_bn.py holds the JAX package's 2-device step
to against the reference's 2-rank run: losses 2e-4 (loss_div 2e-3), the
gradients 5e-3, EMA parameters 1e-4, BN statistics 1e-3, the queue 1e-4;
each relative, with a floor at 1e-3 of the group's largest entry
(torch_port_helpers.assert_close_scaled).

Cross-arch (EmaTec) MoMA, --bn global: resnet8 student, a small ViT
teacher (patch 8, dim 32, depth 2, 2 heads) on the 32^2 batch, the EMA
copy starting at the student's weights, against JAX's cross-arch step on 2
devices, at the same tolerances (the EMA copy, the EMA key head and the
fixed teacher at EMA_RTOL); rank 1 equal to rank 0 bit for bit.

Also: the Shuffle-BN permutation moves loss_kd under 'local' and not under
'global'; `sync` gives `global`'s losses to 1e-3; the 2-rank
'local' step (with an augmentation drawn from each rank's stream) equals
the port's one-process --grad_accum 2 step; a sync FusedBatchNorm on 2
ranks equals one process on the concatenated batch (y, running mean and
variance, dx, dscale and dbias to 1e-5); the 2-rank vanilla step equals
the one-process step on the global batch, with and without --grad_accum 2;
and a SIGTERM to one rank of a
2-rank run_teacher stops and checkpoints both, with no hang.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import ModelConfig as JModel
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.mesh import create_mesh, data_sharding
from moma_tpu.models import create_model as j_create_model
from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core.mesh import spawn_ranks
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.moma.cmo import CMOHeads

import torch_dist_workers as W
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled,
                                group_floor, heads_init, make_init_ordered,
                                ordered_numpy, quick_compiled, run_once,
                                run_once_in_thread, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS, S_DIM, FEAT, K = 8, 32, 10, 64, 32, 64
ALPHA, LR = 0.999, 0.1
PERM = np.array([5, 2, 7, 0, 3, 6, 1, 4], dtype=np.int64)
IDENT = np.arange(B)
WORKER_TIMEOUT_S = 240
# the tolerances of tests/test_moma_local_bn.py
LOSS_RTOL, DIV_RTOL, GRAD_RTOL, EMA_RTOL, BN_RTOL, QUEUE_RTOL = (
    2e-4, 2e-3, 5e-3, 1e-4, 1e-3, 1e-4)
# port mode -> (bn, head, perm, augment); JAX oracle of each by name
MODES = {
    "local": ("local", "mlp", PERM, False),
    "sync": ("sync", "mlp", PERM, False),
    "global_byol": ("global", "mlp_byol", PERM, False),
    "sync_byol": ("sync", "mlp_byol", PERM, False),
    "local_ident": ("local", "mlp", IDENT, False),
    "global_ident": ("global", "mlp", IDENT, False),
    "global": ("global", "mlp", PERM, False),
    "local_aug": ("local", "mlp", PERM, True),
}
VIT = dict(patch_size=8, dim=32, depth=2, num_heads=2)
JAX_OF = {"local": ("local", "mlp"), "sync": ("sync", "mlp"),
          "global_byol": ("global", "mlp_byol"),
          "sync_byol": ("sync", "mlp_byol")}


@pytest.fixture(scope="module")
def init():
    model = j_create_model("resnet8", num_classes=N_CLS)
    init_fn = make_init_ordered(model, (2, HW, HW, 3))
    vs, vt = init_fn(jax.random.PRNGKey(0)), init_fn(jax.random.PRNGKey(1))
    heads = {}
    for head in ("mlp", "mlp_byol"):
        jh = JHeads(head=head, attn="self", feat_dim=FEAT, s_dim=S_DIM,
                    t_dim=S_DIM)
        p, bs = heads_init(jh, 2)
        heads[head] = (jh, ordered_numpy({"params": p, "batch_stats": bs}))
    # cross-arch: the small ViT teacher and the heads with the EMA key head
    jvit = JViT(num_classes=N_CLS, **VIT)
    vt_x = make_init_ordered(jvit, (2, HW, HW, 3))(jax.random.PRNGKey(1))
    jh = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=S_DIM,
                t_dim=VIT["dim"], include_ema=True)
    p, bs = heads_init(jh, 2)
    heads["cross"] = (jh, ordered_numpy({"params": p, "batch_stats": bs}))
    rs = np.random.RandomState(302)   # see _check_kinks
    images = rs.rand(B, HW, HW, 3).astype(np.float32)
    labels = rs.randint(0, N_CLS, (B,)).astype(np.int64)
    memory = rs.randn(K, FEAT).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=1, keepdims=True)
    return model, vs, vt, heads, images, labels, memory, (jvit, vt_x)


def _port_weights(init):
    _, vs, vt, heads, *_ = init
    out = {}
    for head, (_, hv) in heads.items():
        if head == "cross":
            continue
        st, te = create_model("resnet8", N_CLS), create_model("resnet8",
                                                              N_CLS)
        ph = CMOHeads(head, "self", FEAT, s_dim=S_DIM, t_dim=S_DIM)
        load_jax_variables(st, vs)
        load_jax_variables(te, vt)
        load_jax_variables(ph, hv)
        out[head] = {"student": st.state_dict(), "teacher": te.state_dict(),
                     "heads": ph.state_dict()}
    return out


def _cross_weights(init):
    """The port's cross-arch teacher and heads from the JAX variables."""
    _, _, _, heads, *_, (_, vt_x) = init
    vit = VisionTransformer(**VIT, num_classes=N_CLS, image_size=HW)
    load_jax_variables(vit, vt_x)
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=VIT["dim"],
                  include_ema=True)
    load_jax_variables(ph, heads["cross"][1])
    return {"vit": VIT, "teacher": vit.state_dict(),
            "heads": ph.state_dict()}


def _inputs(init):
    *_, images, labels, memory, _ = init
    rs = np.random.RandomState(11)
    return {"B": B, "HW": HW, "model": "resnet8", "n_cls": N_CLS,
            "feat": FEAT, "cross": _cross_weights(init),
            "K": K, "alpha": ALPHA, "lr": LR, "s_dim": S_DIM,
            "weights": _port_weights(init),
            "images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels),
            "memory": torch.from_numpy(memory),
            "modes": {k: (bn, head, torch.from_numpy(perm), aug)
                      for k, (bn, head, perm, aug) in MODES.items()},
            "bn_x": torch.from_numpy(
                rs.randn(8, 6, 5, 5).astype(np.float32) * 2 + 0.5),
            "bn_w": torch.from_numpy(rs.randn(8, 6, 5, 5).astype(np.float32))}


def _check_kinks(inp):
    """resnet8 is a ReLU net: a ReLU input within float rounding of 0 can
    fall on the other side in the other package and move the gradients
    before it by a percent (README, "ReLU nets and parity").  The batch
    (data seed 302) keeps every ReLU input of the student and the
    embed_s heads, over each rank's rows and the global batch, 5e-6 away
    from 0, as tests/test_torch_port_cifar.py's resnet8 batch does."""
    for head in ("mlp", "mlp_byol"):
        st = W.moma_state(inp, head)
        st.student.train()
        st.heads.train()
        for rows in (slice(0, B // 2), slice(B // 2, B), slice(0, B)):
            with torch.no_grad(), ReluInputs() as kinks:
                feats, _ = st.student(inp["images"][rows])
                st.heads.embed_s(feats[-1])
            assert kinks.low > 5e-6, (head, rows, kinks.low)
    # cross-arch: the EMA copy is the student at the step's start, its
    # key head embed_ema
    st, _ = W.cross_state(inp)
    st.student.train()
    st.heads.train()
    for rows in (slice(0, B // 2), slice(B // 2, B), slice(0, B)):
        with torch.no_grad(), ReluInputs() as kinks:
            feats, _ = st.student(inp["images"][rows])
            st.heads.embed_s(feats[-1])
            st.heads.embed_ema(feats[-1])
        assert kinks.low > 5e-6, ("cross", rows, kinks.low)


def _checked_inputs(init):
    inp = _inputs(init)
    _check_kinks(inp)
    return inp


@pytest.fixture(scope="module")
def ranks(init, tmp_path_factory):
    """get() -> (the ranks' inputs, both ranks' results of every mode):
    one spawn for the module (and for the workers of a pytest-xdist run),
    started in a thread here, so that a test computes its JAX reference
    before it waits."""
    # a worker that loads the results builds no inputs either
    inp = run_once("test_torch_port_dist.inputs",
                   lambda: _checked_inputs(init))

    def spawn():
        path = str(tmp_path_factory.mktemp("dist") / "inputs.pt")
        torch.save(inp, path)
        return spawn_ranks(W.moma_modes, 2, (path,), backend="gloo",
                           timeout_s=WORKER_TIMEOUT_S)
    future = run_once_in_thread("test_torch_port_dist.ranks", spawn)
    return lambda: (inp, future.result())


def _jax_step(init, bn, head, perm=PERM):
    """(state before, state after, metrics) of JAX's 2-device step."""
    model, vs, vt, heads, images, labels, memory, _ = init
    jh, hv = heads[head]
    mesh = create_mesh(jax.devices()[:2])
    cfg = JConfig()
    cfg.data.dataset = "synthetic"
    cfg.data.batch_size = B
    cfg.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0,
                           kd_T=4.0)
    cfg.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                     mem="MoCo", head=head, attn="self", shuffle_bn=True,
                     kl_teacher_bn="eval")
    cfg.model_s = JModel(name="resnet8", n_cls=N_CLS)
    cfg.model_t = JModel(name="resnet8", n_cls=N_CLS)
    cfg.run.bn = bn
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "cmo": hv["params"]}
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        queue=JQueue(memory={"memory": jnp.asarray(memory)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, apply_fn=model.apply,
        teacher_apply_fn=model.apply)
    step = quick_compiled(j_make_step(cfg, jh, augment_fn=None,
                                      donate=False, mesh=mesh))
    batch = {"image": jax.device_put(images, data_sharding(mesh)),
             "label": jax.device_put(labels.astype(np.int32),
                                     data_sharding(mesh, ndim=1)),
             "shuffle_perm": jnp.asarray(perm.astype(np.int32))}
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return state, jax.device_get(new), {k: float(v) for k, v in
                                        metrics.items()}


def _port_trees(init, res, head):
    """A rank's result as JAX trees (student, teacher, cmo variables)."""
    _, vs, vt, heads, *_ = init
    st, te = create_model("resnet8", N_CLS), create_model("resnet8", N_CLS)
    ph = CMOHeads(head, "self", FEAT, s_dim=S_DIM, t_dim=S_DIM)
    st.load_state_dict(res["student"])
    te.load_state_dict(res["teacher"])
    ph.load_state_dict(res["heads"])
    return (jax_variables(st, vs), jax_variables(te, vt),
            jax_variables(ph, heads[head][1]))


def _close_tree(got, want, rtol, tag):
    want = jax.device_get(want)
    floor = group_floor(want)
    for path, g, w in walk_pairs(got, want, tag):
        assert_close_scaled(g, w, rtol, path, floor)


def _updates(after, before):
    return jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        / LR, after, before)


@pytest.mark.parametrize("mode", ["local", "sync", "global_byol",
                                  "sync_byol"])
def test_two_rank_step_matches_jax_two_devices(init, ranks, mode):
    bn, head = JAX_OF[mode]
    j0, j1, jm = _jax_step(init, bn, head)
    _, out = ranks()
    res = out[0][mode]
    for k in ("loss", "loss_cls", "loss_kd", "loss_div", "acc1"):
        tol = DIV_RTOL if k == "loss_div" else LOSS_RTOL
        assert abs(res["metrics"][k] - jm[k]) <= tol * abs(jm[k]) + 1e-6, (
            k, res["metrics"][k], jm[k])
    assert res["queue_ptr"] == int(jm["queue_ptr"]) == B

    s, t, cmo = _port_trees(init, res, JAX_OF[mode][1])
    _, vs, vt, heads, *_ = init
    hv = heads[JAX_OF[mode][1]][1]
    # the averaged gradients, through the SGD update
    _close_tree(_updates(s["params"], vs["params"]),
                _updates(j1.params["student"], j0.params["student"]),
                GRAD_RTOL, "student_grad")
    for name in ("embed_s", "atts_q"):
        _close_tree(_updates(cmo["params"][name], hv["params"][name]),
                    _updates(j1.params["cmo"][name], j0.params["cmo"][name]),
                    GRAD_RTOL, name)
    # EMA: teacher and the key head
    _close_tree(t["params"], j1.teacher_params, EMA_RTOL, "teacher")
    _close_tree(cmo["params"]["embed_t"], j1.params["cmo"]["embed_t"],
                EMA_RTOL, "embed_t")
    # running statistics (rank means under 'local')
    _close_tree(s["batch_stats"], j1.batch_stats["student"], BN_RTOL,
                "student_bs")
    _close_tree(t["batch_stats"], j1.teacher_batch_stats, BN_RTOL,
                "teacher_bs")
    if head == "mlp_byol":
        _close_tree(cmo["batch_stats"]["embed_s"],
                    j1.batch_stats["cmo"]["embed_s"], BN_RTOL, "embed_s_bs")
    assert_close_scaled(res["queue"]["memory"].numpy(),
                        np.asarray(j1.queue.memory["memory"]), QUEUE_RTOL,
                        "queue")


def test_replicas_stay_equal(ranks):
    """Rank 1 ends every mode with rank 0's state, bit for bit."""
    _, out = ranks()
    for mode in list(MODES) + ["cross"]:
        a, b = out[0][mode], out[1][mode]
        assert a["metrics"] == b["metrics"], mode
        parts = ["student", "teacher", "heads", "queue"]
        if mode == "cross":
            parts.append("ema")
        for part in parts:
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), (mode, part, k)


def _jax_cross_step(init):
    """(state before, state after, metrics) of JAX's cross-arch step
    (--bn global) on 2 devices."""
    model, vs, vt, heads, images, labels, memory, (jvit, vt_x) = init
    jh, hv = heads["cross"]
    mesh = create_mesh(jax.devices()[:2])
    cfg = JConfig()
    cfg.data.dataset = "synthetic"
    cfg.data.batch_size = B
    cfg.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0,
                           kd_T=4.0)
    cfg.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                     mem="MoCo", head="mlp", attn="self", shuffle_bn=True,
                     kl_teacher_bn="eval")
    cfg.model_s = JModel(name="resnet8", n_cls=N_CLS)
    cfg.model_t = JModel(name="vit_tiny_patch16_224", n_cls=N_CLS)
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "cmo": hv["params"]}
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=vt_x["params"],
        teacher_batch_stats=vt_x.get("batch_stats", {}),
        queue=JQueue(memory={"memory": jnp.asarray(memory)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, ema_params=vs["params"],
        ema_batch_stats=vs["batch_stats"], apply_fn=model.apply,
        teacher_apply_fn=jvit.apply)
    step = quick_compiled(j_make_step(cfg, jh, augment_fn=None, donate=False,
                                      mesh=mesh, cross_arch=True))
    batch = {"image": jax.device_put(images, data_sharding(mesh)),
             "label": jax.device_put(labels.astype(np.int32),
                                     data_sharding(mesh, ndim=1)),
             "shuffle_perm": jnp.asarray(PERM.astype(np.int32))}
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return state, jax.device_get(new), {k: float(v) for k, v in
                                        metrics.items()}


def test_cross_arch_two_rank_step_matches_jax_two_devices(init, ranks):
    """Cross-arch (EmaTec) MoMA on 2 ranks, --bn global, against JAX's
    cross-arch step on 2 devices: the losses, the student's and the CMO
    heads' updates (the averaged gradients), the EMA copy and its BN
    statistics, the EMA key head, the fixed teacher unchanged, the queue."""
    j0, j1, jm = _jax_cross_step(init)
    _, out = ranks()
    res = out[0]["cross"]
    for k in ("loss", "loss_cls", "loss_kd", "loss_div", "acc1"):
        tol = DIV_RTOL if k == "loss_div" else LOSS_RTOL
        assert abs(res["metrics"][k] - jm[k]) <= tol * abs(jm[k]) + 1e-6, (
            k, res["metrics"][k], jm[k])
    assert res["queue_ptr"] == int(jm["queue_ptr"]) == B
    _, vs, _, heads, *_, (_, vt_x) = init
    hv = heads["cross"][1]
    st, ema = (create_model("resnet8", N_CLS) for _ in range(2))
    st.load_state_dict(res["student"])
    ema.load_state_dict(res["ema"])
    vit = VisionTransformer(**VIT, num_classes=N_CLS, image_size=HW)
    vit.load_state_dict(res["teacher"])
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=VIT["dim"],
                  include_ema=True)
    ph.load_state_dict(res["heads"])
    s, e, cmo = (jax_variables(m, t) for m, t in (
        (st, vs), (ema, vs), (ph, hv)))
    _close_tree(_updates(s["params"], vs["params"]),
                _updates(j1.params["student"], j0.params["student"]),
                GRAD_RTOL, "student_grad")
    for name in ("embed_s", "atts_q"):
        _close_tree(_updates(cmo["params"][name], hv["params"][name]),
                    _updates(j1.params["cmo"][name], j0.params["cmo"][name]),
                    GRAD_RTOL, name)
    _close_tree(e["params"], j1.ema_params, EMA_RTOL, "ema")
    _close_tree(cmo["params"]["embed_ema"], j1.params["cmo"]["embed_ema"],
                EMA_RTOL, "embed_ema")
    _close_tree(s["batch_stats"], j1.batch_stats["student"], BN_RTOL,
                "student_bs")
    _close_tree(e["batch_stats"], j1.ema_batch_stats, BN_RTOL, "ema_bs")
    # the fixed teacher: untouched on both sides
    for path, g, w in walk_pairs(jax_variables(vit, vt_x), vt_x):
        np.testing.assert_array_equal(g, w, err_msg=path)
    for path, g, w in walk_pairs(jax.device_get(j1.teacher_params),
                                 vt_x["params"]):
        np.testing.assert_array_equal(g, w, err_msg=path)
    assert_close_scaled(res["queue"]["memory"].numpy(),
                        np.asarray(j1.queue.memory["memory"]), QUEUE_RTOL,
                        "queue")


def test_sync_equals_global(ranks):
    """'sync' (per-rank batch-token attention, sync statistics) reproduces
    the global step's losses to 1e-3
    (tests/test_moma_local_bn.py::test_sync_equals_global)."""
    _, out = ranks()
    s, g = out[0]["sync"], out[0]["global"]
    for k in ("loss", "loss_kd"):
        np.testing.assert_allclose(s["metrics"][k], g["metrics"][k],
                                   rtol=1e-3)


def test_local_bn_shuffle_matters(ranks):
    """Per-rank BN: the permutation moves the keys and loss_kd; global
    statistics: it cannot."""
    _, out = ranks()
    r = out[0]
    assert abs(r["local"]["metrics"]["loss_kd"]
               - r["local_ident"]["metrics"]["loss_kd"]) > 1e-6
    np.testing.assert_allclose(r["global"]["metrics"]["loss_kd"],
                               r["global_ident"]["metrics"]["loss_kd"],
                               rtol=1e-6)


def test_local_step_equals_the_accumulated_step(ranks):
    """The 2-rank 'local' step (each rank augmenting from its own stream)
    equals --grad_accum 2 in one process: microbatch i is rank i."""
    from moma_tpu_torch.train.moma import make_moma_train_step

    inp, out = ranks()
    state = W.moma_state(inp, "mlp")
    step = make_moma_train_step(W.moma_config("global", "mlp", inp,
                                              grad_accum=2), W.noise_augment)
    state, m = step(state,
                    W.rank_batch(inp, 0, 1, inp["modes"]["local_aug"][2]),
                    torch.Generator().manual_seed(7))
    got, want = W.moma_result(state, m), out[0]["local_aug"]
    for k in W.MOMA_KEYS:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= 2e-5 * abs(
            want["metrics"][k]) + 1e-6, k
    for part in ("student", "teacher", "heads", "queue"):
        for k, w in want[part].items():
            assert_close_scaled(got[part][k].numpy(), w.numpy(), 2e-4,
                                f"{part}/{k}", 1e-6)


def test_sync_batchnorm_equals_one_process(ranks):
    """Sync statistics on 2 ranks against the concatenated batch: y, the
    running statistics, dx, and the ranks' dscale / dbias summed."""
    from moma_tpu_torch.ops.fused_bn import FusedBatchNorm

    inp, out = ranks()
    x = inp["bn_x"].clone().requires_grad_(True)
    bn = FusedBatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    y = bn(x)
    (y * inp["bn_w"]).sum().backward()
    r0, r1 = out[0]["sync_bn"], out[1]["sync_bn"]
    want = {"y": y.detach(), "dx": x.grad,
            "dscale": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}
    got = {"y": torch.cat([r0["y"], r1["y"]]),
           "dx": torch.cat([r0["dx"], r1["dx"]]),
           "dscale": r0["dscale"] + r1["dscale"],
           "dbias": r0["dbias"] + r1["dbias"],
           "running_mean": r0["running_mean"],
           "running_var": r0["running_var"]}
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{k}: {m}")
    assert torch.equal(r0["running_var"], r1["running_var"])


def test_two_rank_vanilla_step_equals_one_process(ranks):
    """The supervised step on 2 ranks (sync statistics, averaged gradients)
    is the one-process step on the global batch."""
    inp, out = ranks()
    want = W.vanilla(0, 1, inp)
    for k, v in want["metrics"].items():
        assert abs(out[0]["vanilla"]["metrics"][k] - v) <= 1e-5 * abs(v) + \
            1e-5, k
    for k, w in want["model"].items():
        assert_close_scaled(out[0]["vanilla"]["model"][k].numpy(), w.numpy(),
                            1e-4, k, 1e-6)


def test_two_rank_vanilla_accum_step_equals_one_process(ranks):
    """--grad_accum 2 on 2 ranks: each rank's microbatch i is its share of
    the global batch's i-th half (mesh.rank_rows, the Loader's split), so
    the step is the one-process grad_accum 2 step (JAX's contiguous
    microbatches), BN statistics of each microbatch synced over both
    ranks."""
    from moma_tpu_torch.core.mesh import rank_rows

    rows = np.arange(8)
    assert rank_rows(rows, 0, 2, 2).tolist() == [0, 1, 4, 5]
    assert rank_rows(rows, 1, 2, 2).tolist() == [2, 3, 6, 7]
    assert rank_rows(rows, 1, 2).tolist() == [4, 5, 6, 7]
    inp, out = ranks()
    want = W.vanilla(0, 1, inp, grad_accum=2)
    for r in (0, 1):
        got = out[r]["vanilla_accum"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v) + 1e-5, k
        for k, w in want["model"].items():
            assert_close_scaled(got["model"][k].numpy(), w.numpy(), 1e-4, k,
                                1e-6)


def test_sigterm_to_one_rank_stops_and_checkpoints_both(tmp_path):
    """run_teacher on 2 ranks: rank 1 gets SIGTERM after its third step;
    both ranks stop at the same step, rank 0 writes the preemption save,
    and nobody waits forever in a collective."""
    argv = ["--dataset", "synthetic", "--model", "resnet8", "--image_size",
            "32", "--batch_size", "8", "--epochs", "2", "--fp32",
            "--device", "cpu", "--save_dir", str(tmp_path), "--print_freq",
            "1000"]
    path = str(tmp_path / "inputs.pt")
    torch.save({"argv": argv}, path)
    a, b = spawn_ranks(W.preempted_teacher, 2, (path,), backend="gloo",
                       timeout_s=WORKER_TIMEOUT_S)
    assert a["preempted"] and b["preempted"]
    assert a["steps"] == b["steps"] and 3 <= a["steps"] <= 5
    assert a["step"] == b["step"] == a["steps"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    ckpt = os.path.join(a["run_dir"], "ckpt")
    with open(os.path.join(ckpt, "latest.meta.json")) as f:
        meta = json.load(f)
    assert meta["preempted"] and meta["resume_step"] == a["steps"]
    saved = torch.load(os.path.join(ckpt, "latest.pt"), weights_only=True)
    assert saved["step"] == a["step"]
