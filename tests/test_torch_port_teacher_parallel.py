"""The model axis of a cross-arch run: the port's tensor-parallel (TP),
sequence-parallel (SP) and pipeline (PP) ViT teachers
(moma_tpu_torch/models/vit_tp.py, vit_pp.py) and the expert-parallel
(EP) MoE ViT teacher (models/vit_moe.py) against moma_tpu's
make_tp_vit_apply / make_pp_vit_apply / moe_place + clone(ep_mesh), and
the cross-arch MoMA step with each, against JAX's step on
tests/conftest.py's virtual CPU devices.

One spawn of 4 port ranks (moma_tpu_torch.core.mesh.spawn_ranks,
tests/torch_teacher_parallel_workers.py) runs every case, started in a
thread by the module fixture, shared by the module's tests (and by the
xdist workers, torch_port_helpers.run_once); a test computes its JAX
reference before it waits for the ranks:

  (i)   the forwards at --model_parallel 4 (a 1 x 4 grid) and 2 (2 x 2):
        TP and TP+SP on the JAX tests' small ViT (patch 8, dim 32, depth
        2, 4 heads; tests/test_vit_tp.py), PP with 1, 2 and 4 microbatches
        on its depth-4 twin (tests/test_vit_pp.py), 32^2 images, so 17
        tokens (padded under SP at MP 2 and 4), batch 8, against JAX's
        forwards on a (1 x MP) mesh at JAX's own tolerance (rtol 2e-5,
        atol 2e-6); each rank holds only its share of the block weights
        (by parameter count); a TP block runs exactly two all_reduces
        (SP: two reduce_scatters and two all_gathers, plus the epilogue's
        gather), the pipeline T + S - 2 hops and one broadcast; the
        gathered dense state dict equals the weights;
  (ii)  the weight slices of every model rank equal tp_convert's arrays
        (in the test process: tp_slices is pure);
  (iii) the cross-arch MoMA step (--bn global, MoCo, resnet8 student, the
        depth-4 ViT teacher, tests/test_torch_port_dist.py's batch, bank
        and permutation) with a TP teacher on (1 x 2), TP+SP on (2 x 2)
        and PP on (1 x 2) against JAX's step on the same mesh, its teacher
        placed by tp_place / pp_place and its bank sharded over 'model':
        losses to 1e-3, parameters and the EMA copy to 1e-3 of their
        group's scale, BN statistics and bank to 1e-3 of their own, the
        gradients through the SGD update to 5e-3 (as
        tests/test_torch_port_dist.py); the fixed teacher unchanged; every
        rank's state bit for bit;
  (iv)  run_moma with the TP teacher at --model_parallel 2, checkpointed
        after epoch 1, resumes at --model_parallel 1 and gives the
        straight 2-rank run's losses; the checkpoint holds the teacher
        whole;
  (vi)  the MoE ViT (JAX's test shapes: patch 8, dim 32, depth 2, 2 heads,
        4 experts; top-2 and capacity factor 0.5, so tokens drop) at
        --model_parallel 4 and 2: each rank's EP forward against JAX's
        moe_place + clone(ep_mesh) forward on a (1 x MP) mesh (rtol 2e-5,
        atol 2e-5, tests/test_vit_moe.py:117-136) and bit for bit against
        the one-rank forward; E/MP experts a rank; one model_all_reduce a
        MoE block; the gathered dense state dict equals the weights.  On
        the (2 x 2) grid, each data rank's half of the batch routed over
        both data ranks (--bn global, also at 2 accumulation microbatches
        and with the experts split) equals JAX's forward of the whole
        batch (of each microbatch), with one moe_all_gather a MoE block a
        forward, and routed per rank (--bn local) JAX's forward of the
        half; the step (iii) with the EP teacher on (1 x 2).

Plus (v) each new refusal's message against JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import ModelConfig as JModel
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.mesh import create_mesh as j_create_mesh
from moma_tpu.core.mesh import data_sharding, replicated_sharding
from moma_tpu.models import create_model as j_create_model
from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.models.vit_moe import MoEVisionTransformer as JMoEViT
from moma_tpu.models.vit_moe import check_ep_teacher as j_check_ep
from moma_tpu.models.vit_moe import moe_place
from moma_tpu.models.vit_pp import check_pp_teacher as j_check_pp
from moma_tpu.models.vit_pp import make_pp_vit_apply, pp_place
from moma_tpu.models.vit_tp import check_tp_teacher as j_check_tp
from moma_tpu.models.vit_tp import make_tp_vit_apply, tp_convert, tp_place
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core import config as port_config
from moma_tpu_torch.core.mesh import spawn_ranks
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.models.vit_moe import (MoEVisionTransformer,
                                           check_ep_teacher)
from moma_tpu_torch.models.vit_pp import check_pp_teacher
from moma_tpu_torch.models.vit_tp import check_tp_teacher, tp_slices
from moma_tpu_torch.moma.cmo import CMOHeads

import torch_teacher_parallel_workers as W
from torch_model_axis_workers import _cut_sets
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, quick_jit, route_margin,
                                run_once, run_once_in_thread, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORKER_TIMEOUT_S = 300
# tests/test_torch_port_dist.py's step, on another batch: with that file's
# (data seed 302) JAX's own cross-arch step differs by 2% of a conv
# kernel's update between 1 and 2 data devices (a ReLU input of
# BasicBlock_2 that train-mode BN over 8x8x8 values moves across 0 with the
# reduction order), so no port could match the (1 x 2) and the (2 x 2)
# meshes both; on this batch JAX's 1- and 2-device steps agree within
# 1.4e-4 of each tensor's scale, and every ReLU input of the student and of
# embed_s stays 5e-6 from 0 (asserted in _inputs)
DATA_SEED = 383
B, HW, N_CLS, S_DIM, FEAT, K = 8, 32, 10, 64, 32, 64
ALPHA, LR = 0.999, 0.1
PERM = np.array([5, 2, 7, 0, 3, 6, 1, 4], dtype=np.int64)
# the JAX tests' small ViTs: depth 2 for TP, 4 for PP and the steps
VITS = {"tp": dict(patch_size=8, dim=32, depth=2, num_heads=4),
        "pp": dict(patch_size=8, dim=32, depth=4, num_heads=4)}
FORWARD_CASES = [("tp", 0), ("sp", 0), ("pp", 1), ("pp", 2), ("pp", 4)]
FWD_RTOL, FWD_ATOL = 2e-5, 2e-6
# tests/test_vit_moe.py's small MoE ViT, top-2 at capacity factor 0.5
MOE = dict(patch_size=8, dim=32, depth=2, num_heads=2, num_experts=4,
           top_k=2, capacity_factor=0.5)
EP_RTOL, EP_ATOL = 2e-5, 2e-5
STEP_RTOL, GRAD_RTOL = 1e-3, 5e-3
RESUME_ARGV = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s",
               "resnet8", "--model_t", "vit_small_patch16_224", "--distill",
               "moma", "--head", "mlp", "--mem", "MoCo", "--image_size",
               "32", "--batch_size", "4", "--nce_k", "64", "--feat_dim",
               "16", "--fp32", "-b", "1", "--print_freq", "1"]


# ---------------------------------------------------------------- inputs

@pytest.fixture(scope="module")
def init():
    model = j_create_model("resnet8", num_classes=N_CLS)
    vs = make_init_ordered(model, (2, HW, HW, 3))(jax.random.PRNGKey(0))
    vits = {}
    for kind, dims in VITS.items():
        jvit = JViT(num_classes=N_CLS, **dims)
        vits[kind] = (jvit, make_init_ordered(jvit, (2, HW, HW, 3))(
            jax.random.PRNGKey(1)))
    jmoe = JMoEViT(num_classes=N_CLS, **MOE)
    moe = (jmoe, make_init_ordered(jmoe, (2, HW, HW, 3))(
        jax.random.PRNGKey(3)))
    jh = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=S_DIM,
                t_dim=VITS["pp"]["dim"], include_ema=True)
    p, bs = heads_init(jh, 2)
    rs = np.random.RandomState(DATA_SEED)
    images = rs.rand(B, HW, HW, 3).astype(np.float32)
    labels = rs.randint(0, N_CLS, (B,)).astype(np.int64)
    memory = rs.randn(K, FEAT).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=1, keepdims=True)
    x = np.random.RandomState(1).rand(B, HW, HW, 3).astype(np.float32)
    return {"model": model, "vs": vs, "vits": vits, "moe": moe,
            "heads": (jh, ordered_numpy({"params": p, "batch_stats": bs})),
            "images": images, "labels": labels, "memory": memory, "x": x}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_vit(init, kind):
    jvit, v = init["vits"][kind]
    vit = VisionTransformer(**VITS[kind], num_classes=N_CLS, image_size=HW)
    load_jax_variables(vit, v)
    return vit


def _port_moe(init):
    moe = MoEVisionTransformer(**MOE, num_classes=N_CLS, image_size=HW)
    load_jax_variables(moe, init["moe"][1])
    return moe


def _inputs(init):
    # every token the MoE routes (the forwards' images, the step's) is
    # 1e-4 from a tie in its router probabilities
    moe = _port_moe(init)
    for x in (init["x"], init["images"]):
        with torch.no_grad():
            _, gap = route_margin(moe, lambda: moe(_t(x)))
        assert gap > 1e-4, gap
    st = create_model("resnet8", N_CLS)
    load_jax_variables(st, init["vs"])
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=VITS["pp"]["dim"],
                  include_ema=True)
    load_jax_variables(ph, init["heads"][1])
    # resnet8 is a ReLU net: no ReLU input of the student or embed_s within
    # float rounding of 0, over each data row's rows and the whole batch
    st.train()
    ph.train()
    images = _t(init["images"])
    for rows in (slice(0, B // 2), slice(B // 2, B), slice(0, B)):
        with torch.no_grad(), ReluInputs() as kinks:
            feats, _ = st(images[rows])
            ph.embed_s(feats[-1])
        assert kinks.low > 5e-6, (rows, kinks.low)
    # the forwards above wrote BN running statistics: the weights again
    load_jax_variables(st, init["vs"])
    load_jax_variables(ph, init["heads"][1])
    return {"B": B, "HW": HW, "model": "resnet8", "n_cls": N_CLS,
            "feat": FEAT, "K": K, "alpha": ALPHA, "lr": LR, "s_dim": S_DIM,
            "weights": {"mlp": {"student": st.state_dict()}},
            "cross": {"vit": VITS["pp"],
                      "teacher": _port_vit(init, "pp").state_dict(),
                      "heads": ph.state_dict()},
            "vits": VITS,
            "vit_weights": {k: _port_vit(init, k).state_dict()
                            for k in VITS},
            "moe": MOE, "moe_weights": moe.state_dict(),
            "images": _t(init["images"]), "labels": _t(init["labels"]),
            "memory": _t(init["memory"]), "perm": _t(PERM),
            "x": _t(init["x"]), "forward_cases": FORWARD_CASES,
            "resume_argv": RESUME_ARGV}


@pytest.fixture(scope="module")
def ranks(init, tmp_path_factory):
    """get() -> (the ranks' inputs, every rank's results of every case):
    one spawn of 4 ranks for the module (and for the workers of a
    pytest-xdist run), started in a thread here."""
    inp = run_once("test_torch_port_teacher_parallel.inputs",
                   lambda: _inputs(init))

    def spawn():
        root = str(tmp_path_factory.mktemp("teacher_parallel"))
        path = os.path.join(root, "inputs.pt")
        torch.save({**inp, "root": root}, path)
        return spawn_ranks(W.teacher_parallel_cases, 4, (path,),
                           backend="gloo", timeout_s=WORKER_TIMEOUT_S)
    future = run_once_in_thread("test_torch_port_teacher_parallel.ranks",
                                spawn)
    return lambda: (inp, future.result())


# ------------------------------------------------------ (i) the forwards

def _jax_forward(init, route, mp, n_micro):
    jvit, v = init["vits"]["pp" if route == "pp" else "tp"]
    mesh = j_create_mesh(jax.devices()[:mp], model_parallel=mp)
    if route == "pp":
        params = pp_place(v["params"], jvit, mesh)
        apply = make_pp_vit_apply(jvit, mesh, n_micro=n_micro)
    else:
        params = tp_place(v["params"], jvit, mesh)
        apply = make_tp_vit_apply(jvit, mesh,
                                  sequence_parallel=route == "sp")
    fn = quick_jit(lambda p, x: apply({"params": p}, x, train=False))
    (grid, cls), logits = fn(params, jax.device_put(init["x"],
                                                   data_sharding(mesh)))
    return [np.asarray(a) for a in (grid, cls, logits)]


def _block_params(dims, mp, route):
    """The block parameters a rank holds: TP / SP 1/MP of each block's
    attention and MLP weights (with the biases of its heads and hidden
    units) and the LayerNorms and the two biases added after a reduction
    whole; PP depth/MP whole blocks."""
    C, depth = dims["dim"], dims["depth"]
    F = 4 * C
    whole = 3 * C * C + 3 * C + C * C + C + 2 * F * C + F + C + 4 * C
    if route == "pp":
        return depth // mp * whole
    return depth * ((3 * C * C + 3 * C + C * C + 2 * F * C + F) // mp
                    + C + C + 4 * C)


@pytest.mark.parametrize("route,n_micro", FORWARD_CASES)
def test_forward_matches_jax(init, ranks, route, n_micro):
    """(i) for one route at --model_parallel 4 and 2."""
    for mp in (4, 2):
        _check_forward(init, ranks, mp, route, n_micro)


def _check_forward(init, ranks, mp, route, n_micro):
    want = _jax_forward(init, route, mp, n_micro)
    inp, out = ranks()
    kind = "pp" if route == "pp" else "tp"
    depth = VITS[kind]["depth"]
    for r in range(mp):
        res = out[r]["forward"][(mp, route, n_micro)]
        for name, g, w in zip(("grid", "cls", "logits"),
                              (res["grid"], res["cls"], res["logits"]),
                              want):
            np.testing.assert_allclose(g.numpy(), w, rtol=FWD_RTOL,
                                       atol=FWD_ATOL,
                                       err_msg=f"rank {r} {name}")
        # this rank's share of the weights, and the dense model back whole
        assert res["block_params"] == _block_params(VITS[kind], mp, route)
        assert res["params"] - res["block_params"] == (
            res["dense_params"] - res["dense_block_params"])
        assert list(res["back"]) == list(inp["vit_weights"][kind])
        for k, v in inp["vit_weights"][kind].items():
            assert torch.equal(res["back"][k], v), k
        c = res["comm"]
        if route == "tp":
            want_comm = {"model_all_reduce": 2 * depth}
        elif route == "sp":
            want_comm = {"model_reduce_scatter": 2 * depth,
                         "model_all_gather": 2 * depth + 1}
        else:
            T = n_micro or mp
            want_comm = {"ppermute": T + mp - 2, "model_broadcast": 1}
        assert {k: v for k, v in c.items() if not k.endswith("_bytes")} == (
            want_comm), c
    if route == "sp":
        # the token shards: 17 tokens padded to a multiple of MP
        n_pad = -(-17 // mp) * mp
        assert out[0]["forward"][(mp, route, n_micro)]["comm"][
            "model_reduce_scatter_bytes"] == 2 * depth * B * n_pad * 32 * 4


# ------------------------------------------------- (ii) the weight slices

def test_weight_slices_equal_tp_convert(init):
    """Model rank m of MP (2 and 4) holds tp_convert's arrays of heads
    [m*H/MP, (m+1)*H/MP) and hidden units [m*F/MP, (m+1)*F/MP), exactly
    (tests/test_vit_tp.py::test_tp_convert_roundtrip_values); the rest
    whole."""
    jvit, v = init["vits"]["tp"]
    tp = jax.device_get(tp_convert(v["params"], jvit.num_heads))
    dense = _port_vit(init, "tp").state_dict()
    for mp in (2, 4):
        _check_slices(jvit, tp, dense, mp)


def _check_slices(jvit, tp, dense, mp):
    C, H = jvit.dim, jvit.num_heads
    hm, hd, F = H // mp, C // H, 4 * C
    fm = F // mp
    for m in range(mp):
        own = tp_slices(dense, m, mp)
        heads, hid = slice(m * hm, (m + 1) * hm), slice(m * fm, (m + 1) * fm)
        for i in range(jvit.depth):
            b, j = f"blocks.{i}.", tp[f"Block_{i}"]
            a = j["attn"]
            qkv = own[b + "attn.qkv.weight"].numpy().reshape(3, hm, hd, C)
            qkv_b = own[b + "attn.qkv.bias"].numpy().reshape(3, hm, hd)
            for n, name in enumerate("qkv"):
                np.testing.assert_array_equal(
                    qkv[n].transpose(2, 0, 1), a[f"{name}_kernel"][:, heads])
                np.testing.assert_array_equal(qkv_b[n],
                                              a[f"{name}_bias"][heads])
            np.testing.assert_array_equal(
                own[b + "attn.proj.weight"].numpy().T.reshape(hm, hd, C),
                a["proj_kernel"][heads])
            np.testing.assert_array_equal(own[b + "attn.proj.bias"].numpy(),
                                          a["proj_bias"])
            np.testing.assert_array_equal(own[b + "fc1.weight"].numpy().T,
                                          j["Dense_0"]["kernel"][:, hid])
            np.testing.assert_array_equal(own[b + "fc1.bias"].numpy(),
                                          j["Dense_0"]["bias"][hid])
            np.testing.assert_array_equal(own[b + "fc2.weight"].numpy().T,
                                          j["Dense_1"]["kernel"][hid])
            np.testing.assert_array_equal(own[b + "fc2.bias"].numpy(),
                                          j["Dense_1"]["bias"])
            for ln, jn in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
                np.testing.assert_array_equal(own[f"{b}{ln}.weight"].numpy(),
                                              j[jn]["scale"])
        for k, t in own.items():
            if not k.startswith("blocks."):
                assert torch.equal(t, dense[k]), k


# ----------------------------------------------------- (iii) the steps

def _jax_cross_step(init, route, data_rows, n_micro=None):
    """(state before, state after, metrics) of JAX's cross-arch step
    (--bn global) on a (data_rows x 2) mesh, the teacher placed by route
    and the bank sharded over 'model'."""
    model, vs = init["model"], init["vs"]
    jvit, vt = init["vits"]["pp"]
    jh, hv = init["heads"]
    mesh = j_create_mesh(jax.devices()[:2 * data_rows], model_parallel=2)
    if route == "ep":
        jmoe, vm = init["moe"]
        t_params = moe_place(vm["params"], mesh)
        apply = jmoe.clone(ep_mesh=mesh).apply
    elif route == "pp":
        t_params = pp_place(vt["params"], jvit, mesh)
        apply = make_pp_vit_apply(jvit, mesh, n_micro=n_micro)
    else:
        t_params = tp_place(vt["params"], jvit, mesh)
        apply = make_tp_vit_apply(jvit, mesh,
                                  sequence_parallel=route == "sp")
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
    state = jax.device_put(JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=None, teacher_batch_stats={},
        queue=JQueue(memory={}, ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, ema_params=vs["params"],
        ema_batch_stats=vs["batch_stats"], apply_fn=model.apply,
        teacher_apply_fn=apply), replicated_sharding(mesh))
    state = state.replace(
        teacher_params=t_params,
        queue=state.queue.replace(memory={"memory": jax.device_put(
            init["memory"], NamedSharding(mesh, P("model", None)))}))
    step = quick_compiled(j_make_step(cfg, jh, augment_fn=None, donate=False,
                                      mesh=mesh, cross_arch=True))
    batch = {"image": jax.device_put(init["images"], data_sharding(mesh)),
             "label": jax.device_put(init["labels"].astype(np.int32),
                                     data_sharding(mesh, ndim=1)),
             "shuffle_perm": jnp.asarray(PERM.astype(np.int32))}
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return state, jax.device_get(new), {k: float(v) for k, v in
                                        metrics.items()}


def _close_tree(got, want, rtol, tag, frac=1e-3):
    """Each tensor to `rtol` of its own scale, with a floor at `frac` of
    the group's largest entry (1.0: parameters to rtol of the group's
    scale)."""
    want = jax.device_get(want)
    floor = group_floor(want, frac)
    for path, g, w in walk_pairs(got, want, tag):
        assert_close_scaled(g, w, rtol, path, floor)


def _updates(after, before):
    return jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        / LR, after, before)


# case -> (grid's data rows, ranks of the world that ran it)
STEP_CASES = {"tp": (1, (0, 1)), "sp": (2, (0, 1, 2, 3)), "pp": (1, (2, 3)),
              "ep": (1, (2, 3))}


@pytest.mark.parametrize("route", list(STEP_CASES))
def test_cross_arch_step_matches_jax(init, ranks, route):
    data_rows, who = STEP_CASES[route]
    j0, j1, jm = _jax_cross_step(init, route, data_rows)
    inp, out = ranks()
    res = [out[r]["cross"][route] for r in who]
    got = res[0]
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        assert abs(got["metrics"][k] - jm[k]) <= STEP_RTOL * abs(
            jm[k]) + 1e-6, (k, got["metrics"][k], jm[k])
    assert got["queue_ptr"] == int(jm["queue_ptr"]) == B
    vs = init["vs"]
    hv = init["heads"][1]
    st, ema = (create_model("resnet8", N_CLS) for _ in range(2))
    st.load_state_dict(got["student"])
    ema.load_state_dict(got["ema"])
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=VITS["pp"]["dim"],
                  include_ema=True)
    ph.load_state_dict(got["heads"])
    s, e, cmo = (jax_variables(m, t) for m, t in (
        (st, vs), (ema, vs), (ph, hv)))
    # parameters to 1e-3 of their group's scale, their updates (the
    # averaged gradients) to GRAD_RTOL of each tensor's own
    _close_tree(s["params"], j1.params["student"], STEP_RTOL, "student",
                1.0)
    _close_tree(cmo["params"], j1.params["cmo"], STEP_RTOL, "cmo", 1.0)
    _close_tree(_updates(s["params"], vs["params"]),
                _updates(j1.params["student"], j0.params["student"]),
                GRAD_RTOL, "student_grad")
    for name in ("embed_s", "atts_q"):
        _close_tree(_updates(cmo["params"][name], hv["params"][name]),
                    _updates(j1.params["cmo"][name], j0.params["cmo"][name]),
                    GRAD_RTOL, name)
    _close_tree(e["params"], j1.ema_params, STEP_RTOL, "ema", 1.0)
    _close_tree(s["batch_stats"], j1.batch_stats["student"], STEP_RTOL,
                "student_bs")
    _close_tree(e["batch_stats"], j1.ema_batch_stats, STEP_RTOL, "ema_bs")
    assert_close_scaled(got["queue"]["memory"].numpy(),
                        np.asarray(j1.queue.memory["memory"]), STEP_RTOL,
                        "queue")
    # the fixed teacher, gathered whole: untouched
    teacher = (inp["moe_weights"] if route == "ep"
               else inp["cross"]["teacher"])
    assert list(got["teacher"]) == list(teacher)
    for k, v in teacher.items():
        assert torch.equal(got["teacher"][k], v), k
    # every rank's replica bit for bit
    for r, other in zip(who[1:], res[1:]):
        assert other["metrics"] == got["metrics"], (route, r)
        for part in ("student", "heads", "ema", "teacher", "queue"):
            for k in got[part]:
                assert torch.equal(other[part][k], got[part][k]), (
                    route, r, part, k)
    if route == "sp":
        # the (2 x 2) grid: rank r is data r // 2, model r % 2
        assert [o["grid"] for o in out] == [(0, 2, 0, 2), (0, 2, 1, 2),
                                            (1, 2, 0, 2), (1, 2, 1, 2)]


# ------------------------------------------------- (iv) resume at MP = 1

def test_tp_checkpoint_resumes_at_mp1(ranks, monkeypatch):
    """A run_moma at --model_parallel 2 with the TP teacher, checkpointed
    after epoch 1, resumed in one process at --model_parallel 1: the
    checkpoint holds the whole ViT, and epoch 2's losses are the straight
    2-rank run's."""
    import json

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train import moma as moma_train

    _, out = ranks()
    res = out[0]["resume"]
    saved = torch.load(os.path.join(res["run_dir"], "ckpt", "latest.pt"),
                       weights_only=True)
    whole = create_model("vit_small_patch16_224", 4, image_size=32)
    assert {k: v.shape for k, v in saved["teacher"].items()} == {
        k: v.shape for k, v in whole.state_dict().items()}
    monkeypatch.setattr(moma_train, "build_datasets",
                        moma_train.build_datasets)
    _cut_sets(moma_train)
    cfg = parse_student_args(RESUME_ARGV + [
        "--save_dir", os.path.dirname(res["run_dir"]), "--epochs", "2",
        "--resume"])
    _, result = moma_train.run_moma(cfg, synthetic=True)
    assert [r["epoch"] for r in result["epochs"]] == [2]
    with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
        resumed = [(r["step"], r["loss"]) for r in map(json.loads, f)]
    straight = res["straight"]
    assert [s for s, _ in resumed] == [s for s, _ in straight]
    np.testing.assert_allclose([v for _, v in resumed],
                               [v for _, v in straight], rtol=1e-5)


# ------------------------------------------- (vi) the expert axis, MoE

# JAX's whole MoE forward, compiled once a batch size
_MOE_WHOLE = {}


def _moe_jax(init, x, mp=1):
    """JAX's MoE forward of x: on a (1 x mp) mesh with its experts placed
    by moe_place (mp > 1), else whole in one program."""
    jmoe, v = init["moe"]
    if mp == 1:
        if len(x) not in _MOE_WHOLE:
            _MOE_WHOLE[len(x)] = quick_jit(
                lambda v, x: jmoe.apply(v, x, train=False))
        out = _MOE_WHOLE[len(x)](v, x)
    else:
        mesh = j_create_mesh(jax.devices()[:mp], model_parallel=mp)
        ep = jmoe.clone(ep_mesh=mesh)
        out = quick_jit(lambda p, x: ep.apply({"params": p}, x,
                                              train=False))(
            moe_place(v["params"], mesh),
            jax.device_put(x, data_sharding(mesh)))
    (grid, cls), logits = out
    return {"grid": np.asarray(grid), "cls": np.asarray(cls),
            "logits": np.asarray(logits)}


def _moe_close(got, want, what):
    for k in ("grid", "cls", "logits"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=EP_RTOL,
                                   atol=EP_ATOL, err_msg=f"{what} {k}")


def test_expert_parallel_matches_jax(init, ranks):
    """(vi): the EP forwards at --model_parallel 4 and 2, and the routing
    scope over 2 data ranks."""
    x = init["x"]
    n_moe, E = MOE["depth"] // 2, MOE["num_experts"]
    C, F = MOE["dim"], 4 * MOE["dim"]
    whole = n_moe * E * (2 * C * F + F + C) * 4
    want = {mp: _moe_jax(init, x, mp) for mp in (4, 2)}
    inp, out = ranks()
    for mp in (4, 2):
        for r in range(mp):
            res = out[r]["forward"][(mp, "ep", 0)]
            _moe_close(res, want[mp], f"mp {mp} rank {r}")
            for k in ("grid", "cls", "logits"):
                assert torch.equal(res[k], res["one_rank"][k]), (mp, r, k)
            assert res["experts"] == [E // mp] * n_moe
            assert res["expert_bytes"] == (whole // mp, whole)
            assert res["comm"] == {
                "model_all_reduce": n_moe,
                "model_all_reduce_bytes": n_moe * B * 17 * C * 4}, res["comm"]
            assert list(res["back"]) == list(inp["moe_weights"])
            for k, v in inp["moe_weights"].items():
                assert torch.equal(res["back"][k], v), k
    # the (2 x 2) grid: rank g is data rank g // 2 of 2, 4 rows each
    whole_batch = _moe_jax(init, x)
    halves = [_moe_jax(init, x[i:i + 4]) for i in (0, 4)]
    # the scope decides which tokens drop: the halves routed alone differ
    for d in (0, 1):
        assert not np.allclose(halves[d]["grid"],
                               whole_batch["grid"][4 * d:4 * d + 4],
                               rtol=EP_RTOL, atol=EP_ATOL)
    for g in range(4):
        d = g // 2
        res = out[g]["moe_scope"]
        rows = slice(4 * d, 4 * d + 4)
        for case in ("global", "global_ep"):
            _moe_close(res[case], {k: v[rows] for k, v in
                                   whole_batch.items()}, f"{case} rank {g}")
        # microbatch i is global rows [4i, 4i + 4), data rank d's 2 of them
        micro = [{k: v[2 * d:2 * d + 2] for k, v in h.items()}
                 for h in halves]
        _moe_close(res["global_accum2"],
                   {k: np.concatenate([m[k] for m in micro])
                    for k in micro[0]}, f"global_accum2 rank {g}")
        _moe_close(res["local"], halves[d], f"local rank {g}")
        counts = {c: {k: v for k, v in res[c]["comm"].items()
                      if not k.endswith("_bytes")} for c in res}
        assert counts == {
            "global": {"moe_all_gather": n_moe},
            "global_accum2": {"moe_all_gather": 2 * n_moe},
            "global_ep": {"moe_all_gather": n_moe,
                          "model_all_reduce": n_moe},
            "local": {}}, counts


# ------------------------------------------------------- (v) refusals

def _cfg(*extra):
    return port_config.parse_student_args(
        [a for a in RESUME_ARGV if a not in ("--device", "cpu")]
        + ["--model_parallel", "2"] + list(extra))


def _jvit(depth=4, heads=4, dim=32):
    return JViT(patch_size=8, dim=dim, depth=depth, num_heads=heads,
                num_classes=N_CLS)


def _vit(depth=4, heads=4, dim=32):
    return VisionTransformer(8, dim, depth, heads, N_CLS, HW)


# (port flags, port teacher, JAX's raise) -> the same ValueError text
def _jax_pp(model, *a, **k):
    return lambda: j_check_pp(
        model, j_create_mesh(jax.devices()[:2], model_parallel=2), *a, **k)


def _jax_tp(model, quant="none"):
    return lambda: j_check_tp(
        model, j_create_mesh(jax.devices()[:2], model_parallel=2), quant)


def _jax_ep(model, quant="none"):
    return lambda: j_check_ep(
        model, j_create_mesh(jax.devices()[:2], model_parallel=2), quant)


def _moe(num_experts=4):
    return MoEVisionTransformer(**{**MOE, "num_experts": num_experts},
                                num_classes=N_CLS, image_size=HW)


def _jmoe(num_experts=4):
    return JMoEViT(**{**MOE, "num_experts": num_experts}, num_classes=N_CLS)


REFUSALS = {
    "tp_heads": ([], lambda: _vit(heads=3, dim=36),
                 _jax_tp(_jvit(heads=3, dim=36))),
    "pp_depth": (["--teacher_parallel", "pipeline"], lambda: _vit(depth=3),
                 _jax_pp(_jvit(depth=3), 2)),
    "pp_accum_microbatch": (
        ["--teacher_parallel", "pipeline", "--pp_microbatch", "3",
         "--batch_size", "8", "--grad_accum", "2"], _vit,
        _jax_pp(_jvit(), 3, batch_size=4)),
    "pp_micro_below_1": (["--teacher_parallel", "pipeline",
                          "--pp_microbatch", "-1"], _vit,
                         _jax_pp(_jvit(), -1)),
    "ep_not_moe": (["--teacher_parallel", "expert"], _vit,
                   _jax_ep(_jvit())),
    "ep_experts": (["--teacher_parallel", "expert"], lambda: _moe(3),
                   _jax_ep(_jmoe(3))),
}
LITERAL = {
    "sp_pipeline": (["--teacher_parallel", "pipeline",
                     "--sequence_parallel"], _vit,
                    "--sequence_parallel applies to the TENSOR-parallel "
                    "teacher; --teacher_parallel pipeline stages whole "
                    "blocks (nothing to token-shard between them)"),
    "sp_expert": (["--teacher_parallel", "expert", "--sequence_parallel"],
                  _vit, "--sequence_parallel applies to the TENSOR-parallel"
                  " teacher; --teacher_parallel expert shards the MoE "
                  "expert axis instead"),
    "pp_not_vit": (["--teacher_parallel", "pipeline"],
                   lambda: create_model("resnet32", N_CLS),
                   "--teacher_parallel pipeline requires a ViT family "
                   "teacher, got ResNetCifar"),
    "sp_not_vit": (["--sequence_parallel"],
                   lambda: create_model("resnet32", N_CLS),
                   "--sequence_parallel requires a tensor-parallel ViT "
                   "teacher, got ResNetCifar"),
    "pp_moe": (["--teacher_parallel", "pipeline"], _moe,
               "--teacher_parallel pipeline requires a ViT family "
               "teacher, got MoEVisionTransformer"),
    "sp_moe": (["--sequence_parallel"], _moe,
               "--sequence_parallel requires a tensor-parallel ViT "
               "teacher, got MoEVisionTransformer"),
}


def test_refusals_carry_the_jax_messages():
    """check_model_axis with the teacher (as build_state calls it) raises
    JAX's ValueError for each case: the text of JAX's check_tp_teacher /
    check_pp_teacher / check_ep_teacher for the same teacher and mesh, or
    run_moma's own (moma_tpu/train/moma.py:1346-1417)."""
    for name in list(REFUSALS) + list(LITERAL):
        if name in REFUSALS:
            extra, teacher, jax_raise = REFUSALS[name]
            with pytest.raises(ValueError) as want:
                jax_raise()
            want = str(want.value)
        else:
            extra, teacher, want = LITERAL[name]
        with pytest.raises(ValueError) as got:
            port_config.check_model_axis(_cfg(*extra), True, teacher(), 1)
        assert str(got.value) == want, name


def test_check_functions_carry_the_jax_messages():
    """check_tp_teacher / check_pp_teacher called directly: a non-ViT and
    --teacher_quant, which check_slice refuses by name before them."""
    mesh = j_create_mesh(jax.devices()[:2], model_parallel=2)
    resnet, j_resnet = (create_model("resnet8", N_CLS),
                        j_create_model("resnet8", num_classes=N_CLS))
    for port_fn, jax_fn in (
            (lambda: check_tp_teacher(resnet, 2),
             lambda: j_check_tp(j_resnet, mesh)),
            (lambda: check_tp_teacher(_vit(), 2, "int8"),
             lambda: j_check_tp(_jvit(), mesh, "int8")),
            (lambda: check_pp_teacher(resnet, 2, 1, 1),
             lambda: j_check_pp(j_resnet, mesh, 1)),
            (lambda: check_pp_teacher(_vit(), 2, 1, 1, teacher_quant="int8"),
             lambda: j_check_pp(_jvit(), mesh, 1, teacher_quant="int8"))):
        with pytest.raises(ValueError) as want:
            jax_fn()
        with pytest.raises(ValueError) as got:
            port_fn()
        assert str(got.value) == str(want.value)
    # check_ep_teacher's --teacher_quant message (check_slice refuses
    # --teacher_quant by name before check_model_axis sees it)
    with pytest.raises(ValueError) as want:
        _jax_ep(_jmoe(), "int8")()
    with pytest.raises(ValueError) as got:
        check_ep_teacher(_moe(), 2, "int8")
    assert str(got.value) == str(want.value)
    assert _cfg("--model_t", "vit_tiny_moe_patch16_224").model_t.name == (
        "vit_tiny_moe_patch16_224")
    with pytest.raises(NotImplementedError, match=r"\[6\]"):
        _cfg("--teacher_quant", "int8")
    # the routes JAX takes are accepted: TP (+SP), PP, EP, a whole teacher
    # (a MoE ViT under --teacher_parallel tensor too)
    for extra, teacher in ((["--sequence_parallel"], _vit),
                           (["--teacher_parallel", "pipeline"], _vit),
                           (["--teacher_parallel", "expert"], _moe),
                           ([], lambda: create_model("resnet32", N_CLS)),
                           ([], _moe),
                           (["--grad_accum", "2", "--batch_size", "8"],
                            _vit)):
        port_config.check_model_axis(_cfg(*extra), True, teacher(), 1)
    # a MoE teacher at --model_parallel 2 stays whole on every model rank
    # under --teacher_parallel tensor (JAX: is_tp_model is False for it)
    from moma_tpu_torch.train.moma import parallel_teacher

    moe = _moe()
    assert parallel_teacher(_cfg(), moe) is moe
