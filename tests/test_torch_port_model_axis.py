"""The model axis (--model_parallel): the port's split negative bank, its
ring attention and the whole MoMA step on a (data, model) grid of gloo
ranks, against moma_tpu's shard_map programs on tests/conftest.py's
virtual CPU devices.

One spawn of 4 port ranks (moma_tpu_torch.core.mesh.spawn_ranks,
tests/torch_model_axis_workers.py) runs every case, shared by the module's
tests (and by the xdist workers, torch_port_helpers.run_once):

  (i)   ring_batch_token_attention at MP=4 (a 1 x 4 grid) and MP=2 (2 x 2),
        Nb=6 and Nb=0, K=64, C=16, H=4 (tests/test_ring_attention.py),
        against JAX's ring under shard_map and dense attention: the forward
        to rtol 2e-5 / atol 2e-6, every gradient to 5e-4 / 1e-5, under JAX's
        in-body convention (out_loc consumed through all_gather +
        _grad_div);
  (ii)  the split-bank steps at MP=2 against JAX's replicated ones:
        step_moco, _st, _sstt with and without q_t, and _att for 'all',
        'dual', 'self' (ring, and the all-gather route), 'qk', 'dual2'; the
        logits, dq (and dq_t) of sum(logits * w), the ranks' new bank rows
        joined, and the pointer, across the bank's wrap (ptr K-4, 8 keys);
        on the ring modes no tensor any rank makes holds the bank's K rows;
  (iii) the MoMA step on the 2 x 2 grid against JAX's make_moma_train_step
        on create_mesh(jax.devices()[:4], model_parallel=2): --bn local,
        sync, global with MoCo, MoCoST (local), MoCoSSTT (sync) and MoCoAtt
        'all' (local, global); resnet8 at 32^2, batch 8, K=64, the weights
        and batch of tests/test_torch_port_dist.py, the tolerances of
        tests/test_moma_local_bn_mp*.py (losses 2e-4 / 1e-5, parameters,
        statistics and bank 2e-4, scaled) and the gradients through the SGD
        update at 5e-3 as in tests/test_torch_port_dist.py; every rank's
        replicas equal bit for bit;
  (iv)  a 2-rank (1 x 2) run_moma with MoCoAtt 'all': --resume equals the
        straight run bit for bit, and its checkpoint (the whole bank)
        resumes at --model_parallel 1;
  (v)   the 2-rank --bn global --grad_accum 2 step against JAX's
        accumulated step on 2 devices and the port's one-process step.

Plus (vi) the JAX package's ValueErrors and the grid size, and
(vii) [5b-accum]: --grad_accum 2 over the split bank, MoCo on the
(2 x 2) grid and MoCoSSTT and MoCoAtt 'all' (the ring) on a (1 x 2) one,
against JAX's accumulated step with the bank sharded over 'model' on the
same mesh, at (iii)'s tolerances; every rank's replica bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import ModelConfig as JModel
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.mesh import create_mesh as j_create_mesh
from moma_tpu.core.mesh import data_sharding, shard_map_compat
from moma_tpu.models import create_model as j_create_model
from moma_tpu.moma import queue as JQ
from moma_tpu.moma.cmo import BatchTokenAttention as JAttention
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.ops.ring_attention import ring_batch_token_attention as j_ring
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core import config as port_config
from moma_tpu_torch.core.mesh import spawn_ranks
from moma_tpu_torch.interop import (bank_join, bank_shard, jax_variables,
                                    load_jax_variables)
from moma_tpu_torch.models import create_model
from moma_tpu_torch.moma.cmo import CMOHeads

import torch_dist_workers as DW
import torch_model_axis_workers as W
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, run_once,
                                run_once_in_thread, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORKER_TIMEOUT_S = 300
# (i) tests/test_ring_attention.py's shapes
NB, KTOT, C, H = 6, 64, 16, 4
# (ii) a bank wider than every non-token dimension (3D = 96 < K)
BB, BD, BK, BPTR = 8, 32, 128, 124
T = 0.15
BANK_CASES = {
    "moco": ("moco", None, True), "st": ("st", None, True),
    "sstt": ("sstt", None, True), "sstt_noqt": ("sstt_noqt", None, True),
    "att_all": ("att", "all", True), "att_dual": ("att", "dual", True),
    "att_self": ("att", "self", True), "att_qk": ("att", "qk", True),
    "att_dual2": ("att", "dual2", True),
    "att_all_gather": ("att", "all", False),
    "att_dual_gather": ("att", "dual", False),
    "att_self_gather": ("att", "self", False),
}
RING_MODES = ("att_all", "att_dual", "att_self")
# (iii) / (v) tests/test_torch_port_dist.py's step
B, HW, N_CLS, S_DIM, FEAT, K = 8, 32, 10, 64, 32, 64
ALPHA, LR = 0.999, 0.1
PERM = np.array([5, 2, 7, 0, 3, 6, 1, 4], dtype=np.int64)
STEP_CASES = {
    "local_moco": {"bn": "local", "mem": "MoCo", "attn": "self"},
    "sync_moco": {"bn": "sync", "mem": "MoCo", "attn": "self"},
    "global_moco": {"bn": "global", "mem": "MoCo", "attn": "self"},
    "local_st": {"bn": "local", "mem": "MoCoST", "attn": "self"},
    "sync_sstt": {"bn": "sync", "mem": "MoCoSSTT", "attn": "self"},
    "local_att": {"bn": "local", "mem": "MoCoAtt", "attn": "all"},
    "global_att": {"bn": "global", "mem": "MoCoAtt", "attn": "all"},
}
# (vii) [5b-accum]: name -> ((data rows, model ranks), case)
ACCUM_MP_CASES = {
    "moco": ((2, 2), {"mem": "MoCo", "attn": "self"}),
    "sstt": ((1, 2), {"mem": "MoCoSSTT", "attn": "self"}),
    "att_all": ((1, 2), {"mem": "MoCoAtt", "attn": "all"}),
}
LOSS_RTOL, LOSS_ATOL, PARAM_RTOL, GRAD_RTOL, EMA_RTOL = (2e-4, 1e-5, 2e-4,
                                                          5e-3, 1e-4)
RESUME_ARGV = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s",
               "resnet8", "--model_t", "resnet8", "--distill", "moma",
               "--head", "mlp", "--mem", "MoCoAtt", "--attn", "all",
               "--image_size", "32", "--batch_size", "4", "--nce_k", "64",
               "--feat_dim", "16", "--fp32", "-b", "1", "--print_freq", "1"]


# ---------------------------------------------------------------- inputs

def _ring_inputs():
    rs = np.random.RandomState(0)
    mod = JAttention(C, num_heads=H, qkv_bias=True)
    x_all = rs.randn(NB + KTOT, C).astype(np.float32)
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x_all))["params"]
    kern = tuple(np.asarray(a) for a in (
        p["TorchLinear_0"]["kernel"], p["TorchLinear_0"]["bias"],
        p["TorchLinear_1"]["kernel"], p["TorchLinear_1"]["bias"]))
    return {"NB": NB, "H": H, "x_all": x_all, "kern": kern,
            "w_rep": np.random.RandomState(7).randn(NB, C).astype(np.float32),
            "w_loc": np.random.RandomState(8).randn(KTOT, C).astype(
                np.float32), "mod": mod, "params": p}


def _unit(rs, n, d):
    x = rs.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bank_inputs():
    rs = np.random.RandomState(21)
    out = {"T": T, "D": BD, "ptr": BPTR,
           "q": _unit(rs, BB, BD), "q_t": _unit(rs, BB, BD),
           "k": _unit(rs, BB, BD), "k_t": _unit(rs, BB, BD),
           "all_k": _unit(rs, BB, BD), "all_k_t": _unit(rs, BB, BD),
           "bank": {n: _unit(rs, BK, BD)
                    for n in ("memory", "memory_s", "memory_t")},
           "w": [rs.randn(BB, 1 + BK).astype(np.float32) for _ in range(4)]}
    heads = {}
    for mode in ("all", "dual", "self", "qk", "dual2"):
        jh = JHeads(head="mlp", attn=mode, feat_dim=BD, s_dim=BD, t_dim=BD)
        p, bs = heads_init(jh, 5)
        heads[mode] = (jh, ordered_numpy({"params": p, "batch_stats": bs}))
    return out, heads


@pytest.fixture(scope="module")
def init():
    model = j_create_model("resnet8", num_classes=N_CLS)
    init_fn = make_init_ordered(model, (2, HW, HW, 3))
    vs, vt = init_fn(jax.random.PRNGKey(0)), init_fn(jax.random.PRNGKey(1))
    heads = {}
    for attn in ("self", "all"):
        jh = JHeads(head="mlp", attn=attn, feat_dim=FEAT, s_dim=S_DIM,
                    t_dim=S_DIM)
        p, bs = heads_init(jh, 2)
        heads[attn] = (jh, ordered_numpy({"params": p, "batch_stats": bs}))
    rs = np.random.RandomState(302)   # tests/test_torch_port_dist.py's
    images = rs.rand(B, HW, HW, 3).astype(np.float32)
    labels = rs.randint(0, N_CLS, (B,)).astype(np.int64)
    memory = rs.randn(K, FEAT).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=1, keepdims=True)
    bank, bank_heads = _bank_inputs()
    return {"model": model, "vs": vs, "vt": vt, "heads": heads,
            "images": images, "labels": labels, "memory": memory,
            "ring": _ring_inputs(), "bank": bank, "bank_heads": bank_heads}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_step_inputs(init):
    st, te = (create_model("resnet8", N_CLS) for _ in range(2))
    load_jax_variables(st, init["vs"])
    load_jax_variables(te, init["vt"])
    heads = {}
    for attn, (_, hv) in init["heads"].items():
        ph = CMOHeads("mlp", attn, FEAT, s_dim=S_DIM, t_dim=S_DIM)
        load_jax_variables(ph, hv)
        heads[attn] = ph.state_dict()
    return {"B": B, "model": "resnet8", "n_cls": N_CLS, "feat": FEAT,
            "K": K, "alpha": ALPHA, "lr": LR, "s_dim": S_DIM,
            "weights": {"mlp": {"student": st.state_dict(),
                                "teacher": te.state_dict(),
                                "heads": heads["self"]}},
            "step_heads": heads, "images": _t(init["images"]),
            "labels": _t(init["labels"]), "memory": _t(init["memory"]),
            "perm": _t(PERM)}


def _check_kinks(inp):
    """The student's and embed_s's ReLU inputs stay 5e-6 from 0 over each
    data row's rows and the global batch (README, "ReLU nets and
    parity"); the same batch as tests/test_torch_port_dist.py."""
    st = DW.moma_state(inp, "mlp")
    st.student.train()
    st.heads.train()
    for rows in (slice(0, B // 2), slice(B // 2, B), slice(0, B)):
        with torch.no_grad(), ReluInputs() as kinks:
            feats, _ = st.student(inp["images"][rows])
            st.heads.embed_s(feats[-1])
        assert kinks.low > 5e-6, (rows, kinks.low)


def _inputs(init):
    r, b = init["ring"], init["bank"]
    att = {}
    for mode, (_, hv) in init["bank_heads"].items():
        ph = CMOHeads("mlp", mode, BD, s_dim=BD, t_dim=BD)
        load_jax_variables(ph, hv)
        att[mode] = ph.state_dict()
    step_in = _port_step_inputs(init)
    _check_kinks(step_in)
    return {
        "ring": {"NB": NB, "H": H, "x_all": _t(r["x_all"]),
                 "kern": [_t(a) for a in r["kern"]],
                 "w_rep": _t(r["w_rep"]), "w_loc": _t(r["w_loc"])},
        "bank_in": {**{k: (_t(v) if isinstance(v, np.ndarray) else v)
                       for k, v in b.items() if k not in ("bank", "w")},
                    "bank": {n: _t(v) for n, v in b["bank"].items()},
                    "w": [_t(w) for w in b["w"]], "att_weights": att},
        "bank_cases": BANK_CASES, "step_in": step_in,
        "step_cases": STEP_CASES, "accum_mp_cases": ACCUM_MP_CASES,
        "resume_argv": RESUME_ARGV}


@pytest.fixture(scope="module")
def ranks(init, tmp_path_factory):
    """get() -> (the ranks' inputs, every rank's results of every case):
    one spawn of 4 ranks for the module (and for the workers of a
    pytest-xdist run), started in a thread here.  A test asks for them
    after its JAX reference, which it computes while the ranks run."""
    # a worker that loads the results builds no inputs either
    inp = run_once("test_torch_port_model_axis.inputs",
                   lambda: _inputs(init))

    def spawn():
        root = str(tmp_path_factory.mktemp("model_axis"))
        path = os.path.join(root, "inputs.pt")
        torch.save({**inp, "root": root}, path)
        return spawn_ranks(W.model_axis_cases, 4, (path,),
                           backend="gloo", timeout_s=WORKER_TIMEOUT_S)
    future = run_once_in_thread("test_torch_port_model_axis.ranks", spawn)
    return lambda: (inp, future.result())


# ------------------------------------------------------------- (i) ring

def _jax_ring(init, mp, nb):
    """(out_rep, out_loc, grads of x_rep, x_loc, the four kernels) of JAX's
    ring under shard_map on mp devices, and the same of dense attention."""
    r = init["ring"]
    x_all = jnp.asarray(r["x_all"])
    kern = tuple(jnp.asarray(a) for a in r["kern"])
    x_rep, x_loc = x_all[:NB][:nb], x_all[NB:]
    w_rep, w_loc = jnp.asarray(r["w_rep"][:nb]), jnp.asarray(r["w_loc"])
    mesh = Mesh(np.array(jax.devices()[:mp]), ("model",))

    def body(x_rep, x_loc, w_loc_sh, *kern):
        def loss_fn(x_rep, x_loc, *kern):
            out_rep, out_loc = j_ring(x_rep, x_loc, *kern, H, "model")
            gathered = jax.lax.all_gather(JQ._grad_div(out_loc, "model"),
                                          "model", axis=0, tiled=True)
            w_full = jax.lax.all_gather(w_loc_sh, "model", axis=0,
                                        tiled=True)
            return (jnp.sum(out_rep * w_rep) + jnp.sum(gathered * w_full),
                    (out_rep, out_loc))

        grads, outs = jax.grad(loss_fn, argnums=tuple(range(6)),
                               has_aux=True)(x_rep, x_loc, *kern)
        return outs, grads

    fn = shard_map_compat(
        body, mesh,
        in_specs=(P(), P("model", None), P("model", None)) + (P(),) * 4,
        out_specs=((P(), P("model", None)),
                   (P(), P("model", None)) + (P(),) * 4))
    (o_rep, o_loc), grads = jax.jit(fn)(x_rep, x_loc, w_loc, *kern)

    mod, p = r["mod"], r["params"]

    def dense_loss(x_rep, x_loc, qk, qb, pk, pb):
        p2 = {"TorchLinear_0": {"kernel": qk, "bias": qb},
              "TorchLinear_1": {"kernel": pk, "bias": pb}}
        out = mod.apply({"params": p2}, jnp.concatenate([x_rep, x_loc], 0))
        return jnp.sum(out[:nb] * w_rep) + jnp.sum(out[nb:] * w_loc), out

    d_grads, d_out = jax.grad(dense_loss, argnums=tuple(range(6)),
                              has_aux=True)(x_rep, x_loc, *kern)
    return ((np.asarray(o_rep), np.asarray(o_loc), [np.asarray(g)
                                                     for g in grads]),
            (np.asarray(d_out[:nb]), np.asarray(d_out[nb:]),
             [np.asarray(g) for g in d_grads]))


@pytest.mark.parametrize("mp,nb", [(4, NB), (4, 0), (2, NB), (2, 0)])
def test_ring_matches_jax_ring_and_dense(init, ranks, mp, nb):
    wants = _jax_ring(init, mp, nb)
    _, out = ranks()
    got = [out[r]["ring"][(mp, nb)] for r in range(mp)]
    g_rep = got[0]["out_rep"].numpy()
    g_loc = bank_join([g["out_loc"].numpy() for g in got])
    g_grads = [got[0]["grads"][0].numpy(),
               bank_join([g["grads"][1].numpy() for g in got])] + [
        t.numpy() for t in got[0]["grads"][2:]]
    names = ("x_rep", "x_loc", "qkv_kernel", "qkv_bias", "proj_kernel",
             "proj_bias")
    for want in wants:
        w_rep, w_loc, w_grads = want
        np.testing.assert_allclose(g_rep, w_rep, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(g_loc, w_loc, rtol=2e-5, atol=2e-6)
        for name, g, w in zip(names, g_grads, w_grads):
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5,
                                       err_msg=name)
    # every model rank holds the same full parameter gradients
    for g in got[1:]:
        for a, b in zip(g["grads"][2:], got[0]["grads"][2:]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    # the 2 x 2 grid's second data row runs the same ring
    if mp == 2:
        for r in (2, 3):
            np.testing.assert_array_equal(out[r]["ring"][(mp, nb)][
                "out_loc"].numpy(), got[r - 2]["out_loc"].numpy())


def test_ring_never_holds_the_whole_bank(ranks):
    """No tensor a rank makes in the ring's forward or backward has the
    bank's K token rows (at most Nb + K/MP), as
    tests/test_ring_attention.py::test_ring_never_materializes_full_bank
    pins for JAX's program."""
    _, out = ranks()
    for (mp, nb), res in out[0]["ring"].items():
        assert res["rows"] < KTOT, (mp, nb, res["rows"])


# ------------------------------------------------------- (ii) the bank

def _jax_bank(init, name):
    fn, mode, _ = BANK_CASES[name]
    b = init["bank"]
    q, q_t = jnp.asarray(b["q"]), jnp.asarray(b["q_t"])
    k, k_t = jnp.asarray(b["k"]), jnp.asarray(b["k_t"])
    all_k, all_k_t = jnp.asarray(b["all_k"]), jnp.asarray(b["all_k_t"])
    ptr = jnp.asarray(BPTR, jnp.int32)
    ws = [jnp.asarray(w) for w in b["w"]]

    def state(*names):
        return JQ.QueueState(memory={n: jnp.asarray(b["bank"][n])
                                     for n in names}, ptr=ptr)

    def run(q, q_t):
        if fn == "moco":
            lg, new = JQ.step_moco(state("memory"), q, k, all_k, T)
            lgs = [lg]
        elif fn == "st":
            *lgs, new = JQ.step_moco_st(state("memory_s", "memory_t"), q, k,
                                        k_t, all_k, all_k_t, T)
        elif fn in ("sstt", "sstt_noqt"):
            *lgs, new = JQ.step_moco_sstt(
                state("memory_s", "memory_t"), q, k,
                q_t if fn == "sstt" else None, k_t, all_k, all_k_t, T)
        else:
            jh, hv = init["bank_heads"][mode]
            lg, new = JQ.step_moco_att(state("memory"), q, k, all_k, T, mode,
                                       jh.attn_fns(hv["params"]))
            lgs = [lg]
        loss = sum(jnp.sum(lg * w[:, :lg.shape[1]]) for lg, w in zip(lgs, ws))
        return loss, (lgs, new)

    (dq, dq_t), (lgs, new) = jax.grad(run, argnums=(0, 1), has_aux=True)(
        q, q_t)
    return ([np.asarray(lg) for lg in lgs], np.asarray(dq), np.asarray(dq_t),
            {n: np.asarray(v) for n, v in new.memory.items()}, int(new.ptr))


@pytest.mark.parametrize("name", list(BANK_CASES))
def test_split_bank_step_matches_jax(init, ranks, name):
    w_logits, w_dq, w_dq_t, w_bank, w_ptr = _jax_bank(init, name)
    _, out = ranks()
    got = [out[r]["bank"][name] for r in range(4)]
    atol = 1e-5 if BANK_CASES[name][0] == "att" else 1e-6
    assert len(got[0]["logits"]) == len(w_logits)
    for g, w in zip(got[0]["logits"], w_logits):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=atol)
    np.testing.assert_allclose(got[0]["dq"].numpy(), w_dq, rtol=5e-4,
                               atol=atol)
    np.testing.assert_allclose(got[0]["dq_t"].numpy(), w_dq_t, rtol=5e-4,
                               atol=atol)
    for n, w in w_bank.items():
        joined = bank_join([g["bank"][n].numpy() for g in got[:2]])
        np.testing.assert_array_equal(joined, w)
        np.testing.assert_array_equal(bank_shard(w, 1, 2),
                                      got[3]["bank"][n].numpy())
    assert got[0]["ptr"] == got[1]["ptr"] == w_ptr == (BPTR + BB) % BK
    # the model ranks' full logits and dq agree
    for g in got[1:]:
        for a, b in zip(g["logits"], got[0]["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)
    if name in RING_MODES:
        # the bank's K rows never meet on one rank (2B + K/MP at most)
        assert max(g["rows"] for g in got) < BK, [g["rows"] for g in got]
    elif name.endswith("_gather"):
        # the all-gather route does hold them, and the watch sees it
        assert min(g["rows"] for g in got) >= BK


# ----------------------------------------------------- (iii) the step

def _jax_state(init, mem, attn, mesh=None):
    model, vs, vt = init["model"], init["vs"], init["vt"]
    jh, hv = init["heads"][attn]
    names = (("memory_s", "memory_t") if mem in ("MoCoST", "MoCoSSTT")
             else ("memory",))
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "cmo": hv["params"]}
    memory = {n: jnp.asarray(init["memory"]) for n in names}
    if mesh is not None:
        memory = {n: jax.device_put(v, NamedSharding(mesh, P("model", None)))
                  for n, v in memory.items()}
    return JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        queue=JQ.QueueState(memory=memory, ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, apply_fn=model.apply,
        teacher_apply_fn=model.apply), jh


def _jax_cfg(bn, mem, attn, grad_accum=1):
    cfg = JConfig()
    cfg.data.dataset = "synthetic"
    cfg.data.batch_size = B
    cfg.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0,
                           kd_T=4.0)
    cfg.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                     mem=mem, head="mlp", attn=attn, shuffle_bn=True,
                     kl_teacher_bn="eval")
    cfg.model_s = JModel(name="resnet8", n_cls=N_CLS)
    cfg.model_t = JModel(name="resnet8", n_cls=N_CLS)
    cfg.run.bn = bn
    cfg.run.grad_accum = grad_accum
    return cfg


def _jax_run(init, cfg, mesh, sharded):
    state, jh = _jax_state(init, cfg.moma.mem, cfg.moma.attn,
                           mesh if sharded else None)
    step = quick_compiled(j_make_step(cfg, jh, augment_fn=None,
                                      donate=False, mesh=mesh))
    batch = {"image": jax.device_put(init["images"], data_sharding(mesh)),
             "label": jax.device_put(init["labels"].astype(np.int32),
                                     data_sharding(mesh, ndim=1)),
             "shuffle_perm": jnp.asarray(PERM.astype(np.int32))}
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return state, jax.device_get(new), {k: float(v) for k, v in
                                        metrics.items()}


def _port_trees(init, res, attn):
    st, te = (create_model("resnet8", N_CLS) for _ in range(2))
    ph = CMOHeads("mlp", attn, FEAT, s_dim=S_DIM, t_dim=S_DIM)
    st.load_state_dict(res["student"])
    te.load_state_dict(res["teacher"])
    ph.load_state_dict(res["heads"])
    return (jax_variables(st, init["vs"]), jax_variables(te, init["vt"]),
            jax_variables(ph, init["heads"][attn][1]))


def _close(got, want, rtol, tag):
    want = jax.device_get(want)
    floor = group_floor(want)
    for path, g, w in walk_pairs(got, want, tag):
        assert_close_scaled(g, w, rtol, path, floor)


def _updates(after, before):
    return jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        / LR, after, before)


def _compare_step(init, res, bank, j0, j1, jm, attn):
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        np.testing.assert_allclose(res["metrics"][k], jm[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    assert res["queue_ptr"] == int(jm["queue_ptr"]) == B
    s, t, cmo = _port_trees(init, res, attn)
    hv = init["heads"][attn][1]
    _close(s["params"], j1.params["student"], PARAM_RTOL, "student")
    _close(cmo["params"], j1.params["cmo"], PARAM_RTOL, "cmo")
    _close(_updates(s["params"], init["vs"]["params"]),
           _updates(j1.params["student"], j0.params["student"]), GRAD_RTOL,
           "student_grad")
    for name in [n for n in hv["params"] if n.startswith("att")] + [
            "embed_s"]:
        _close(_updates(cmo["params"][name], hv["params"][name]),
               _updates(j1.params["cmo"][name], j0.params["cmo"][name]),
               GRAD_RTOL, name + "_grad")
    _close(t["params"], j1.teacher_params, EMA_RTOL, "teacher")
    _close(s["batch_stats"], j1.batch_stats["student"], PARAM_RTOL,
           "student_bs")
    _close(t["batch_stats"], j1.teacher_batch_stats, PARAM_RTOL,
           "teacher_bs")
    for n, got in bank.items():
        assert_close_scaled(got, np.asarray(j1.queue.memory[n]), PARAM_RTOL,
                            f"queue:{n}")


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_grid_step_matches_jax_mesh(init, ranks, name):
    case = STEP_CASES[name]
    mesh = j_create_mesh(jax.devices()[:4], model_parallel=2)
    j0, j1, jm = _jax_run(init, _jax_cfg(case["bn"], case["mem"],
                                         case["attn"]), mesh, True)
    _, out = ranks()
    res = [out[r]["step"][name] for r in range(4)]
    bank = {n: bank_join([res[0]["queue"][n].numpy(),
                          res[1]["queue"][n].numpy()])
            for n in res[0]["queue"]}
    _compare_step(init, res[0], bank, j0, j1, jm, case["attn"])
    # the replicas: every rank's state bit for bit, the bank shards by
    # model index
    for r in (1, 2, 3):
        assert res[r]["metrics"] == res[0]["metrics"], (name, r)
        for part in ("student", "teacher", "heads"):
            for k in res[0][part]:
                assert torch.equal(res[r][part][k], res[0][part][k]), (
                    name, r, part, k)
    for n in res[0]["queue"]:
        assert torch.equal(res[2]["queue"][n], res[0]["queue"][n])
        assert torch.equal(res[3]["queue"][n], res[1]["queue"][n])


def test_grid_layout(ranks):
    """Global rank r is data index r // 2 and model index r % 2."""
    _, out = ranks()
    assert [o["grid"] for o in out] == [(0, 2, 0, 2), (0, 2, 1, 2),
                                        (1, 2, 0, 2), (1, 2, 1, 2)]


# -------------------------------------------------- (iv) resume at MP=2

def test_model_parallel_resume_equals_the_straight_run(ranks, tmp_path,
                                                       monkeypatch):
    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train import moma as moma_train

    _, out = ranks()
    a, b = out[0]["resume"], out[1]["resume"]
    assert (a["model_index"], b["model_index"]) == (0, 1)
    for res in (a, b):
        assert res["losses"][0] == res["losses"][1] and res["losses"][0]
        _equal(res["straight"], res["resumed"])
    _equal(a["resumed"], b["resumed"])
    assert a["resumed"]["queue"]["memory"]["memory"].shape == (64, 16)
    # the checkpoint holds the whole bank: it resumes at --model_parallel 1
    saved = torch.load(os.path.join(a["run_dir"], "ckpt", "latest.pt"),
                       weights_only=True)
    _equal(saved["queue"], a["resumed"]["queue"])
    monkeypatch.setattr(moma_train, "build_datasets",
                        moma_train.build_datasets)
    W._cut_sets(moma_train)
    save_dir = os.path.dirname(a["run_dir"])
    cfg = parse_student_args(RESUME_ARGV + ["--save_dir", save_dir,
                                            "--epochs", "3", "--resume"])
    state, result = moma_train.run_moma(cfg, synthetic=True)
    assert [r["epoch"] for r in result["epochs"]] == [3]
    assert state.queue.memory["memory"].shape == (64, 16)
    assert state.step == 6 and np.isfinite(result["train"]["loss"])


def _equal(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


# ------------------------------------------- (v) [5a-rest] grad accum

def test_two_rank_accum_step_matches_jax_and_one_process(init, ranks):
    """--bn global --grad_accum 2 on 2 data ranks: each rank holds its
    half of each microbatch (mesh.rank_rows); the step is JAX's
    accumulated step on a 2-device mesh (2 virtual ranks, each spanning
    both devices) and the port's one-process step."""
    from moma_tpu_torch.train.moma import make_moma_train_step

    mesh = j_create_mesh(jax.devices()[:2])
    j0, j1, jm = _jax_run(init, _jax_cfg("global", "MoCo", "self", 2), mesh,
                          False)
    inp, out = ranks()
    a, b = out[2]["accum"], out[3]["accum"]
    _compare_step(init, a, {n: v.numpy() for n, v in a["queue"].items()},
                  j0, j1, jm, "self")
    assert a["metrics"] == b["metrics"]
    for part in ("student", "teacher", "heads", "queue"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    step_in = inp["step_in"]
    state = DW.moma_state(step_in, "mlp")
    state, m = make_moma_train_step(
        DW.moma_config("global", "mlp", step_in, grad_accum=2), None)(
        state, DW.rank_batch(step_in, 0, 1, step_in["perm"]),
        torch.Generator().manual_seed(7))
    want = DW.moma_result(state, m)
    for k in DW.MOMA_KEYS:
        assert abs(a["metrics"][k] - want["metrics"][k]) <= 2e-5 * abs(
            want["metrics"][k]) + 1e-6, k
    for part in ("student", "teacher", "heads", "queue"):
        for k, w in want[part].items():
            assert_close_scaled(a[part][k].numpy(), w.numpy(), 2e-4,
                                f"{part}/{k}", 1e-6)


# ------------------------------------- (vii) [5b-accum] over a split bank

@pytest.mark.parametrize("name", list(ACCUM_MP_CASES))
def test_accum_step_over_a_split_bank_matches_jax(init, ranks, name):
    """--grad_accum 2 at --model_parallel 2: each microbatch's contrast
    through the split-bank steps (MoCoAtt 'all' through the ring), one
    enqueue of the rows each model rank owns, against JAX's accumulated
    step with the bank sharded over 'model' on the same mesh (GSPMD)."""
    (rows, mp), case = ACCUM_MP_CASES[name]
    mesh = j_create_mesh(jax.devices()[:rows * mp], model_parallel=mp)
    j0, j1, jm = _jax_run(init, _jax_cfg("global", case["mem"], case["attn"],
                                         2), mesh, True)
    _, out = ranks()
    who = range(4) if rows == 2 else (2, 3)
    res = [out[r]["accum_mp"][name] for r in who]
    bank = {n: bank_join([res[0]["queue"][n].numpy(),
                          res[1]["queue"][n].numpy()])
            for n in res[0]["queue"]}
    _compare_step(init, res[0], bank, j0, j1, jm, case["attn"])
    for r, other in zip(who, res):
        assert other["metrics"] == res[0]["metrics"], (name, r)
        for part in ("student", "teacher", "heads"):
            for k in res[0][part]:
                assert torch.equal(other[part][k], res[0][part][k]), (
                    name, r, part, k)
        for n in res[0]["queue"]:
            assert torch.equal(other["queue"][n],
                               res[(r - who[0]) % mp]["queue"][n]), (name, r)


# ------------------------------------------------------ (vi) refusals

def _cfg(*extra):
    return port_config.parse_student_args(
        [a for a in RESUME_ARGV if a not in ("--device", "cpu")] + list(
            extra))


# at --model_parallel 1, in both arches: JAX's run_moma raises these after
# its state is built (moma.py:1426-1431)
MP1_CASES = [
    (["--sequence_parallel"], False,
     "--sequence_parallel requires --model_parallel > 1"),
    (["--teacher_parallel", "pipeline"], False,
     "--teacher_parallel pipeline requires --model_parallel > 1"),
    (["--teacher_parallel", "expert"], False,
     "--teacher_parallel expert requires --model_parallel > 1"),
    (["--sequence_parallel"], True,
     "--sequence_parallel requires --model_parallel > 1"),
    (["--pp_microbatch", "2", "--teacher_parallel", "pipeline"], True,
     "--teacher_parallel pipeline requires --model_parallel > 1"),
    (["--teacher_parallel", "expert"], True,
     "--teacher_parallel expert requires --model_parallel > 1"),
]


@pytest.mark.parametrize("extra,cross,exc,match", [
    (["--pp_microbatch", "2"], False, ValueError,
     "--pp_microbatch only applies with --teacher_parallel pipeline"),
    (["--model_parallel", "2", "--sequence_parallel"], False, ValueError,
     "--sequence_parallel applies to the tensor-parallel ViT"),
    (["--model_parallel", "2", "--teacher_parallel", "pipeline"], False,
     ValueError, "--teacher_parallel pipeline applies to the ViT"),
    (["--model_parallel", "3"], False, ValueError,
     "nce_k=64 not divisible by model_parallel=3"),
    (["--model_parallel", "2", "--bn", "local"], True, ValueError,
     "bn='local'/'sync' with --model_parallel does not compose"),
    (["--model_parallel", "2", "--teacher_parallel", "expert"], True,
     ValueError, r"expert-parallel teacher requires a MoE ViT \(vit_\*_moe\*"
     r"\), got ResNetCifar"),
] + [(extra, cross, ValueError, match) for extra, cross, match in MP1_CASES])
def test_model_axis_refusals(extra, cross, exc, match):
    """A cross-arch case checks the route of a resnet8 teacher (build_state
    passes the teacher; only the expert route reaches a check of it)."""
    cfg = _cfg(*extra)
    teacher = create_model("resnet8", 4) if cross else None
    with pytest.raises(exc, match=match):
        port_config.check_model_axis(cfg, cross, teacher)


def test_model_axis_refusals_at_mp1_carry_the_jax_messages(tmp_path):
    """Each MP-1 case's message against the one JAX's run_moma raises for
    the same flags (one test: JAX builds its state before it raises, and
    the first build in a process compiles for seconds).  JAX's cross-arch
    runs take resnet14 as the teacher: its parameter tree differs from
    resnet8's, so run_moma runs in EmaTec mode, and its eager init compiles
    the operations resnet8's did (a ViT's took some 30 s more)."""
    from moma_tpu.core.config import parse_student_args as j_args
    from moma_tpu.train.moma import run_moma as j_run_moma

    for extra, cross, _ in MP1_CASES:
        with pytest.raises(ValueError) as got:
            port_config.check_model_axis(_cfg(*extra), cross)
        argv = ["--model_s", "resnet8", "--model_t",
                "resnet14" if cross else "resnet8", "--distill",
                "moma", "--image_size", "32", "--batch_size", "4",
                "--nce_k", "64", "--feat_dim", "16", "--epochs", "1",
                "--save_dir", str(tmp_path)]
        with pytest.raises(ValueError) as want:
            j_run_moma(j_args(argv + extra), synthetic=True)
        assert str(got.value) == str(want.value), (extra, cross)


def test_refusals_by_name_and_the_grid_size():
    from moma_tpu_torch.core.mesh import create_mesh

    # [5b-accum] and [6] are ported: --grad_accum and --teacher_quant with
    # --model_parallel parse
    cfg = _cfg("--model_parallel", "2", "--grad_accum", "2")
    assert (cfg.run.model_parallel, cfg.run.grad_accum) == (2, 2)
    cfg = _cfg("--model_parallel", "2", "--teacher_quant", "int8")
    assert (cfg.run.model_parallel, cfg.moma.teacher_quant) == (2, "int8")
    assert _cfg("--model_parallel", "2").run.model_parallel == 2
    with pytest.raises(ValueError) as port_err:
        create_mesh(2)
    with pytest.raises(ValueError) as jax_err:
        j_create_mesh(jax.devices()[:1], model_parallel=2)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("runner", ["teacher", "student"])
def test_runners_refuse_the_model_axis_with_jax_messages(runner, tmp_path):
    """run_teacher and the comparison distillers: JAX's ValueError text."""
    from moma_tpu.core.config import parse_student_args as j_student_args
    from moma_tpu.core.config import parse_teacher_args as j_teacher_args

    from moma_tpu_torch.train.student import run_student
    from moma_tpu_torch.train.teacher import run_teacher

    for extra in (["--model_parallel", "2"], ["--sequence_parallel"]):
        if runner == "teacher":
            argv = ["--model", "resnet8", "--save_dir", str(tmp_path)]
            j_cfg, cfg = (f(argv + extra) for f in (
                j_teacher_args, port_config.parse_teacher_args))
            from moma_tpu.train.teacher import run_teacher as j_run
            port_run = run_teacher
        else:
            argv = ["--model_s", "resnet8", "--model_t", "resnet8",
                    "--distill", "kd", "--save_dir", str(tmp_path)]
            j_cfg, cfg = (f(argv + extra) for f in (
                j_student_args, port_config.parse_student_args))
            from moma_tpu.train.student import run_student as j_run
            port_run = run_student
        with pytest.raises(ValueError) as want:
            j_run(j_cfg, synthetic=True)
        cfg.run.device = "cpu"
        with pytest.raises(ValueError) as got:
            port_run(cfg, synthetic=True)
        assert str(got.value) == str(want.value)
