"""The comparison distillers on several ranks: the port's step on 2 gloo
ranks against its one-process step on the global batch and against
moma_tpu's step on a 2-device data mesh, on the CPU.

One spawn of 2 gloo ranks (moma_tpu_torch.core.mesh.spawn_ranks,
tests/torch_distill_ranks_workers.py) runs every case below, shared by the
module's tests and by the xdist workers (torch_port_helpers.run_once).  It
starts in a thread on the module's first test, and its ranks leave each
case's results as soon as they have them, so a test computes its JAX
reference while the ranks run and then waits for its own case only.
effiB0 student and teacher at 64^2 from seeded port inits, global batch 8
(4 rows a rank), float32, no augmentation, plain SGD at lr 0.05, one
PyTorch thread:

  (i)   all 17 methods, and crd at --grad_accum 2: the 2-rank step against
        the one-process step (case i's run in rank i % 2, with a
        one-process data axis, after the case's 2-rank step):
        the six metrics within 1e-5 of the total loss, every student and
        aux parameter, BN running statistic and CRD bank / Z within 1e-5
        of scale (torch_port_helpers.assert_close_scaled's measure, its
        floor at 1e-2 of the part's largest magnitude; integer tensors
        equal).  kdsvd's step is ill-conditioned (the gradients of an SVD
        with near-equal singular values): its one-process step moves by
        about 1e-3 of scale under a 1e-7 relative change of its input, so
        it is held to 10x that response, measured in the same run.  Both
        ranks' states equal bit for bit (a hash of every tensor).
  (ii)  similarity, rkd, pkt, correlation, semckd, crd (the losses that
        couple rows), kd and simkd: (i), and the 2-rank step against JAX's
        make_distill_train_step on create_mesh(jax.devices()[:2]) with
        the batch sharded over it, at the tolerances of
        tests/test_torch_port_distill.py (metrics 1e-4, loss_div 5e-4;
        student parameters, BN statistics and banks 1e-4 of scale,
        floored at 1e-3 of the group's; the aux parameters, which start
        at zero for every bias and so hold lr times a gradient after one
        step, at its GRAD_FLOOR, 1e-2 of the group's).  semckd's JAX step
        runs on one device: its 255M aux parameters, replicated on both
        devices of the mesh, would take 8 GB; the program is the same
        global-batch step.
  (iii) crd at --grad_accum 2 on 2 ranks (each rank's share of each
        microbatch, mesh.rank_rows): (i), and against JAX's accumulated
        step, the same tolerances.
  (iv)  the CRD sampler: the 2 ranks' SampledLoader draws, joined by
        rank_rows' inverse, equal JAX's InstanceSampler draw for the
        global batch, with and without --grad_accum 2.
  (v)   one augmented step on the same rows on both ranks: each rank
        augments from its own stream (mesh.rank_generator), so the
        images differ.
  (vi)  run_student --distill crd on the 2 ranks (effiB0 at 32^2, batch 4,
        16 train images): a SIGTERM to rank 1 stops both at the same step
        of the first epoch, rank 0 writes the preemption save, and
        --resume from it ends where the straight run ends, bit for bit,
        CRD banks and step losses included, on both ranks.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import ModelConfig as JModel
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.mesh import create_mesh, data_sharding, replicated_sharding
from moma_tpu.data.sampler import InstanceSampler as JSampler
from moma_tpu.losses.crd import CRDMemory as JCRD
from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.train import distill as JD
from moma_tpu.train.state import DistillState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core.config import DISTILLERS
from moma_tpu_torch.core.mesh import rank_generator, rank_rows, spawn_ranks
from moma_tpu_torch.data.pipeline import ArrayDataset, Loader
from moma_tpu_torch.data.sampler import InstanceSampler
from moma_tpu_torch.interop import jax_aux_variables, jax_variables
from moma_tpu_torch.train.distill import probe_shapes
from moma_tpu_torch.train.student import SampledLoader

import torch_distill_ranks_workers as W
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                jax_template, quick_compiled, run_once,
                                tree_template, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS, FEAT, N_DATA, NCE_K, LR = 8, 64, 4, 16, 64, 16, 0.05
WORKER_TIMEOUT_S = 420
JAX_CASES = ["similarity", "rkd", "pkt", "correlation", "semckd", "crd",
             "kd", "simkd", "crd_accum2"]
METHODS = dict([(m, (m, 1)) for m in DISTILLERS]
               + [("crd_accum2", ("crd", 2))])
GROUP = [m for m in DISTILLERS if m not in JAX_CASES]
# the ranks' order: the cases whose tests do no work of their own first,
# semckd, the largest, last
CASES = ([(m, *METHODS[m]) for m in GROUP]
         + [("augment", "kd", 1), ("run", "crd", 1)]
         + [(m, *METHODS[m]) for m in JAX_CASES if m != "semckd"]
         + [("semckd", "semckd", 1)])
# (i): ranks against one process
RTOL, FLOOR_FRAC, NOISE_CASES, NOISE_FACTOR = 1e-5, 1e-2, {"kdsvd"}, 10.0
# (ii) / (iii): tests/test_torch_port_distill.py's tolerances
J_RTOL, J_DIV_RTOL, GRAD_FLOOR = 1e-4, 5e-4, 1e-2
RUN_ARGV = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s",
            "effiB0", "--model_t", "effiB0", "--distill", "crd", "-b", "0.8",
            "--image_size", "32", "--batch_size", "4", "--nce_k", "16",
            "--feat_dim", "16", "--fp32", "--print_freq", "1", "--nce_m",
            "0.5", "--epochs", "2"]
J_STUDENT = efficientnet_b0(num_classes=N_CLS)


def _inputs(root):
    rs = np.random.RandomState(7)
    idx = rs.permutation(N_DATA)[:B].astype(np.int32)
    cidx = rs.randint(0, N_DATA, (B, NCE_K + 1)).astype(np.int32)
    cidx[:, 0] = idx
    stdv = 1.0 / np.sqrt(FEAT / 3)
    banks = [rs.uniform(-stdv, stdv, (N_DATA, FEAT)).astype(np.float32)
             for _ in range(2)]
    batch = {"image": rs.randn(B, HW, HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int64),
             "index": idx, "contrast_idx": cidx}
    return {"B": B, "HW": HW, "n_cls": N_CLS, "feat": FEAT,
            "n_data": N_DATA, "nce_k": NCE_K, "lr": LR,
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "banks": [torch.from_numpy(b) for b in banks],
            "cases": CASES, "full": set(JAX_CASES),
            "noise_cases": NOISE_CASES, "floor_frac": FLOOR_FRAC,
            "aug_rows": torch.from_numpy(
                rs.randint(0, 256, (4, HW, HW, 3), dtype=np.uint8)),
            "aug_seed": 3, "run_argv": RUN_ARGV, "root": root}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """get(name) -> (the ranks' inputs, [rank 0's, rank 1's] results of
    case `name`).  The module's first test in the run (run_once) starts
    the spawn in a thread and hands every worker its directory; a failed
    spawn leaves its error there."""

    def start():
        root = str(tmp_path_factory.mktemp("distill_ranks"))
        path = os.path.join(root, "inputs.pt")
        torch.save(_inputs(root), path)

        def spawn():
            try:
                spawn_ranks(W.step_cases, 2, (path,), backend="gloo",
                            timeout_s=WORKER_TIMEOUT_S)
            except BaseException as e:
                W.publish(root, "failed", 0, f"{type(e).__name__}: {e}")
                raise
        threading.Thread(target=spawn).start()
        return root

    root = run_once("test_torch_port_distill_ranks.ranks", start)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    return lambda name: (inp, _wait(root, name))


def _wait(root, name):
    """Both ranks' results of case `name`, once they are in `root`."""
    paths = [os.path.join(root, f"{name}.{r}.pt") for r in range(2)]
    failed = os.path.join(root, "failed.0.pt")
    # the spawn's own limit, and its error, come first
    deadline = time.monotonic() + WORKER_TIMEOUT_S + 60
    while not all(map(os.path.exists, paths)):
        if os.path.exists(failed):
            raise RuntimeError(torch.load(failed))
        if time.monotonic() > deadline:
            raise TimeoutError(f"no results of case {name} in {root}")
        time.sleep(0.2)
    return [torch.load(p, weights_only=False) for p in paths]


# ---------------------------------------------- (i) against one process

def _check_one_process(out, name):
    """(i): the ranks bit for bit; the 2-rank step against the one-process
    step.  Returns the results of the rank that checked it."""
    a, b = out
    assert a["digest"] == b["digest"] and a["metrics"] == b["metrics"]
    a = next(r for r in out if "ref_metrics" in r)
    total = abs(a["ref_metrics"]["loss"])
    for k, v in a["ref_metrics"].items():
        assert abs(a["metrics"][k] - v) <= RTOL * total, (k, a["metrics"][k],
                                                          v)
    tol = RTOL
    if name in NOISE_CASES:
        assert a["noise"] > 0
        tol = max(RTOL, NOISE_FACTOR * a["noise"])
    worst = max(a["errors"].items(), key=lambda kv: kv[1])
    assert worst[1] <= tol, (worst, tol)
    parts = {k.split("/")[0] for k in a["errors"]}
    assert "student" in parts
    if name.startswith("crd"):
        assert a["errors"]["extra/z_v1"] <= tol
    return a


def test_two_ranks_equal_the_one_process_step(ranks):
    """(i) for the methods without a JAX case below: hint, attention, vid,
    nst, kdsvd, srrl, ab, fsp, ft (one test: each would only wait on the
    ranks)."""
    for name in GROUP:
        _check_one_process(ranks(name)[1], name)


# ------------------------------------------------------ (ii) against JAX

_JAX = {}


def _port_trees():
    st, te = W.distill_models({"n_cls": N_CLS})
    vs, vt = (jax_variables(m, jax_template(J_STUDENT, (2, HW, HW, 3)))
              for m in (st, te))
    return {"vs": vs, "vt": vt, "shapes": probe_shapes(st, HW, B)[0]}


def _port_init():
    """The seeded port student and teacher as JAX trees, and the student's
    feature shapes (once for the workers of a pytest-xdist run)."""
    if not _JAX:
        _JAX.update(run_once("test_torch_port_distill_ranks.port_init",
                             _port_trees))
    return _JAX["vs"], _JAX["vt"], _JAX["shapes"]


def _jax_distiller(method):
    jc = JConfig()
    jc.data.batch_size = B
    jc.model_t = JModel(name="effiB0", n_cls=N_CLS)
    jc.distill = JDistill(distill=method, cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=NCE_K, nce_t=0.07, nce_m=0.5)
    shapes = _port_init()[2]
    return JD.Distiller(jc, shapes, shapes, n_data=N_DATA, batch_size=B)


def _aux_trees(method, jd, aux):
    """(params, batch_stats) of the port's aux modules in JAX's layout."""
    tmpl_p, tmpl_bs = tree_template(jd.init_aux, jax.random.PRNGKey(3))
    return jax_aux_variables(aux, tmpl_p, tmpl_bs)


def _jax_step(inp, method, grad_accum, aux, n_devices=2):
    """(JAX state after the step, its metrics, the aux templates), from
    the port's `aux` modules' weights."""
    vs, vt, _ = _port_init()
    jd = _jax_distiller(method)
    aux_p, aux_bs = _aux_trees(method, jd, aux)
    mesh = create_mesh(jax.devices()[:n_devices])
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "aux": aux_p}
    extra = None
    if method == "crd":
        v1, v2 = (b.numpy() for b in inp["banks"])
        extra = JCRD(v1=jnp.asarray(v1), v2=jnp.asarray(v2),
                     z_v1=jnp.asarray(-1.0), z_v2=jnp.asarray(-1.0))
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "aux": aux_bs},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        opt_state=tx.init(params), tx=tx, extra=extra,
        apply_fn=J_STUDENT.apply, teacher_apply_fn=J_STUDENT.apply)
    state = jax.device_put(state, replicated_sharding(mesh))
    del params
    batch = {k: jax.device_put(
        v.numpy().astype(np.int32) if k != "image" else v.numpy(),
        data_sharding(mesh, ndim=v.ndim))
        for k, v in inp["batch"].items()}
    step = JD.make_distill_train_step(jd, None, donate=False,
                                      grad_accum=grad_accum)
    # semckd's large convolutions run 3x slower without XLA's optimizer,
    # and the accumulated step's scan 30x
    step = (step if method == "semckd" or grad_accum > 1
            else quick_compiled(step))
    new, metrics = step(state, batch, jax.random.PRNGKey(9))
    del state
    return (jax.device_get(new), {k: float(v) for k, v in metrics.items()},
            (aux_p, aux_bs))


def _close(got, want, tag, floor_frac=1e-3):
    want = jax.device_get(want)
    floor = group_floor(want, floor_frac)
    for path, g, w in walk_pairs(got, want, tag):
        assert_close_scaled(g, w, J_RTOL, path, floor)


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_ranks_match_one_process_and_jax(ranks, name):
    method, grad_accum = METHODS[name]
    if method == "semckd":
        # after the ranks' semckd step, which holds 6 GB
        ranks(name)
    # the inputs are seeded: the same the ranks were given
    inp = _inputs("")
    state, _ = W.distill_state(inp, method, grad_accum)
    js, jm, (aux_p, aux_bs) = _jax_step(
        inp, method, grad_accum, state.aux,
        n_devices=1 if method == "semckd" else 2)
    res = dict(_check_one_process(ranks(name)[1], name))
    # the case's one test reads its state once (semckd's holds 1 GB)
    res["state"] = torch.load(res["state_path"], weights_only=True)
    os.remove(res["state_path"])
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        tol = J_DIV_RTOL if k == "loss_div" else J_RTOL
        assert abs(res["metrics"][k] - jm[k]) <= tol * abs(jm[k]) + 1e-7, (
            k, res["metrics"][k], jm[k])
    assert int(js.step) == 1
    st, _ = W.distill_models({"n_cls": N_CLS})
    st.load_state_dict(res["state"]["student"])
    vs, _, _ = _port_init()
    got_s = jax_variables(st, vs)
    _close(got_s["params"], js.params["student"], "student")
    _close(got_s["batch_stats"], js.batch_stats["student"], "student_bs")
    if aux_p:
        state.aux.load_state_dict(res["state"]["aux"])
        got_p, got_bs = jax_aux_variables(state.aux, aux_p, aux_bs)
        _close(got_p, js.params["aux"], "aux", GRAD_FLOOR)
        if aux_bs:
            _close(got_bs, js.batch_stats["aux"], "aux_bs")
    if method == "crd":
        for k in ("v1", "v2", "z_v1", "z_v2"):
            assert_close_scaled(res["state"]["extra"][k].numpy(),
                                np.asarray(getattr(js.extra, k)), J_RTOL, k)


# --------------------------------------------------------- (iv) sampler

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_rank_draws_join_to_the_global_draw(grad_accum):
    """Each rank's SampledLoader draws for the global batch and keeps its
    rows: joined, the ranks' draws are JAX's draw for the global batch, the
    rows of 'contrast_idx' those of 'index'."""
    rs = np.random.RandomState(0)
    labels = rs.randint(0, 4, 64)
    ds = ArrayDataset(np.zeros((64, 2, 2, 3), np.uint8), labels)
    want_sampler = JSampler(labels, k=NCE_K, mode="exact", seed=3)
    ranks = []
    for r in range(2):
        loader = Loader(ds, B, train=True, seed=5, rank=r, world=2,
                        grad_accum=grad_accum)
        ranks.append(list(SampledLoader(loader, InstanceSampler(
            labels, k=NCE_K, mode="exact", seed=3))))
    one = Loader(ds, B, train=True, seed=5)
    for i, glob in enumerate(one):
        want = want_sampler.sample(glob["index"])
        joined = np.empty_like(want)
        index = np.empty_like(glob["index"])
        order = rank_rows(np.arange(B), 0, 1)
        for r in range(2):
            rows = rank_rows(order, r, 2, grad_accum)
            joined[rows] = ranks[r][i]["contrast_idx"]
            index[rows] = ranks[r][i]["index"]
            assert "global_index" not in ranks[r][i]
        np.testing.assert_array_equal(index, glob["index"])
        np.testing.assert_array_equal(joined, want)
        np.testing.assert_array_equal(joined[:, 0], glob["index"])


# ------------------------------------------------------- (v) augmenting

def test_ranks_augment_from_their_own_streams(ranks):
    inp, (a, b) = ranks("augment")
    g = torch.Generator().manual_seed(inp["aug_seed"])
    assert [a["seed"], b["seed"]] == [rank_generator(g, r).initial_seed()
                                      for r in range(2)]
    assert a["image"].shape == b["image"].shape == (4, HW, HW, 3)
    assert not torch.equal(a["image"], b["image"])


# ------------------------------------------------------------ (vi) run

def _equal(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_preempted_and_resumed_run_equals_the_straight_run(ranks):
    _, (r0, r1) = ranks("run")
    for r in (r0, r1):
        # rank 1's signal after its second step: both stop after the third
        assert r["preempted"]["preempted"] and r["preempted"]["steps"] == 3
        assert r["preempted"]["epochs"] == []
        assert r["straight"]["epochs"] == [1, 2]
        assert r["resumed"]["epochs"] == [1, 2]
        _equal(r["resumed"]["state"], r["straight"]["state"])
    assert r0["straight"]["state"]["step"] == 8
    assert float(r0["straight"]["state"]["extra"]["z_v1"]) > 0
    _equal(r0["resumed"]["state"], r1["resumed"]["state"])
    assert r0["resumed"]["losses"] == r0["straight"]["losses"]
    assert len(r0["straight"]["losses"]) == 8
    ckpt = os.path.join(r0["resumed"]["run_dir"], "ckpt")
    saved = torch.load(os.path.join(ckpt, "latest.pt"), weights_only=False)
    _equal(saved["extra"], r0["straight"]["state"]["extra"])
