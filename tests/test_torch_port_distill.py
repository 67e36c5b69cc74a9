"""The comparison distillers: moma_tpu_torch against moma_tpu on the CPU.

- `Distiller.loss` of all 17 methods (kdsvd with the JAX package's SVD
  held to the port's sign convention for singular vectors) on the same effiB0-shaped features at
  64^2 (batch 4, from a seeded numpy draw), the same aux weights (JAX's
  `init_aux`, carried by moma_tpu_torch.interop.load_jax_aux), logits,
  teacher classifier and, for crd, the same banks and contrast indices:
  the loss within 1e-5 of its own size; its gradients with respect to the
  student's features and to the aux parameters, the aux modules' BN
  running statistics after the call, and for crd the banks and Z, within
  1e-4 of each tensor's scale (torch_port_helpers.assert_close_scaled,
  floored at 1e-3 of the group's scale, 1e-2 for gradients: GRAD_FLOOR);
  simkd's metric logits within
  1e-5 of their scale.  float32.
- `make_distill_train_step`, one full step of effiB0 -> effiB0 at 64^2,
  batch 4, f32, no augmentation, for kd, hint and crd (two steps for crd,
  the second with Z held): the four losses within 1e-4 (loss_div 5e-4, a
  KL of near-uniform distributions, as tests/test_torch_port_moma_step.py
  sets it), the student and aux parameters, BN statistics, the CRD banks
  and Z within 1e-4 of scale after one step and 1e-3 after two.
- `InstanceSampler` draws and the Loader's 'index' and extras: equal.
- `probe_shapes` against a real forward, and a --resume round trip
  of `run_student --distill crd`, bit for bit with the banks.
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
from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
from moma_tpu.data import pipeline as JP
from moma_tpu.data.sampler import InstanceSampler as JSampler
from moma_tpu.losses.crd import CRDMemory as JCRD
from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.train import distill as JD
from moma_tpu.train.state import DistillState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core.config import (DISTILLERS, Config, DistillConfig,
                                        ModelConfig, MomaConfig,
                                        parse_student_args)
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data import pipeline as TP
from moma_tpu_torch.data.sampler import InstanceSampler
from moma_tpu_torch.interop import (jax_aux_variables, jax_variables,
                                    load_jax_aux, load_jax_variables)
from moma_tpu_torch.losses.crd import CRDMemory
from moma_tpu_torch.models.common import TorchLinear
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.train import distill as TD
from moma_tpu_torch.train import student as student_train
from moma_tpu_torch.train import teacher as teacher_train
from moma_tpu_torch.train.state import DistillState, make_sgd

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                make_init_ordered, ordered_numpy,
                                quick_compiled, quick_jit, tree_template,
                                walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS, FEAT, N_DATA, NCE_K = 4, 64, 4, 16, 64, 16
# gradients that are zero up to float noise (a conv bias feeding a
# train-mode BatchNorm; SelfA's query and key embeddings, whose
# l2-normalized outputs are 1-wide at batch 4) are held to 1e-4 of 1e-2 of
# their group's largest gradient, 1e-6 of it: about 8 float32 ulps
GRAD_FLOOR = 1e-2


def _canonical_jax_svd(svd):
    """jnp.linalg.svd with each right-singular vector's largest-magnitude
    entry made positive, as moma_tpu_torch.losses.functional.
    canonical_signs does (u untouched: kdsvd reads s and v only)."""

    def wrapped(x, *a, **k):
        u, s, vt = svd(x, *a, **k)
        pick = jnp.argmax(jnp.abs(vt), axis=-1, keepdims=True)
        sign = jnp.sign(jnp.take_along_axis(vt, pick, axis=-1))
        return u, s, vt * jnp.where(sign == 0, 1.0, sign)

    return wrapped
LR, EPOCHS, STEPS_PER_EPOCH = 0.05, 5, 4


def _cfgs(method):
    jc = JConfig()
    jc.data.batch_size = B
    jc.model_t = JModel(name="effiB0", n_cls=N_CLS)
    jc.distill = JDistill(distill=method, cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=NCE_K, nce_t=0.07, nce_m=0.5)
    tc = Config()
    tc.data.batch_size = B
    tc.model_s = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.model_t = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.distill = DistillConfig(distill=method, cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=NCE_K, nce_t=0.07, nce_m=0.5)
    return jc, tc


_SHAPES = []


def _shapes():
    """effiB0's feature shapes at 64^2, batch 4 (the port's probe)."""
    if not _SHAPES:
        _SHAPES.append(TD.probe_shapes(EfficientNet("b0", N_CLS), HW, B)[0])
    return _SHAPES[0]


def _crd_inputs(rs):
    idx = rs.permutation(N_DATA)[:B].astype(np.int32)
    cidx = rs.randint(0, N_DATA, (B, NCE_K + 1)).astype(np.int32)
    cidx[:, 0] = idx
    stdv = 1.0 / np.sqrt(FEAT / 3)
    banks = [rs.uniform(-stdv, stdv, (N_DATA, FEAT)).astype(np.float32)
             for _ in range(2)]
    return idx, cidx, banks


def _loss_inputs(method):
    rs = np.random.RandomState(11)
    shapes = _shapes()
    feat_s = [rs.randn(*s).astype(np.float32) for s in shapes]
    feat_t = [rs.randn(*s).astype(np.float32) for s in shapes]
    logit_s = rs.randn(B, N_CLS).astype(np.float32)
    logit_t = rs.randn(B, N_CLS).astype(np.float32)
    cls = {"kernel": (rs.randn(shapes[-1][-1], N_CLS) * 0.05).astype(
        np.float32), "bias": rs.randn(N_CLS).astype(np.float32)}
    idx, cidx, banks = _crd_inputs(rs)
    return feat_s, feat_t, logit_s, logit_t, cls, idx, cidx, banks


def _jax_distiller(method):
    jc, _ = _cfgs(method)
    return JD.Distiller(jc, _shapes(), _shapes(), n_data=N_DATA,
                        batch_size=B)


@pytest.mark.parametrize("method", DISTILLERS)
def test_distiller_loss_matches_jax(method, monkeypatch):
    if method == "kdsvd":
        # the port fixes the singular vectors' signs, which LAPACK leaves
        # to itself (ROADMAP: deviations by design); the JAX side is held
        # to the same convention
        monkeypatch.setattr(jnp.linalg, "svd",
                            _canonical_jax_svd(jnp.linalg.svd))
    feat_s, feat_t, logit_s, logit_t, cls, idx, cidx, banks = _loss_inputs(
        method)
    jd = _jax_distiller(method)
    _, tc = _cfgs(method)
    td = TD.Distiller(tc, _shapes(), _shapes(), n_data=N_DATA, batch_size=B)
    aux = td.init_aux(torch.Generator().manual_seed(0))
    if method == "semckd":
        # SelfA's 16 Proj regressors hold 255M parameters: JAX's eager
        # init takes 23 s, so the port's own init crosses the other way;
        # the trees' layout comes from a template that holds no memory
        tmpl_p, tmpl_bs = tree_template(jd.init_aux, jax.random.PRNGKey(3))
        aux_p, aux_bs = jax_aux_variables(aux, tmpl_p, tmpl_bs)
    else:
        aux_p, aux_bs = (ordered_numpy(t) for t in
                         jd.init_aux(jax.random.PRNGKey(3)))
        load_jax_aux(aux, aux_p, aux_bs)
        tmpl_p, tmpl_bs = aux_p, aux_bs
    extra = (JCRD(v1=jnp.asarray(banks[0]), v2=jnp.asarray(banks[1]),
                  z_v1=jnp.asarray(-1.0), z_v2=jnp.asarray(-1.0))
             if method == "crd" else None)
    batch = {"index": idx, "contrast_idx": cidx}

    def jloss(fs, ap, bs, ex):
        loss, new_bs, new_ex, ml = jd.loss(
            ap, bs, ex, fs, feat_t, logit_s, logit_t, batch,
            JD.make_classifier_apply({"classifier": cls}))
        return loss, (new_bs, new_ex, ml)

    # semckd's large convolutions run 3x slower without XLA's optimizer
    jit = jax.jit if method == "semckd" else quick_jit
    # done before the port's loss updates the BN statistics, which
    # semckd's trees share (jax_aux_variables)
    (jl, (j_bs, j_ex, j_ml)), (g_fs, g_aux) = jax.block_until_ready(jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            feat_s, aux_p, aux_bs, extra))

    aux.train()
    t_extra = (CRDMemory(*(torch.from_numpy(b.copy()) for b in banks),
                         torch.tensor(-1.0), torch.tensor(-1.0))
               if method == "crd" else None)
    cls_t = TorchLinear(cls["kernel"].shape[0], N_CLS)
    with torch.no_grad():
        cls_t.weight.copy_(torch.from_numpy(cls["kernel"].T.copy()))
        cls_t.bias.copy_(torch.from_numpy(cls["bias"]))
    teacher = torch.nn.Module()
    teacher.classifier = cls_t.requires_grad_(False)
    fs = [torch.from_numpy(f).requires_grad_(True) for f in feat_s]
    loss, ml = td.loss(aux, t_extra, fs, [torch.from_numpy(f) for f in feat_t],
                       torch.from_numpy(logit_s), torch.from_numpy(logit_t),
                       {"index": torch.from_numpy(idx),
                        "contrast_idx": torch.from_numpy(cidx)},
                       TD.make_classifier_apply(teacher))
    loss = torch.as_tensor(loss)
    if loss.requires_grad:
        loss.backward()

    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)) + 1e-7, (
        method, float(loss), float(jl))
    g_fs = jax.device_get(g_fs)
    floor = group_floor(list_as_dict(g_fs), GRAD_FLOOR)
    for i, (f, g) in enumerate(zip(fs, g_fs)):
        got = (np.zeros_like(g) if f.grad is None else f.grad.numpy())
        assert_close_scaled(got, g, 1e-4, f"d loss / d feat_s[{i}]", floor)
    if tmpl_p:
        # the parameters' gradients, and the BN statistics' values
        got_g, got_bs = jax_aux_variables(aux, tmpl_p, tmpl_bs, grads=True)
        g_aux = jax.device_get(g_aux)
        floor = group_floor(g_aux, GRAD_FLOOR)
        for path, g, w in walk_pairs(got_g, g_aux, "grad aux"):
            assert_close_scaled(g, w, 1e-4, path, floor)
        ref_bs = jax.device_get(j_bs)
        floor = group_floor(ref_bs)
        for path, g, w in walk_pairs(got_bs, {k: ref_bs[k] for k in aux_bs},
                                     "aux batch_stats"):
            assert_close_scaled(g, w, 1e-4, path, floor)
    if method == "crd":
        for k in ("v1", "v2", "z_v1", "z_v2"):
            assert_close_scaled(getattr(t_extra, k).numpy(),
                                np.asarray(getattr(j_ex, k)), 1e-4, k)
    if method == "simkd":
        assert_close_scaled(ml.detach().numpy(), np.asarray(j_ml), 1e-5,
                            "simkd metric logits")


def list_as_dict(xs):
    return {str(i): x for i, x in enumerate(xs)}


def test_probe_shapes_follow_the_feature_contract():
    """The meta-device probe gives the shapes of a real forward, which
    tests/test_torch_port_effnet.py holds to the JAX package's contract:
    (reductions..., head map, pooled)."""
    net = EfficientNet("b0", N_CLS).eval()
    got, got_logits = TD.probe_shapes(net, HW, B)
    with torch.no_grad():
        feats, logits = net(torch.zeros(B, HW, HW, 3))
    assert got == [tuple(f.shape) for f in feats] == [
        (B, 32, 32, 16), (B, 16, 16, 24), (B, 8, 8, 40), (B, 4, 4, 112),
        (B, 2, 2, 1280), (B, 1280)]
    assert got_logits == tuple(logits.shape) == (B, N_CLS)


# ---------------------------------------------------------------- steps

_PROGRAMS = {}


def _step_init(method):
    if method not in _PROGRAMS:
        model = efficientnet_b0(num_classes=N_CLS)
        init = make_init_ordered(model, (2, HW, HW, 3))
        vs, vt = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
        jd = _jax_distiller(method)
        aux_p, aux_bs = (ordered_numpy(t) for t in
                         jd.init_aux(jax.random.PRNGKey(3)))
        _PROGRAMS[method] = (model, vs, vt, jd, aux_p, aux_bs)
    return _PROGRAMS[method]


def _step_batches(n):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(n):
        idx, cidx, _ = _crd_inputs(rs)
        out.append({"image": rs.randn(B, HW, HW, 3).astype(np.float32),
                    "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
                    "index": idx, "contrast_idx": cidx})
    return out


def _banks():
    return _crd_inputs(np.random.RandomState(5))[2]


def _jax_steps(method, batches):
    model, vs, vt, jd, aux_p, aux_bs = _step_init(method)
    tx = j_make_sgd(j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
                    0.9, 5e-4)
    params = {"student": vs["params"], "aux": aux_p}
    v1, v2 = _banks()
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "aux": aux_bs},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        opt_state=jax.jit(tx.init)(params), tx=tx,
        extra=(JCRD(v1=jnp.asarray(v1), v2=jnp.asarray(v2),
                    z_v1=jnp.asarray(-1.0), z_v2=jnp.asarray(-1.0))
               if method == "crd" else None),
        apply_fn=model.apply, teacher_apply_fn=model.apply)
    # compiled with LLVM's optimizer off: the step runs once or twice
    step = quick_compiled(JD.make_distill_train_step(jd, None, donate=False))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _torch_steps(method, batches):
    _, vs, vt, _, aux_p, aux_bs = _step_init(method)
    _, tc = _cfgs(method)
    student = EfficientNet("b0", num_classes=N_CLS)
    teacher = EfficientNet("b0", num_classes=N_CLS)
    load_jax_variables(student, vs)
    load_jax_variables(teacher, vt)
    td = TD.Distiller(tc, _shapes(), _shapes(), n_data=N_DATA, batch_size=B)
    aux = td.init_aux(torch.Generator().manual_seed(0))
    load_jax_aux(aux, aux_p, aux_bs)
    v1, v2 = _banks()
    state = DistillState(
        student=student, aux=aux, teacher=teacher.requires_grad_(False),
        optimizer=None,
        schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
        extra=(CRDMemory(torch.from_numpy(v1.copy()),
                         torch.from_numpy(v2.copy()), torch.tensor(-1.0),
                         torch.tensor(-1.0)) if method == "crd" else None))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    step = TD.make_distill_train_step(td, None)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.Generator().manual_seed(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("method,n", [("kd", 1), ("hint", 1), ("crd", 2)])
def test_distill_step_matches_jax(method, n):
    rtol = 1e-4 if n == 1 else 1e-3
    batches = _step_batches(n)
    js, jm = _jax_steps(method, batches)
    ts, tm = _torch_steps(method, batches)
    for a, b in zip(tm, jm):
        for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
            tol = 5 * rtol if k == "loss_div" else rtol
            assert abs(a[k] - b[k]) <= tol * abs(b[k]) + 1e-7, (k, a[k], b[k])
    assert ts.step == int(js.step) == n
    _, vs, vt, _, aux_p, aux_bs = _step_init(method)
    got_s = jax_variables(ts.student, vs)
    groups = {"student": (got_s["params"], js.params["student"]),
              "student_bs": (got_s["batch_stats"],
                             js.batch_stats["student"])}
    if aux_p:
        got_p, got_bs = jax_aux_variables(ts.aux, aux_p, aux_bs)
        groups["aux"] = (got_p, js.params["aux"])
        if aux_bs:
            groups["aux_bs"] = (got_bs, js.batch_stats["aux"])
    for name, (got, ref) in groups.items():
        ref = jax.device_get(ref)
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got, ref, name):
            assert_close_scaled(g, w, rtol, path, floor)
    # the frozen teacher: untouched
    for path, g, w in walk_pairs(jax_variables(ts.teacher, vt), vt):
        np.testing.assert_array_equal(g, w, err_msg=path)
    if method == "crd":
        for k in ("v1", "v2", "z_v1", "z_v2"):
            assert_close_scaled(getattr(ts.extra, k).numpy(),
                                np.asarray(getattr(js.extra, k)), rtol, k)
        # the rows the steps wrote moved; the others kept their values
        moved = np.unique(np.concatenate([b["index"] for b in batches]))
        v1 = _banks()[0]
        kept = np.setdiff1d(np.arange(N_DATA), moved)
        np.testing.assert_array_equal(ts.extra.v1.numpy()[kept], v1[kept])
        assert (np.abs(ts.extra.v1.numpy()[moved] - v1[moved]).max(1)
                > 1e-3).all()
        assert float(ts.extra.z_v1) > 0 and float(ts.extra.z_v2) > 0


# ------------------------------------------------------- sampler, loader

@pytest.mark.parametrize("mode,percent", [("exact", 1.0), ("relax", 0.5)])
def test_instance_sampler_draws_match_jax(mode, percent):
    labels = np.random.RandomState(0).randint(0, 4, 200)
    got = InstanceSampler(labels, k=32, mode=mode, percent=percent, seed=3)
    want = JSampler(labels, k=32, mode=mode, percent=percent, seed=3)
    for i in range(3):
        idx = np.arange(8 * i, 8 * i + 8)
        np.testing.assert_array_equal(got.sample(idx), want.sample(idx))


def test_loader_index_and_extras_match_jax():
    data = JP.synthetic_dataset(40, 8, 4, seed=2)
    extras = {"tag": np.arange(40) * 3}
    for train in (True, False):
        got = TP.Loader(TP.ArrayDataset(data.images, data.labels), 8,
                        train=train, seed=5, extras=extras)
        want = JP.Loader(data, 8, train=train, seed=5, extras=extras)
        got.set_epoch(2)
        want.set_epoch(2)
        for g, w in zip(got, want):
            assert g["index"].dtype == np.int32
            for k in ("index", "tag", "label"):
                np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------- run

CRD_ARGS = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s",
            "effiB0", "--model_t", "effiB0", "--distill", "crd", "-b", "0.8",
            "--image_size", "32", "--batch_size", "4", "--nce_k", "16",
            "--feat_dim", "16", "--fp32", "--print_freq", "1", "--nce_m",
            "0.5"]


def _cut_sets(monkeypatch):
    """The synthetic sets cut to 8 train (2 steps an epoch), 4 val and 4
    test images."""
    full = teacher_train.build_datasets

    def cut(cfg, synthetic):
        return tuple(TP.ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (8, 4, 4)))

    monkeypatch.setattr(teacher_train, "build_datasets", cut)


def _equal(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_crd_resume_equals_the_straight_run(tmp_path, monkeypatch):
    """--distill crd for 1 epoch, then --resume to 2, against 2 straight
    epochs: the same step losses and the same final state, CRD banks and Z
    included, bit for bit.  The run's sampler draws one stream from the
    seed, as moma_tpu's does, which a restart begins again; here each
    batch's draw is seeded from its indices, so both runs draw the same."""
    _cut_sets(monkeypatch)

    class PerBatch(student_train.InstanceSampler):
        def sample(self, idx):
            self.rng = np.random.RandomState(int(idx @ np.arange(1, 5)))
            return super().sample(idx)

    monkeypatch.setattr(student_train, "InstanceSampler", PerBatch)

    def run(save, epochs, *extra):
        cfg = parse_student_args(CRD_ARGS + ["--save_dir", str(save),
                                             "--epochs", str(epochs), *extra])
        return student_train.run_student(cfg, synthetic=True)

    def losses(r):
        with open(os.path.join(r["run_dir"], "scalars.jsonl")) as f:
            return [(x["step"], x["loss"]) for x in map(json.loads, f)]

    s_st, r_st = run(tmp_path / "straight", 2)
    run(tmp_path / "resumed", 1)
    s_re, r_re = run(tmp_path / "resumed", 2, "--resume")
    assert s_re.step == s_st.step == 4
    assert losses(r_re) == losses(r_st)
    want = student_train.distill_full_state(s_st)
    got = student_train.distill_full_state(s_re)
    assert set(got["extra"]) == {"v1", "v2", "z_v1", "z_v2"}
    assert float(got["extra"]["z_v1"]) > 0
    _equal(got, want)
    assert os.path.basename(r_st["run_dir"]).startswith("student_crd_")


def test_comparison_flags_parse():
    argv = [a for a in CRD_ARGS]
    cfg = parse_student_args(argv + ["--mode", "relax", "-f", "4", "-s",
                                     "2.0", "--hint_layer", "2"])
    assert (cfg.moma.nce_m, cfg.moma.mode, cfg.distill.factor,
            cfg.distill.soft, cfg.distill.hint_layer) == (0.5, "relax", 4,
                                                          2.0, 2)
    assert cfg.moma.nce_t == 0.07   # forced to 0.15 for moma only
