"""CIFAR-100 and the CLIs' default run: moma_tpu_torch against moma_tpu on
the CPU.

- The loader: a seeded file in the canonical `cifar-100-python/{train,
  test}` pickle layout (moma_tpu_torch.data.cifar.write_cifar100) loads to
  the same NHWC uint8 images and fine labels in both packages; both
  `build_datasets` return (train, test, test) from it and raise
  FileNotFoundError without it.
- The CIFAR augment: the port's crop and flip on JAX's own draws (re-derived
  from the key as moma_tpu/data/augment.py:47-49 and :59 draw them) equal
  JAX's bit for bit; after normalize within 1e-6; the eval normalize too.
  The port's own draws stay in range.
- `--fold_idx 0` with `--synthetic`, `--dataset synthetic` or `--dataset
  cifar100` raises JAX's ValueError in both packages' `build_datasets`, and
  in the port's teacher, comparison-student and MoMA runs.
- The default command lines: `parse_teacher_args([])` and
  `parse_student_args([])` give moma_tpu's fields (resnet20; resnet32x4 ->
  resnet8x4; cifar100, 240 epochs, lr 0.05 at 150/180/210, wd 5e-4, batch
  64), and pass `check_slice`.
- One vanilla step of resnet8 and one kd and one crd step of resnet8 from
  resnet8x4 (-c/-d/-b of scripts/run_comparison.sh) at 32^2, batch 4,
  float32, from the same weights (the port's init carried to JAX): losses
  within 1e-4 (loss_div 5e-4), every student parameter, BN statistic and
  aux tensor within 1e-4 of its scale (floored at 1e-3 of its group's) and
  the CRD banks within 1e-4, as tests/test_torch_port_distill.py holds
  effiB0's steps; the vanilla step's update within 2e-3.  A ReLU input
  within rounding of 0 would take opposite sides in the two packages (see
  tests/test_torch_port_zoo.py), so the test asserts that none of the
  student's lies within 5e-6 of it.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from moma_tpu.core import config as JC
from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
from moma_tpu.data import augment as JA
from moma_tpu.data import cifar as JCIFAR
from moma_tpu.losses.crd import CRDMemory as JCRD
from moma_tpu.models import create_model as j_create_model
from moma_tpu.train import distill as JD
from moma_tpu.train import teacher as JT
from moma_tpu.train.state import DistillState as JDistillState
from moma_tpu.train.state import TrainState as JTrainState
from moma_tpu.train.state import make_sgd as j_make_sgd
from moma_tpu.train.steps import make_vanilla_train_step as j_vanilla_step

from moma_tpu_torch.core import config as TC
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data import augment as TA
from moma_tpu_torch.data import cifar as TCIFAR
from moma_tpu_torch.interop import (jax_aux_variables, jax_variables,
                                    load_jax_aux)
from moma_tpu_torch.losses.crd import CRDMemory
from moma_tpu_torch.models import create_model
from moma_tpu_torch.train import distill as TD
from moma_tpu_torch.train import moma as moma_train
from moma_tpu_torch.train import student as student_train
from moma_tpu_torch.train import teacher as teacher_train
from moma_tpu_torch.train.state import DistillState, TrainState, make_sgd
from moma_tpu_torch.train.steps import make_vanilla_train_step

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled, copied,
                                group_floor, jax_template, ordered_numpy,
                                quick_compiled, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX_ONLY_FIELDS = {"scoped_vmem_kib", "donate"}


# ---------------------------------------------------------------- data

def test_loader_matches_jax(tmp_path):
    TCIFAR.write_cifar100(str(tmp_path), n_train=48, n_test=16, seed=3)
    for pkg in (JCIFAR, TCIFAR):
        assert pkg.cifar100_available(str(tmp_path))
        assert not pkg.cifar100_available(str(tmp_path / "none"))
    (jtr, jte), (ttr, tte) = (JCIFAR.load_cifar100(str(tmp_path)),
                              TCIFAR.load_cifar100(str(tmp_path)))
    for j, t, n in ((jtr, ttr, 48), (jte, tte, 16)):
        assert t.images.shape == (n, 32, 32, 3) and t.images.dtype == np.uint8
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert t.labels.dtype == np.int32 and t.labels.max() < 100

    for pkg, parse in ((JT, JC.parse_teacher_args),
                       (teacher_train, TC.parse_teacher_args)):
        cfg = parse(["--data_dir", str(tmp_path)])
        train, val, test = pkg.build_datasets(cfg)
        assert (len(train), len(val)) == (48, 16) and val is test
        cfg = parse(["--data_dir", str(tmp_path / "none")])
        with pytest.raises(FileNotFoundError, match="CIFAR-100"):
            pkg.build_datasets(cfg)


def _jax_draws(key, B, padding=4):
    """The draws of moma_tpu's cifar_train_augment for `key`: the crop
    offsets (augment.py:47-49) and the flip bits (:59)."""
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    off_h = jax.random.randint(ka, (B,), 0, 2 * padding + 1)
    off_w = jax.random.randint(kb, (B,), 0, 2 * padding + 1)
    flip = jax.random.bernoulli(k2, 0.5, (B,))
    return [torch.from_numpy(np.array(a)) for a in (off_h, off_w, flip)]


def test_cifar_augment_matches_jax_on_its_draws():
    B = 16
    images = np.random.RandomState(0).randint(0, 256, (B, 32, 32, 3),
                                              dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    off_h, off_w, flip = _jax_draws(key, B)
    assert 0 < int(flip.sum()) < B
    k1, k2 = jax.random.split(key)
    want_crop = np.asarray(JA._random_crop_pad(jnp.asarray(images), k1, 4))
    want_flip = np.asarray(JA.random_hflip(jnp.asarray(want_crop), k2))
    t = torch.from_numpy(images)
    crop = TA.random_crop_pad_from_draws(t, off_h, off_w, 4)
    assert crop.dtype == torch.uint8
    np.testing.assert_array_equal(crop.numpy(), want_crop)
    np.testing.assert_array_equal(TA.hflip_from_draws(crop, flip).numpy(),
                                  want_flip)
    got = TA.cifar_augment_from_draws(t, off_h, off_w, flip)
    want = np.asarray(JA.cifar_train_augment(jnp.asarray(images), key))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        TA.cifar_eval_normalize(t).numpy(),
        np.asarray(JA.cifar_eval_normalize(jnp.asarray(images))), rtol=0,
        atol=1e-6)
    # the port's own draws: offsets in [0, 8], i.e. a crop of the padded
    # image, and a flip of some images
    g = torch.Generator().manual_seed(0)
    out = TA.cifar_train_augment(t, g)
    assert out.shape == (B, 32, 32, 3) and torch.isfinite(out).all()
    padded = F.pad(t, (0, 0, 4, 4, 4, 4))
    g = torch.Generator().manual_seed(1)
    crop = TA.random_crop_pad(t, g, 4)
    for b in range(B):
        hits = [(i, j) for i in range(9) for j in range(9)
                if torch.equal(padded[b, i:i + 32, j:j + 32], crop[b])]
        assert hits, b


# ---------------------------------------------------------------- flags

@pytest.mark.parametrize("dataset,synthetic", [
    ("cifar100", True), ("synthetic", False), ("cifar100", False)])
def test_fold_idx_is_refused_without_a_manifest(dataset, synthetic,
                                                tmp_path):
    argv = ["--dataset", dataset, "--fold_idx", "0", "--n_folds", "5",
            "--data_dir", str(tmp_path)]
    msgs = []
    for pkg, parse in ((JT, JC.parse_teacher_args),
                       (teacher_train, TC.parse_teacher_args)):
        with pytest.raises(ValueError, match="--fold_idx applies") as e:
            pkg.build_datasets(parse(argv), synthetic)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the port's three runs refuse before anything is loaded
    base = argv + ["--device", "cpu", "--save_dir", str(tmp_path)]
    runs = [(teacher_train.run_teacher, TC.parse_teacher_args(base)),
            (student_train.run_student, TC.parse_student_args(
                base + ["--distill", "kd"])),
            (moma_train.run_moma, TC.parse_student_args(
                base + ["--distill", "moma"]))]
    for run, cfg in runs:
        with pytest.raises(ValueError, match="--fold_idx applies"):
            run(cfg, synthetic=synthetic)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in JAX_ONLY_FIELDS}


@pytest.mark.parametrize("which", ["teacher", "student"])
def test_default_command_lines_parse_like_jax(which):
    got = getattr(TC, f"parse_{which}_args")([])
    want = getattr(JC, f"parse_{which}_args")([])
    for part in ("data", "model_s", "model_t", "optim", "distill", "moma"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is not None:
            assert _fields(g) == _fields(w), part
    run = _fields(got.run)
    assert run.pop("device") == "cuda"
    assert run == _fields(want.run)
    assert (got.data.dataset, got.optim.learning_rate, got.run.epochs,
            tuple(got.optim.lr_decay_epochs), got.optim.weight_decay,
            got.data.batch_size) == ("cifar100", 0.05, 240, (150, 180, 210),
                                     5e-4, 64)
    names = ((got.model_s.name,) if which == "teacher"
             else (got.model_s.name, got.model_t.name))
    assert names == (("resnet20",) if which == "teacher"
                     else ("resnet8x4", "resnet32x4"))
    TC.check_slice(got, supervised=which == "teacher")


# ---------------------------------------------------------------- steps

B, HW, N_CLS, N_DATA, NCE_K, FEAT = 4, 32, 10, 64, 16, 16
LR, EPOCHS, STEPS_PER_EPOCH = 0.05, 5, 4
# -c / -d / -b of scripts/run_comparison.sh
METHODS = {"kd": (1.0, 0.0, 1.0), "crd": (1.0, 1.0, 0.8)}


def _weights(name, seed):
    """(JAX module, port module, JAX variables): the port's seeded init
    carried to JAX in call order."""
    jm = j_create_model(name, N_CLS)
    tm = create_model(name, N_CLS,
                      generator=torch.Generator().manual_seed(seed))
    return jm, tm, copied(jax_variables(tm, jax_template(
        jm, (1, HW, HW, 3))))


def _batch():
    """Batch seed 15: no ReLU input of resnet8's forward within 5e-6 of 0
    (asserted by _check_kinks)."""
    rs = np.random.RandomState(15)
    idx = rs.permutation(N_DATA)[:B].astype(np.int32)
    cidx = rs.randint(0, N_DATA, (B, NCE_K + 1)).astype(np.int32)
    cidx[:, 0] = idx
    return {"image": rs.randn(B, HW, HW, 3).astype(np.float32),
            "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
            "index": idx, "contrast_idx": cidx}


def _check_kinks(student, batch):
    probe = copy.deepcopy(student).train()
    with torch.no_grad(), ReluInputs() as kinks:
        probe(torch.from_numpy(batch["image"]))
    assert kinks.low > 5e-6, kinks.low


def _compare(got, ref, rtol, what):
    ref = jax.device_get(ref)
    floor = group_floor(ref)
    for path, g, w in walk_pairs(got, ref, what):
        assert_close_scaled(g, w, rtol, path, floor)


def test_resnet8_vanilla_step_matches_jax():
    jm, tm, v0 = _weights("resnet8", 0)
    batch = _batch()
    _check_kinks(tm, batch)
    tx = j_make_sgd(j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
                    0.9, 5e-4)
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=v0["params"],
                     batch_stats=v0["batch_stats"],
                     opt_state=jax.jit(tx.init)(v0["params"]), tx=tx,
                     apply_fn=jm.apply)
    jb = {k: jnp.asarray(batch[k]) for k in ("image", "label")}
    js, jmet = quick_compiled(j_vanilla_step(augment_fn=None, donate=False))(
        js, jb, jax.random.PRNGKey(9))
    ts = TrainState(model=tm, optimizer=make_sgd(tm.parameters(), 0.9, 5e-4),
                    schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH,
                                         cosine=True))
    ts, tmet = make_vanilla_train_step(None)(
        ts, {k: torch.from_numpy(batch[k]) for k in ("image", "label")},
        torch.Generator().manual_seed(9))
    a, b = float(tmet["loss"]), float(jmet["loss"])
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    assert float(tmet["acc1"]) == float(jmet["acc1"])
    got = jax_variables(ts.model, v0)
    _compare(got["params"], js.params, 1e-4, "params")
    _compare(got["batch_stats"], js.batch_stats, 1e-4, "batch_stats")
    upd = jax.tree_util.tree_map(lambda r, i: np.asarray(r) - np.asarray(i),
                                 jax.device_get(js.params), v0["params"])
    init = {p: w for p, _, w in walk_pairs(v0["params"], v0["params"])}
    floor = group_floor(upd)
    for path, g, w in walk_pairs(got["params"], upd):
        assert_close_scaled(np.asarray(g) - init[path], w, 2e-3,
                            path + " update", floor)


def _cfgs(method):
    c, d, b = METHODS[method]
    jc = JC.Config()
    jc.data.batch_size = B
    jc.model_t = JC.ModelConfig(name="resnet8x4", n_cls=N_CLS)
    jc.distill = JC.DistillConfig(distill=method, cls=c, div=d, beta=b)
    jc.moma = JC.MomaConfig(feat_dim=FEAT, nce_k=NCE_K, nce_t=0.07,
                            nce_m=0.5)
    tc = TC.Config()
    tc.data.batch_size = B
    tc.model_s = TC.ModelConfig(name="resnet8", n_cls=N_CLS)
    tc.model_t = TC.ModelConfig(name="resnet8x4", n_cls=N_CLS)
    tc.distill = TC.DistillConfig(distill=method, cls=c, div=d, beta=b)
    tc.moma = TC.MomaConfig(feat_dim=FEAT, nce_k=NCE_K, nce_t=0.07,
                            nce_m=0.5)
    return jc, tc


@pytest.mark.parametrize("method", sorted(METHODS))
def test_distill_step_from_resnet8x4_matches_jax(method):
    jm_s, ts_m, vs = _weights("resnet8", 0)
    jm_t, tt_m, vt = _weights("resnet8x4", 1)
    batch = _batch()
    _check_kinks(ts_m, batch)
    jc, tc = _cfgs(method)
    s_sh = TD.probe_shapes(ts_m, HW, B)[0]
    t_sh = TD.probe_shapes(tt_m, HW, B)[0]
    jd = JD.Distiller(jc, s_sh, t_sh, n_data=N_DATA, batch_size=B)
    aux_p, aux_bs = (ordered_numpy(t)
                     for t in jd.init_aux(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(5)
    stdv = 1.0 / np.sqrt(FEAT / 3)
    v1, v2 = (rs.uniform(-stdv, stdv, (N_DATA, FEAT)).astype(np.float32)
              for _ in range(2))

    tx = j_make_sgd(j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
                    0.9, 5e-4)
    params = {"student": vs["params"], "aux": aux_p}
    js = JDistillState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "aux": aux_bs},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        opt_state=jax.jit(tx.init)(params), tx=tx,
        extra=(JCRD(v1=jnp.asarray(v1), v2=jnp.asarray(v2),
                    z_v1=jnp.asarray(-1.0), z_v2=jnp.asarray(-1.0))
               if method == "crd" else None),
        apply_fn=jm_s.apply, teacher_apply_fn=jm_t.apply)
    js, jmet = quick_compiled(JD.make_distill_train_step(jd, None,
                                                         donate=False))(
        js, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(9))

    td = TD.Distiller(tc, s_sh, t_sh, n_data=N_DATA, batch_size=B)
    aux = td.init_aux(torch.Generator().manual_seed(0))
    load_jax_aux(aux, aux_p, aux_bs)
    state = DistillState(
        student=ts_m, aux=aux, teacher=tt_m.requires_grad_(False),
        optimizer=None,
        schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
        extra=(CRDMemory(torch.from_numpy(v1.copy()),
                         torch.from_numpy(v2.copy()), torch.tensor(-1.0),
                         torch.tensor(-1.0)) if method == "crd" else None))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    state, tmet = TD.make_distill_train_step(td, None)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(9))

    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        a, b = float(tmet[k]), float(jmet[k])
        tol = 5e-4 if k == "loss_div" else 1e-4
        assert abs(a - b) <= tol * abs(b) + 1e-7, (k, a, b)
    got_s = jax_variables(state.student, vs)
    _compare(got_s["params"], js.params["student"], 1e-4, "student")
    _compare(got_s["batch_stats"], js.batch_stats["student"], 1e-4,
             "student_bs")
    if aux_p:
        got_p, got_bs = jax_aux_variables(state.aux, aux_p, aux_bs)
        _compare(got_p, js.params["aux"], 1e-4, "aux")
    for path, g, w in walk_pairs(jax_variables(state.teacher, vt), vt):
        np.testing.assert_array_equal(g, w, err_msg=path)
    if method == "crd":
        for k in ("v1", "v2", "z_v1", "z_v2"):
            assert_close_scaled(getattr(state.extra, k).numpy(),
                                np.asarray(getattr(js.extra, k)), 1e-4, k)
