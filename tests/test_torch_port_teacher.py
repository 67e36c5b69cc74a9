"""Supervised teacher training and cross-arch detection: moma_tpu_torch
against moma_tpu on the CPU.

- Two vanilla steps of effiB0 at 64^2, batch 4, float32, no augmentation,
  from the same weights (moma_tpu_torch.interop) through
  `make_vanilla_train_step` of both packages: each step's loss within 1e-5
  of its size, every parameter and BN running statistic after the two
  steps within 1e-4 of each tensor's scale (floored at 1e-3 of its group's
  scale, torch_port_helpers.assert_close_scaled), and the update of the
  parameters over the two steps within 2e-3 of its scale, as
  tests/test_torch_port_moma_step.py holds updates.
- `run_teacher`: a --resume round trip (1 epoch, then 2) equals the
  straight 2-epoch run bit for bit, and so does a resume from a SIGTERM
  save after step 1; its `best_acc.pt` loads through --tec_pre (MoMA),
  --path_t (kd) and --std_pre, strict and without the classifier.
- The flag refusals of moma_tpu's run_teacher and those of the port.
- Cross-arch detection compares shapes: a ViT-Ti student with a ViT-S
  teacher (the registry's two, full size) and effiB1 <- effiB2 are
  cross-arch, effiB0 <- effiB0 is not.  One MoMA step of a ViT-Ti-wide
  student (dim 192, 3 heads) with a ViT-S-wide teacher (dim 384, 6 heads),
  both at depth 2 and 32^2, patch 16, against moma_tpu's
  `make_moma_train_step(cross_arch=True)`: the step moma_tpu would take if
  it detected the pair, with the tolerances of
  tests/test_torch_port_cross_arch.py (losses and values 1e-4, loss_div
  5e-4).
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
from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.moma import cmo as jcmo
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.train.moma import make_moma_train_step as j_make_moma_step
from moma_tpu.train.state import MomaState as JMomaState
from moma_tpu.train.state import TrainState as JTrainState
from moma_tpu.train.state import make_sgd as j_make_sgd
from moma_tpu.train.steps import make_vanilla_train_step as j_vanilla_step

from moma_tpu_torch.cli import train_teacher
from moma_tpu_torch.core.config import (Config, DistillConfig, ModelConfig,
                                        MomaConfig, parse_student_args,
                                        parse_teacher_args)
from moma_tpu_torch.core.preempt import GracefulStop
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data.pipeline import ArrayDataset
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.models.vit_moe import MoEVisionTransformer
from moma_tpu_torch.moma import cmo
from moma_tpu_torch.moma.queue import QueueState
from moma_tpu_torch.train import teacher as teacher_train
from moma_tpu_torch.train.moma import (build_state, is_cross_arch,
                                       make_moma_train_step)
from moma_tpu_torch.train.state import MomaState, TrainState, make_sgd
from moma_tpu_torch.train.steps import make_vanilla_train_step
from moma_tpu_torch.train.student import build_distill_state

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS = 4, 64, 4
LR, EPOCHS, STEPS_PER_EPOCH = 0.05, 5, 4


def _batches(n, size=HW):
    rs = np.random.RandomState(7)
    return [{"image": rs.randn(B, size, size, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int32)}
            for _ in range(n)]


def test_vanilla_steps_match_jax():
    model = efficientnet_b0(num_classes=N_CLS)
    v0 = make_init_ordered(model, (2, HW, HW, 3))(jax.random.PRNGKey(0))
    batches = _batches(2)

    tx = j_make_sgd(j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
                    0.9, 5e-4)
    # one jitted init: eagerly, its zeros compile one program per shape
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=v0["params"],
                     batch_stats=v0["batch_stats"],
                     opt_state=jax.jit(tx.init)(v0["params"]), tx=tx,
                     apply_fn=model.apply)
    # compiled with LLVM's optimizer off: the step runs twice
    jstep = quick_compiled(j_vanilla_step(augment_fn=None, donate=False))
    jm = []
    for b in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                      jax.random.PRNGKey(9))
        jm.append({k: float(v) for k, v in m.items()})

    net = EfficientNet("b0", num_classes=N_CLS)
    load_jax_variables(net, v0)
    ts = TrainState(model=net, optimizer=make_sgd(net.parameters(), 0.9,
                                                  5e-4),
                    schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH,
                                         cosine=True))
    step = make_vanilla_train_step(None)
    tm = []
    for b in batches:
        ts, m = step(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                     torch.Generator().manual_seed(9))
        tm.append({k: float(v) for k, v in m.items()})

    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
        assert (a["acc1"], a["acc5"]) == (b["acc1"], b["acc5"])
    assert ts.step == int(js.step) == 2
    got = jax_variables(ts.model, v0)
    for name, ref in (("params", js.params), ("batch_stats",
                                               js.batch_stats)):
        ref = jax.device_get(ref)
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got[name], ref, name):
            assert_close_scaled(g, w, 1e-4, path, floor)
    upd = jax.tree_util.tree_map(lambda r, i: np.asarray(r) - np.asarray(i),
                                 jax.device_get(js.params), v0["params"])
    floor = group_floor(upd)
    init = {p: w for p, _, w in walk_pairs(v0["params"], v0["params"])}
    for path, g, w in walk_pairs(got["params"], upd):
        assert_close_scaled(np.asarray(g) - init[path], w, 2e-3,
                            path + " update", floor)


# ---------------------------------------------------------------- runs

ARGS = ["--device", "cpu", "--dataset", "prostate_hv", "--model", "effiB0",
        "--image_size", "32", "--batch_size", "4", "--fp32", "--print_freq",
        "1", "--learning_rate", "0.05", "--weight_decay", "1e-4"]


@pytest.fixture
def small_sets(monkeypatch):
    """The synthetic sets cut to 8 train (2 steps an epoch), 4 val and 4
    test images."""
    full = teacher_train.build_datasets

    def cut(cfg, synthetic):
        return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (8, 4, 4)))

    monkeypatch.setattr(teacher_train, "build_datasets", cut)


def _run(save, epochs, *extra, stop=None):
    cfg = parse_teacher_args(ARGS + ["--save_dir", str(save), "--epochs",
                                     str(epochs), *extra])
    return teacher_train.run_teacher(cfg, synthetic=True, stop=stop)


def _losses(result):
    with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


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
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The straight 2-epoch teacher run, once for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        full = teacher_train.build_datasets
        mp.setattr(teacher_train, "build_datasets", lambda cfg, syn: tuple(
            ArrayDataset(ds.images[:k], ds.labels[:k])
            for ds, k in zip(full(cfg, syn), (8, 4, 4))))
        state, result = _run(tmp_path_factory.mktemp("straight"), 2)
    torch.set_num_threads(n)
    return teacher_train.teacher_full_state(state), result


def test_teacher_resume_equals_the_straight_run(tmp_path, small_sets,
                                                straight):
    want_state, want = straight
    _, first = _run(tmp_path / "resumed", 1)
    state, got = _run(tmp_path / "resumed", 2, "--resume")
    assert [r["epoch"] for r in got["epochs"]] == [2] and state.step == 4
    assert _losses(got) == _losses(want)
    _equal(teacher_train.teacher_full_state(state), want_state)
    assert (got["best_acc"], got["best_f1"]) == (want["best_acc"],
                                                 want["best_f1"])
    run = os.path.basename(got["run_dir"])
    assert run.startswith("teacher_") and "effiB0" in run
    files = sorted(os.path.relpath(os.path.join(d, f), got["run_dir"])
                   for d, _, fs in os.walk(got["run_dir"]) for f in fs
                   if not d.endswith("tb"))
    assert files == ["ckpt/best_acc.meta.json", "ckpt/best_acc.pt",
                     "ckpt/best_f1.meta.json", "ckpt/best_f1.pt",
                     "ckpt/latest.meta.json", "ckpt/latest.pt",
                     "parameters.json", "scalars.jsonl", "stat.json"]
    with open(os.path.join(got["run_dir"], "parameters.json")) as f:
        assert set(json.load(f)) == {"config", "num_params_M",
                                     "best_val_acc", "best_val_f1", "hours"}
    with open(os.path.join(want["run_dir"], "stat.json")) as f:
        row = json.load(f)["2"]
    assert {"test_loss", "test_acc", "test_f1", "val_f1"} <= set(row)


def test_teacher_preemption_resumes_mid_epoch(tmp_path, small_sets,
                                              monkeypatch, straight):
    want_state, want = straight
    guard = GracefulStop(signals=())
    make = teacher_train.make_vanilla_train_step

    def stopping(*a, **k):
        step = make(*a, **k)

        def counted(*sa):
            out = step(*sa)
            guard.request()
            return out
        return counted

    monkeypatch.setattr(teacher_train, "make_vanilla_train_step", stopping)
    state, res = _run(tmp_path / "p", 2, stop=guard)
    monkeypatch.setattr(teacher_train, "make_vanilla_train_step", make)
    assert res.get("preempted") and state.step == 1
    with open(os.path.join(res["run_dir"], "ckpt",
                           "latest.meta.json")) as f:
        assert json.load(f) == {"epoch": 0, "preempted": True,
                                "resume_step": 1}
    state, got = _run(tmp_path / "p", 2, "--resume")
    assert state.step == 4 and _losses(got) == _losses(want)
    _equal(teacher_train.teacher_full_state(state), want_state)


def test_teacher_checkpoint_loads_as_teacher_and_student(straight, tmp_path):
    want_state, want = straight
    best = os.path.join(want["run_dir"], "ckpt", "best_acc.pt")
    saved = torch.load(best, weights_only=True)["teacher"]
    moma = parse_student_args([
        "--device", "cpu", "--dataset", "prostate_hv", "--model_s", "effiB0",
        "--model_t", "effiB0", "--distill", "moma", "--head", "mlp",
        "--image_size", "32", "--batch_size", "4", "--nce_k", "16",
        "--feat_dim", "16", "--fp32", "--tec_pre", best, "--std_pre", best])
    state = build_state(moma, torch.device("cpu"), 2, 0)
    for net in (state.teacher, state.student):
        _equal(net.state_dict(), saved)
    kd = parse_student_args([
        "--device", "cpu", "--dataset", "prostate_hv", "--model_s", "effiB0",
        "--model_t", "effiB0", "--distill", "kd", "--image_size", "32",
        "--batch_size", "4", "--fp32", "--path_t", best])
    dstate, _ = build_distill_state(kd, torch.device("cpu"), 2, 0, 8)
    _equal(dstate.teacher.state_dict(), saved)
    # without the classifier: another label count keeps its own
    other = EfficientNet("b0", num_classes=7)
    head = other.classifier.weight.clone()
    load_pretrained(other, best, strict=False)
    sd = other.state_dict()
    _equal({k: v for k, v in sd.items() if not k.startswith("classifier.")},
           {k: v for k, v in saved.items()
            if not k.startswith("classifier.")})
    assert torch.equal(sd["classifier.weight"], head)
    with pytest.raises(Exception):
        load_pretrained(EfficientNet("b0", num_classes=7), best, strict=True)


def test_cli_trains_a_vit_teacher(small_sets, tmp_path):
    """Any registered backbone; a ViT sized from --image_size."""
    argv = [a if a != "effiB0" else "vit_tiny_patch16_224" for a in ARGS]
    state, result = train_teacher.main(
        argv + ["--synthetic", "--epochs", "1", "--save_dir", str(tmp_path)])
    assert isinstance(state.model, VisionTransformer) and state.step == 2
    assert np.isfinite(result["train"]["loss"])


@pytest.mark.parametrize("extra,exc", [
    (["--bn", "local"], ValueError), (["--model_parallel", "2"], ValueError),
    (["--grad_accum", "3"], ValueError),
    (["--model", "vit_tiny_moe_patch16_224"], None),
])
def test_teacher_refusals(extra, exc, tmp_path, small_sets):
    """The JAX package's refusals; --grad_accum 3 splits no batch of 4
    (its ValueError).  The MoE ViTs are ported ([5b-teachers] (a)): the
    case that named one now trains it (exc None), its gradients through
    the router's gates."""
    if exc is None:
        state, result = _run(tmp_path, 1, *extra)
        assert isinstance(state.model, MoEVisionTransformer)
        assert state.step == 2 and np.isfinite(result["train"]["loss"])
        return
    with pytest.raises(exc):
        _run(tmp_path, 1, *extra)


@pytest.mark.parametrize("extra", [
    ["--scoped_vmem_kib", "0"], ["--sync_bn"],
])
def test_teacher_flags_the_port_would_ignore_are_refused(extra, capsys):
    with pytest.raises(SystemExit):
        parse_teacher_args(ARGS + extra)
    assert "unrecognized arguments" in capsys.readouterr().err


# ---------------------------------------------------------- cross-arch

def test_cross_arch_detection_compares_shapes():
    def make(name, size=224):
        return create_model(name, N_CLS, image_size=size)

    assert is_cross_arch(make("vit_tiny_patch16_224"),
                         make("vit_small_patch16_224"))
    assert is_cross_arch(make("effiB1"), make("effiB2"))
    assert not is_cross_arch(make("effiB0"), make("effiB0"))
    assert is_cross_arch(make("effiB0"), make("vit_tiny_patch16_224"))


VIT_S = dict(patch_size=16, dim=384, depth=2, num_heads=6)
VIT_T = dict(patch_size=16, dim=192, depth=2, num_heads=3)
X_HW, K, FEAT, ALPHA = 32, 16, 32, 0.99


def test_vit_pair_trains_a_cross_arch_step_like_jax():
    js_mod, jt_mod = JViT(num_classes=N_CLS, **VIT_T), JViT(
        num_classes=N_CLS, **VIT_S)
    shape = (2, X_HW, X_HW, 3)
    vs = make_init_ordered(js_mod, shape)(jax.random.PRNGKey(0))
    vt = make_init_ordered(jt_mod, shape)(jax.random.PRNGKey(1))
    ve = make_init_ordered(js_mod, shape)(jax.random.PRNGKey(4))
    jheads = jcmo.CMOHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=192,
                           t_dim=384, include_ema=True)
    cmo_v = ordered_numpy({"params": heads_init(jheads, 2)[0]})
    rs = np.random.RandomState(3)
    mem = rs.randn(K, FEAT).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    rs = np.random.RandomState(8)
    batch = {"image": rs.randn(B, X_HW, X_HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
             "shuffle_perm": rs.permutation(B).astype(np.int32)}

    jc = JConfig()
    jc.model_t = JModel(name="vit_small_patch16_224", n_cls=N_CLS)
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                    mem="MoCo", head="mlp", attn="self")
    tx = j_make_sgd(j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True),
                    0.9, 5e-4)
    params = {"student": vs["params"], "cmo": cmo_v["params"]}
    jstate = JMomaState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": {}, "cmo": {}},
        teacher_params=vt["params"], teacher_batch_stats={},
        queue=JQueue(memory={"memory": jnp.asarray(mem)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=jax.jit(tx.init)(params), tx=tx,
        ema_params=ve["params"], ema_batch_stats={},
        apply_fn=js_mod.apply, teacher_apply_fn=jt_mod.apply)
    jstep = quick_compiled(j_make_moma_step(
        jc, jheads, augment_fn=None, donate=False, cross_arch=True,
        kl_train_bn_override=True))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(9))

    def vit(cfg):
        return VisionTransformer(cfg["patch_size"], cfg["dim"], cfg["depth"],
                                 cfg["num_heads"], N_CLS, X_HW)

    student, teacher, ema = vit(VIT_T), vit(VIT_S), vit(VIT_T)
    assert is_cross_arch(student, teacher)
    heads = cmo.CMOHeads("mlp", "self", FEAT, s_dim=192, t_dim=384,
                         include_ema=True)
    for m, v in ((student, vs), (teacher, vt), (ema, ve), (heads, cmo_v)):
        load_jax_variables(m, v)
    for m in (teacher, ema, heads.embed_t, heads.embed_ema):
        m.requires_grad_(False)
    state = MomaState(student=student, teacher=teacher, heads=heads, ema=ema,
                      queue=QueueState({"memory": torch.from_numpy(
                          mem.copy())}), optimizer=None,
                      schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH,
                                           cosine=True))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    tc = Config()
    tc.model_s = ModelConfig(name="vit_tiny_patch16_224", n_cls=N_CLS)
    tc.model_t = ModelConfig(name="vit_small_patch16_224", n_cls=N_CLS)
    tc.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                         mem="MoCo", head="mlp", attn="self")
    step = make_moma_train_step(tc, None, kl_train_bn_override=True,
                                cross_arch=True)
    state, tm = step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                     torch.Generator().manual_seed(9))
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        tol = 5e-4 if k == "loss_div" else 1e-4
        a, b = float(tm[k]), float(jm[k])
        assert abs(a - b) <= tol * abs(b), (k, a, b)
    groups = {"student": (jax_variables(student, vs)["params"],
                          jstate.params["student"]),
              "ema": (jax_variables(ema, ve)["params"], jstate.ema_params),
              "cmo": (jax_variables(heads, cmo_v)["params"],
                      jstate.params["cmo"])}
    for name, (got, ref) in groups.items():
        ref = jax.device_get(ref)
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got, ref, name):
            assert_close_scaled(g, w, 1e-4, path, floor)
    assert_close_scaled(state.queue.memory["memory"].numpy(),
                        np.asarray(jstate.queue.memory["memory"]), 1e-4,
                        "queue")
