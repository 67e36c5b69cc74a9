"""--remat, EfficientNet(block_remat=True) and EfficientNet(stem_s2d=2|4) on
the CPU, against the port's own plain versions and against moma_tpu.

- `--remat` recomputes the student forward in the backward
  (models/remat.py).  The vanilla, kd and MoMA steps (MoCo, MoCoSSTT
  whose second student view is recomputed too, and the cross-arch EmaTec
  step with a ViT teacher) with it equal the same
  steps without it bit for bit after two steps: losses, every parameter
  and every BatchNorm buffer.  The replay recomputes the same float32
  values on the CPU (the same ops on the same inputs), so nothing is left
  to a tolerance; the running statistics show that the replay wrote none
  (a second write moves them by about 1% of the batch statistics).  The
  replay's BatchNorm forwards are counted.
- The MoMA remat step is held once against moma_tpu's
  `make_moma_train_step` with `cfg.run.remat = True` (effiB0 at 64^2,
  batch 4), with test_torch_port_moma_step's one-step tolerances.
- `block_remat` and `stem_s2d`: the train-mode forward, the input gradient
  and the running statistics against moma_tpu's EfficientNet with the same
  options at 64^2 (1e-4 of scale; gradients 1e-3, as
  test_torch_port_effnet), the state-dict keys those of the standard
  model, and block_remat against the port's standard model bit for bit,
  with drop-connect masks from a generator drawn the same in the replay.
- `--remat` trains through both CLIs at --device cpu, and `--num_workers`
  reaches the native prefetcher of a packed imagefolder dataset.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu_torch.cli import train_student, train_teacher
from moma_tpu_torch.core.config import parse_student_args, parse_teacher_args
from moma_tpu_torch.data import native
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet, stem_s2d_conv
from moma_tpu_torch.ops import fused_bn
from moma_tpu_torch.train.moma import build_state, make_moma_train_step
from moma_tpu_torch.train.state import TrainState, make_sgd
from moma_tpu_torch.train.steps import make_vanilla_train_step
from moma_tpu_torch.train.student import build_distill_state
from moma_tpu_torch.train.distill import make_distill_train_step

import test_torch_port_moma_step as moma_step
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                jax_template, make_init_ordered,
                                ordered_numpy, quick_jit, tree_template,
                                walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")


@pytest.fixture
def bn_forwards(monkeypatch):
    """Counts train-mode BatchNorm forwards (the channel-sum calls)."""
    calls = [0]
    orig = fused_bn.FusedBNTrain.forward

    def counting(ctx, *a):
        calls[0] += 1
        return orig(ctx, *a)

    monkeypatch.setattr(fused_bn.FusedBNTrain, "forward",
                        staticmethod(counting))
    return calls


def _batch(n, hw, n_cls, seed=0):
    rs = np.random.RandomState(seed)
    return {"image": torch.from_numpy(rs.rand(n, hw, hw, 3).astype(
                np.float32)),
            "label": torch.from_numpy(rs.randint(0, n_cls, n)),
            "index": torch.arange(n, dtype=torch.int32),
            "shuffle_perm": torch.from_numpy(rs.permutation(n))}


def _snapshot(*modules):
    return [copy.deepcopy(m.state_dict()) for m in modules]


def _assert_bitwise(a, b):
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def _two_steps(make, step_fn, batch, modules):
    """Losses of two steps and the modules' state dicts after them."""
    state = make()
    losses = []
    for i in range(2):
        state, m = step_fn(state, batch, torch.Generator().manual_seed(i))
        losses.append({k: float(v) for k, v in m.items()
                       if k.startswith("loss")})
    return losses, _snapshot(*modules(state))


def test_vanilla_remat_step_equals_the_plain_step(bn_forwards):
    def make():
        m = EfficientNet("b0", num_classes=4,
                         generator=torch.Generator().manual_seed(0))
        m = m.to(memory_format=torch.channels_last)
        return TrainState(model=m, optimizer=make_sgd(m.parameters(), 0.9,
                                                      5e-4),
                          schedule=lambda s: 0.1)

    batch = _batch(4, 32, 4)
    runs = {}
    for remat in (False, True):
        bn_forwards[0] = 0
        runs[remat] = _two_steps(make, make_vanilla_train_step(remat=remat),
                                 batch, lambda s: (s.model,))
        # 49 BatchNorms a forward, replayed once more under remat
        assert bn_forwards[0] == 2 * 49 * (2 if remat else 1)
    assert runs[True][0] == runs[False][0]
    _assert_bitwise(runs[True][1], runs[False][1])


STUDENT = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s",
           "effiB0", "--model_t", "effiB0", "--image_size", "32",
           "--batch_size", "4", "--fp32", "--nce_k", "16", "--feat_dim",
           "16"]


def test_kd_remat_step_equals_the_plain_step(bn_forwards):
    runs = {}
    for remat in (False, True):
        cfg = parse_student_args(STUDENT + ["--distill", "kd", "-b", "0.5"]
                                 + (["--remat"] if remat else []))
        assert cfg.run.remat == remat
        state, distiller = build_distill_state(cfg, CPU, 4, 0, 4)
        bn_forwards[0] = 0
        step = make_distill_train_step(distiller, None, remat=cfg.run.remat)
        runs[remat] = _two_steps(lambda: state, step, _batch(4, 32, 4),
                                 lambda s: (s.student, s.aux))
        # student 49 (+49 replayed) and the frozen teacher's eval forward
        assert bn_forwards[0] == 2 * 49 * (2 if remat else 1)
    assert runs[True][0] == runs[False][0]
    _assert_bitwise(runs[True][1], runs[False][1])


@pytest.mark.parametrize("mem,teacher", [
    ("MoCo", "effiB0"), ("MoCoSSTT", "effiB0"),
    ("MoCo", "vit_tiny_patch16_224")], ids=["moco", "mocosstt", "ematec"])
def test_moma_remat_step_equals_the_plain_step(bn_forwards, mem, teacher):
    runs = {}
    for remat in (False, True):
        cfg = parse_student_args(
            STUDENT + ["--distill", "moma", "--head", "mlp", "--mem", mem,
                       "-b", "1", "--model_t", teacher]
            + (["--remat"] if remat else []))
        state = build_state(cfg, CPU, 4, 0)
        step = make_moma_train_step(cfg, None, kl_train_bn_override=True,
                                    cross_arch=state.ema is not None)
        assert (state.ema is not None) == (teacher != "effiB0")
        bn_forwards[0] = 0
        runs[remat] = _two_steps(
            lambda: state, step, _batch(4, 32, 4),
            lambda s: (s.student, s.teacher, s.heads)
            + ((s.ema,) if s.ema is not None else ()))
        # student + two train-mode teacher-side forwards (KL and key; the
        # EmaTec step: the EMA copy's key forward and the ViT's eval-mode
        # KL forward, no BN); MoCoSSTT a second student view
        views = 2 if mem == "MoCoSSTT" else 1
        others = 1 if state.ema is not None else 2
        assert bn_forwards[0] == 2 * 49 * (others
                                           + views * (2 if remat else 1))
    assert runs[True][0] == runs[False][0]
    _assert_bitwise(runs[True][1], runs[False][1])


def test_moma_remat_step_matches_jax():
    """moma_tpu's step with cfg.run.remat = True (jax.checkpoint around the
    student forward), one train-BN step, through test_torch_port_moma_step's
    harness and with its one-step tolerances.  The weights are the port's
    own seeded ones, carried into JAX layout through templates (abstract
    traces: no init program is compiled)."""
    from moma_tpu.moma.cmo import CMOHeads as JHeads
    from moma_tpu_torch.moma.cmo import CMOHeads

    ms = moma_step
    model = efficientnet_b0(num_classes=ms.N_CLS)
    tmpl = jax_template(model, (2, ms.HW, ms.HW, 3))
    vs, vt = (jax_variables(EfficientNet(
        "b0", num_classes=ms.N_CLS,
        generator=torch.Generator().manual_seed(i)), tmpl) for i in (0, 1))
    jheads = JHeads(head="mlp", attn="self", feat_dim=ms.FEAT, s_dim=1280,
                    t_dim=1280)
    heads = CMOHeads("mlp", "self", ms.FEAT, s_dim=1280, t_dim=1280,
                     generator=torch.Generator().manual_seed(2))
    cmo = ordered_numpy(jax_variables(heads, {"params": tree_template(
        jheads.init, jax.random.PRNGKey(2))[0]}))
    rs = np.random.RandomState(3)
    mem = rs.randn(ms.K, ms.FEAT).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    ms._check_against_jax((model, jheads, vs, vt, cmo, mem), (True,), 1e-4,
                          5e-4, 2e-3, "off", remat=True)


# ----------------------------------------------- block_remat / stem_s2d

HW = 64


@pytest.fixture(scope="module")
def effnet_vars():
    v = make_init_ordered(efficientnet_b0(num_classes=4),
                          (2, HW, HW, 3))(jax.random.PRNGKey(0))
    x = np.random.RandomState(2).randn(4, HW, HW, 3).astype(np.float32)
    w = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    return v, x, w


@pytest.mark.parametrize("kw", [{"block_remat": True, "stem_s2d": 4},
                                {"stem_s2d": 2}],
                         ids=["block_remat-s2d4", "s2d2"])
def test_efficientnet_options_match_jax(effnet_vars, kw):
    v, x, w = effnet_vars
    jm = efficientnet_b0(num_classes=4, **kw)

    def loss(x):
        (feats, logits), mut = jm.apply(v, x, train=True,
                                        mutable=["batch_stats"])
        return (jnp.sum(logits * w) + jnp.sum(feats[-1]) * 1e-2,
                (feats, logits, mut["batch_stats"]))

    (_, (jf, jl, jbs)), jgx = quick_jit(jax.value_and_grad(
        loss, has_aux=True))(jnp.asarray(x))

    tm = EfficientNet("b0", num_classes=4, **kw).to(
        memory_format=torch.channels_last)
    assert list(tm.state_dict()) == list(
        EfficientNet("b0", num_classes=4).state_dict())
    load_jax_variables(tm, v)
    tm.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    tf, tl = tm(tx)
    ((tl * torch.from_numpy(w)).sum() + tf[-1].sum() * 1e-2).backward()
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert_close_scaled(a.detach().numpy(), np.asarray(b), 1e-4,
                            f"feat {i}")
    assert_close_scaled(tl.detach().numpy(), np.asarray(jl), 1e-4, "logits")
    assert_close_scaled(tx.grad.numpy(), np.asarray(jgx), 1e-3, "dx")
    jbs = jax.device_get(jbs)
    floor = group_floor(jbs)
    for path, a, b in walk_pairs(jax_variables(tm, v)["batch_stats"], jbs,
                                 "bs"):
        assert_close_scaled(a, b, 1e-4, path, floor)


def test_block_remat_equals_the_standard_model_with_drop_connect(
        bn_forwards):
    """A generator's drop-connect masks are drawn again the same in each
    block's replay: gradients, running statistics and the generator's
    final state equal the standard model's bit for bit."""
    x = torch.from_numpy(np.random.RandomState(4).randn(
        4, 32, 32, 3).astype(np.float32))
    out = {}
    for remat in (False, True):
        m = EfficientNet("b0", num_classes=4, block_remat=remat,
                         generator=torch.Generator().manual_seed(0))
        m = m.to(memory_format=torch.channels_last).train()
        g = torch.Generator().manual_seed(5)
        bn_forwards[0] = 0
        feats, logits = m(x, generator=g)
        (logits.square().sum() + feats[-1].sum()).backward()
        # the 47 BatchNorms inside the blocks run again in the backward
        assert bn_forwards[0] == 49 + (47 if remat else 0)
        out[remat] = ({k: p.grad for k, p in m.named_parameters()},
                      _snapshot(m), g.get_state())
    for k, grad in out[False][0].items():
        assert torch.equal(out[True][0][k], grad), k
    _assert_bitwise(out[True][1], out[False][1])
    assert torch.equal(out[True][2], out[False][2])


@pytest.mark.parametrize("f", [2, 4])
def test_stem_s2d_refuses_sizes_it_does_not_divide(f):
    x = torch.zeros(1, 3, 4 * f + 1, 8)
    with pytest.raises(ValueError, match=f"stem_s2d={f}"):
        stem_s2d_conv(x, torch.zeros(32, 3, 3, 3), f)
    with pytest.raises(ValueError):
        EfficientNet("b0", num_classes=4, stem_s2d=3)


# ----------------------------------------------------------------- CLIs

def _imagefolder(root, n_train=8, n_val=4, size=40):
    rs = np.random.RandomState(6)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rs.randint(0, 256, (size, size, 3), np.uint8)
                            ).save(d / f"{i}.jpg", quality=90)
    return str(root)


@pytest.fixture
def batcher_threads(monkeypatch):
    seen = []
    start = native.NativeBatcher.start

    def record(self, batch_size, depth=3, threads=8):
        seen.append((batch_size, depth, threads))
        return start(self, batch_size, depth, threads)

    monkeypatch.setattr(native.NativeBatcher, "start", record)
    return seen


@pytest.mark.parametrize("cli", ["student", "teacher"])
def test_remat_and_num_workers_through_the_clis(cli, tmp_path,
                                                batcher_threads):
    data = _imagefolder(tmp_path / "data")
    common = ["--device", "cpu", "--dataset", "imagefolder", "--data_dir",
              data, "--n_cls", "2", "--image_size", "32", "--batch_size",
              "4", "--epochs", "1", "--fp32", "--save_dir",
              str(tmp_path / "runs"), "--remat", "--num_workers", "2"]
    if cli == "student":
        argv = common + ["--model_s", "effiB0", "--model_t", "effiB0",
                         "--distill", "moma", "--head", "mlp", "--nce_k",
                         "16", "--feat_dim", "16"]
        cfg = parse_student_args(argv)
        state, result = train_student.main(argv)
    else:
        argv = common + ["--model", "effiB0"]
        cfg = parse_teacher_args(argv)
        state, result = train_teacher.main(argv)
    assert cfg.run.remat and cfg.data.num_workers == 2
    assert result["train"]["steps"] == 2 and state.step == 2
    assert np.isfinite(result["train"]["loss"])
    # the train loader's native prefetcher: batch 4, depth 4, 2 threads
    assert batcher_threads == [(4, 4, 2)]
    assert os.path.isdir(os.path.join(data, "_moma_pack"))
