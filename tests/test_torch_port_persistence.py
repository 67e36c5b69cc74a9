"""The run around the MoMA step: checkpoints, --resume, preemption, the
statistics files and the optimizer's options, on the CPU.

Runs are effiB0 at 32^2, batch 4, K 64, feat_dim 16, float32, with the
synthetic sets cut to 8 training images (2 steps an epoch) and 4 val / 4
test images; every run writes under pytest's tmp_path (--save_dir).

- A run of 1 epoch resumed to 2 equals the straight 2-epoch run bit for
  bit: every step's logged loss, every tensor of the final state (both
  backbones and their BN buffers, heads, queue banks, momentum buffers),
  the queue pointer and the step count.  Tolerance 0: on the CPU the step
  is deterministic, and the resume restores every input of the next step.
- The same from a preemption save after step 1 of epoch 1: `latest`
  says `"preempted": true, "resume_step": 1`, and the resumed run takes
  exactly the 3 remaining steps.
- The best-metric thresholds are read back from their meta files.
- The port's TBWriter writes the bytes of moma_tpu's for the same scalars
  at the same wall time, and the stat.json row keys are those moma_tpu's
  epoch loop writes for the same config.
- make_sgd with grad_clip, trust_ratio and nesterov follows moma_tpu's
  optax chain over 3 updates: rtol 1e-6 of each element, floored at 1e-6
  of the tensor's largest magnitude (the two sum the global norm and the
  per-tensor norms in different orders).
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.core.preempt import GracefulStop
from moma_tpu_torch.data.pipeline import ArrayDataset
from moma_tpu_torch.train import moma as moma_train
from moma_tpu_torch.train.moma import full_state, run_moma

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s", "effiB0",
        "--model_t", "effiB0", "--distill", "moma", "--head", "mlp",
        "--attn", "self", "--image_size", "32", "--batch_size", "4",
        "--nce_k", "64", "--feat_dim", "16", "--fp32", "-b", "1",
        "--print_freq", "1"]


def _cut_sets(monkeypatch):
    full = moma_train.build_datasets

    def cut(cfg, synthetic):
        return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (8, 4, 4)))

    monkeypatch.setattr(moma_train, "build_datasets", cut)


@pytest.fixture
def small_sets(monkeypatch):
    _cut_sets(monkeypatch)


def _stop_after(monkeypatch, guard, n_steps):
    """The step programs built from here on request `guard` to stop when
    the `n_steps`-th step (counted over all of them) has run."""
    make = moma_train.make_moma_train_step
    done = [0]

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def counted(*sa):
            out = step(*sa)
            done[0] += 1
            if done[0] == n_steps:
                guard.request()
            return out
        return counted

    monkeypatch.setattr(moma_train, "make_moma_train_step", wrapped)


def _run(save_dir, epochs, *extra, stop=None):
    cfg = parse_student_args(ARGS + ["--save_dir", str(save_dir),
                                     "--epochs", str(epochs), *extra])
    return run_moma(cfg, synthetic=True, stop=stop)


def _losses(result):
    with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def _assert_equal_states(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_states(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_states(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The straight 2-epoch run, once for the module's resume tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _cut_sets(mp)
        state, result = _run(tmp_path_factory.mktemp("straight"), 2)
    torch.set_num_threads(n)
    return full_state(state), result


def test_resume_equals_the_straight_run(tmp_path, small_sets, straight):
    want_state, want = straight
    _, first = _run(tmp_path / "resumed", 1)
    assert first["epochs"][-1]["epoch"] == 1
    state, got = _run(tmp_path / "resumed", 2, "--resume")
    assert [r["epoch"] for r in got["epochs"]] == [2]
    assert state.step == 4 and state.queue.ptr == (4 * 4) % 64
    assert _losses(got) == _losses(want)
    _assert_equal_states(full_state(state), want_state)
    assert (got["best_acc"], got["best_f1"]) == (want["best_acc"],
                                                 want["best_f1"])
    with open(os.path.join(got["run_dir"], "stat.json")) as f:
        rows = json.load(f)
    with open(os.path.join(want["run_dir"], "stat.json")) as f:
        rows_want = json.load(f)
    assert sorted(rows) == ["1", "2"]
    for ep in ("1", "2"):
        for k in ("train_loss", "train_acc", "val_loss", "val_acc", "val_f1",
                  "test_acc", "test_f1"):
            assert rows[ep][k] == rows_want[ep][k], (ep, k)
    for name in ("parameters.json", "ckpt/latest.pt", "ckpt/best_acc.pt",
                 "ckpt/best_f1.pt", "ckpt/latest.meta.json"):
        assert os.path.isfile(os.path.join(got["run_dir"], name)), name
    assert os.listdir(os.path.join(got["run_dir"], "tb"))


def test_resume_from_a_preemption_save(tmp_path, small_sets, straight,
                                       monkeypatch):
    want_state, want = straight
    guard = GracefulStop()
    _stop_after(monkeypatch, guard, 1)
    state, first = _run(tmp_path / "preempted", 2, stop=guard)
    assert first["preempted"] and state.step == 1
    with open(os.path.join(first["run_dir"], "ckpt",
                           "latest.meta.json")) as f:
        meta = json.load(f)
    assert meta == {"epoch": 0, "preempted": True, "resume_step": 1}
    # the wrapped steps request no stop again: their count is past 1
    state, got = _run(tmp_path / "preempted", 2, "--resume")
    # the resumed run took exactly the 3 remaining steps
    assert [s for s, _ in _losses(got)] == [1, 2, 3, 4]
    assert state.step == 4
    assert got["epochs"][0]["train_partial_from"] == 1
    assert _losses(got) == _losses(want)
    _assert_equal_states(full_state(state), want_state)


def test_best_metric_thresholds_survive_a_resume(tmp_path, small_sets):
    _, first = _run(tmp_path, 1)
    ckpt = os.path.join(first["run_dir"], "ckpt")
    before = {}
    for tag, key, value in (("best_acc", "val_acc", 101.0),
                            ("best_f1", "val_f1", 2.0)):
        path = os.path.join(ckpt, f"{tag}.meta.json")
        with open(path) as f:
            meta = json.load(f)
        assert meta["epoch"] == 1
        meta[key] = value   # above anything an epoch can reach
        with open(path, "w") as f:
            json.dump(meta, f)
        with open(os.path.join(ckpt, f"{tag}.pt"), "rb") as f:
            before[tag] = f.read()
    _, got = _run(tmp_path, 2, "--resume")
    assert got["best_acc"] == 101.0 and got["best_f1"] == 2.0
    for tag in before:   # no epoch beat the carried thresholds
        with open(os.path.join(ckpt, f"{tag}.pt"), "rb") as f:
            assert f.read() == before[tag], tag
    with open(os.path.join(ckpt, "latest.meta.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_tb_writer_bytes_match_jax(tmp_path, monkeypatch):
    from moma_tpu.core import tb_writer as J
    from moma_tpu_torch.core import tb_writer as T

    for mod in (J, T):
        monkeypatch.setattr(mod.time, "time", lambda: 1234567890.25)
    paths = []
    for mod, d in ((J, "jax"), (T, "port")):
        w = mod.TBWriter(str(tmp_path / d))
        w.scalar("epoch/val_acc", 61.5, 3)
        w.scalars(17, loss=0.125, acc1=-2.0)
        w.scalar("big", 3.0e38, 2 ** 40)
        w.close()
        paths.append(w.path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        ref = a.read()
        assert ref == b.read() and len(ref) > 100
    assert T.crc32c(b"123456789") == J.crc32c(b"123456789") == 0xE3069283


def test_stat_json_rows_have_the_jax_keys(tmp_path, small_sets, monkeypatch):
    """moma_tpu's epoch loop, its train and eval stubbed, writes the row
    of one epoch; the port's run of the same config writes the same
    keys."""
    from moma_tpu.core.checkpoint import StatsWriter as JStats
    from moma_tpu.core.config import parse_student_args as j_parse
    from moma_tpu.core.preempt import NEVER
    from moma_tpu.train import moma as JM

    monkeypatch.setattr(JM, "train_one_epoch", lambda state, *a, **k: (
        state, {"loss": 1.0, "acc1": 2.0, "acc5": 3.0, "ips": 4.0,
                "steps": 2}))
    monkeypatch.setattr(JM, "evaluate", lambda *a, **k: {
        "loss": 1.0, "acc": 50.0, "f1": 0.5, "conf_mat": [], "n": 4})
    ckpt = types.SimpleNamespace(save=lambda *a, **k: None,
                                 wait=lambda: None)
    jstate = types.SimpleNamespace(params={"student": None},
                                   batch_stats={"student": None})
    jargv = [a for a in ARGS if a not in ("--device", "cpu")]
    jcfg = j_parse(jargv + ["--epochs", "1"])
    jdir = tmp_path / "jax"
    JM._epoch_loop_moma(
        jcfg, jstate, JStats(str(jdir)), ckpt, NEVER, None, None, [None, None],
        None, None, None, None, jcfg.model_s.n_cls, 1, -1.0, -1.0, 0.0,
        str(jdir), lambda s: {})
    _, got = _run(tmp_path / "port", 1)
    with open(jdir / "stat.json") as f:
        want_rows = json.load(f)
    with open(os.path.join(got["run_dir"], "stat.json")) as f:
        got_rows = json.load(f)
    assert list(got_rows) == list(want_rows) == ["1"]
    assert sorted(got_rows["1"]) == sorted(want_rows["1"])
    with open(os.path.join(got["run_dir"], "parameters.json")) as f:
        assert set(json.load(f)) == {"config", "best_val_acc", "best_val_f1",
                                     "hours"}


@pytest.mark.parametrize("clip,trust,nesterov", [
    (0.5, 0.0, False), (0.0, 1e-3, False), (0.5, 1e-3, True),
    (100.0, 0.0, True), (0.0, 0.0, True),
], ids=["clip", "lars", "clip-lars-nesterov", "clip-unreached-nesterov",
        "nesterov"])
def test_make_sgd_matches_the_optax_chain(clip, trust, nesterov):
    from moma_tpu.train.state import make_sgd as j_make_sgd
    from moma_tpu_torch.train.state import make_sgd

    import optax

    rs = np.random.RandomState(11)
    shapes = {"conv": (3, 3, 2, 5), "dense": (8, 4), "bias": (4,),
              "zero": (3, 2)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    init["zero"][:] = 0.0   # a zero-norm weight: the trust ratio's guard
    lrs = np.array([0.1, 0.05, 0.02], np.float32)
    grads = [{k: (rs.randn(*s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in lrs]
    grads[1]["dense"][:] = 0.0   # a zero-norm update: the other guard

    tx = j_make_sgd(lambda c: jnp.asarray(lrs)[c], momentum=0.9,
                    weight_decay=5e-4, nesterov=nesterov, grad_clip=clip,
                    trust_ratio=trust)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jst = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = make_sgd(tp.values(), momentum=0.9, weight_decay=5e-4,
                   nesterov=nesterov, grad_clip=clip, trust_ratio=trust)
    for lr, g in zip(lrs, grads):
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()
        for k, p in tp.items():
            want = np.asarray(jp[k])
            floor = 1e-6 * float(np.abs(want).max())
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                       atol=floor, err_msg=k)
    # the options' momentum buffers ride in the optimizer's state dict,
    # which the checkpoint saves
    assert len(opt.state_dict()["state"]) == len(tp)
