"""--std_pre / --tec_pre loading and cli/test_eval against moma_tpu.

effiB0 at 64^2, float32, with JAX-initialised variables (non-trivial BN
running statistics, so eval forwards test them):

- A .pth written by moma_tpu.models.torch_import.save_torch_checkpoint
  (the JAX variables exported into a torch state dict) is loaded by
  moma_tpu.models.pretrained.load_pretrained_params and by the port's
  load_pretrained; the two eval-mode forwards agree to 1e-4 of the
  logits' scale (float32; the packages sum convolutions in different
  orders), strict (same label space) and not strict (a 9-class head kept
  from the target, as in cross-task transfer).
- resolve_pretrain's errors and the refusal of an orbax directory.
- cli.test_eval over a port checkpoint of the same weights equals
  moma_tpu.train.loop.evaluate on the same synthetic test split: the same
  confusion matrix, hence the same accuracy and macro-F1; the loss to
  1e-4 of itself.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.models.pretrained import load_pretrained_params
from moma_tpu.models.torch_import import (export_state_dict,
                                          save_torch_checkpoint)
from moma_tpu_torch.core.checkpoint import CheckpointManager
from moma_tpu_torch.interop import load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.models.pretrained import (PretrainResolutionError,
                                              load_pretrained,
                                              resolve_pretrain)

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, make_init_ordered,
                                ordered_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HW = 64


def _perturbed(v, seed):
    rs = np.random.RandomState(seed)

    def walk(node):
        if "mean" in node:
            node["mean"] = (0.1 * rs.randn(*node["mean"].shape)).astype(
                np.float32)
            node["var"] = (0.5 + rs.rand(*node["var"].shape)).astype(
                np.float32)
        else:
            for child in node.values():
                walk(child)

    walk(v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """4-class JAX variables, their init and their .pth export."""
    jm = efficientnet_b0(num_classes=4)
    init = make_init_ordered(jm, (2, HW, HW, 3))
    v = _perturbed(init(jax.random.PRNGKey(0)), 1)
    template = EfficientNet("b0", num_classes=4)
    sd = export_state_dict(v, {k: t.numpy() for k, t in
                               template.state_dict().items()})
    path = str(tmp_path_factory.mktemp("pre") / "effib0.pth")
    save_torch_checkpoint(path, sd, {"epoch": 3})
    return jm, init, v, path


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "cross-task"])
def test_torch_checkpoint_loads_like_jax(source, strict):
    _, init, _, path = source
    n_cls = 4 if strict else 9
    jm = efficientnet_b0(num_classes=n_cls)
    target = ordered_numpy(init(jax.random.PRNGKey(2)))
    if not strict:   # a 9-class head in the 4-class init's place
        rs = np.random.RandomState(4)
        target["params"]["classifier"] = {
            "kernel": (0.02 * rs.randn(1280, n_cls)).astype(np.float32),
            "bias": np.zeros(n_cls, np.float32)}
    want_vars = load_pretrained_params(target, path, strict=strict)
    tm = EfficientNet("b0", num_classes=n_cls)
    load_jax_variables(tm, target)   # the target's own head, as in JAX
    head = tm.classifier.weight.detach().clone()
    assert load_pretrained(tm, path, strict=strict) is tm
    x = np.random.RandomState(3).randn(4, HW, HW, 3).astype(np.float32)
    _, want = jax.jit(functools.partial(jm.apply, train=False))(want_vars, x)
    tm.eval()
    with torch.no_grad():
        _, got = tm(torch.from_numpy(x))
    assert_close_scaled(got.numpy(), np.asarray(want), 1e-4, "logits")
    if not strict:
        assert torch.equal(tm.classifier.weight, head)


def test_a_wrong_shape_or_architecture_raises(source):
    path = source[-1]
    with pytest.raises(ValueError):   # 4-class classifier into 9 classes
        load_pretrained(EfficientNet("b0", num_classes=9), path,
                        strict=True)
    with pytest.raises(ValueError):   # another stream of convolutions
        load_pretrained(EfficientNet("b1", num_classes=4), path,
                        strict=True)


def test_resolve_pretrain_and_the_orbax_refusal(tmp_path, monkeypatch):
    monkeypatch.delenv("MOMA_PRETRAIN_REGISTRY", raising=False)
    monkeypatch.setenv("MOMA_PRETRAIN_DIR", str(tmp_path / "pre"))
    for spec in (None, "NULL", "None", "scratch", ""):
        assert resolve_pretrain(spec) is None
    with pytest.raises(PretrainResolutionError, match="reference maps"):
        resolve_pretrain("kather19")
    with pytest.raises(PretrainResolutionError, match="not a reference"):
        resolve_pretrain("no_such_tag")
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "mytag.pth").write_bytes(b"")
    assert resolve_pretrain("mytag") == str(tmp_path / "pre" / "mytag.pth")
    reg = tmp_path / "reg.json"
    reg.write_text(json.dumps({"other": "pre/mytag.pth", "gone": "x.pth"}))
    monkeypatch.setenv("MOMA_PRETRAIN_REGISTRY", str(reg))
    assert resolve_pretrain("other") == str(tmp_path / "pre" / "mytag.pth")
    with pytest.raises(PretrainResolutionError, match="missing"):
        resolve_pretrain("gone")
    orbax_dir = tmp_path / "orbax_ckpt"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="export_torch"):
        load_pretrained(EfficientNet("b0", num_classes=4), str(orbax_dir))


def test_test_eval_matches_jax_evaluate(source, tmp_path):
    from moma_tpu.core.mesh import create_mesh, replicated_sharding
    from moma_tpu.data.augment import cifar_eval_normalize
    from moma_tpu.data.pipeline import Loader as JLoader
    from moma_tpu.data.pipeline import synthetic_dataset as j_synthetic
    from moma_tpu.train.loop import evaluate as j_evaluate
    from moma_tpu.train.steps import make_eval_step as j_make_eval_step
    from moma_tpu_torch.cli import test_eval

    jm, _, v, _ = source
    tm = EfficientNet("b0", num_classes=4)
    load_jax_variables(tm, v)
    run = tmp_path / "moma_run"
    CheckpointManager(str(run / "ckpt")).save(
        "best_acc", {"student": tm.state_dict()}, {"epoch": 1})
    out = tmp_path / "test_stat.json"
    got = test_eval.main([
        "--runs", str(tmp_path / "moma_*"), "--synthetic", "--model",
        "effiB0", "--n_cls", "4", "--image_size", str(HW), "--batch_size",
        "32", "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == got
    got = got["moma_run"]

    mesh = create_mesh()
    loader = JLoader(j_synthetic(128, HW, 4, 1), 32, train=False)
    step = j_make_eval_step(jm.apply, 4, normalize_fn=cifar_eval_normalize)
    vv = jax.device_put(v, replicated_sharding(mesh))
    want = j_evaluate(vv["params"], vv["batch_stats"], loader, step, mesh, 4)
    assert got["conf_mat"] == want["conf_mat"]
    assert (got["acc"], got["f1"], got["n"]) == (want["acc"], want["f1"],
                                                 want["n"])
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert set(got) == {"acc", "f1", "loss", "n", "conf_mat"}
