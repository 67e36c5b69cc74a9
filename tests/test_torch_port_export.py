"""The serving export (core/export.py, cli/export_model, cli/serve,
cli/export_torch): moma_tpu_torch against moma_tpu on the CPU.

resnet8 at 32^2, 10 classes, the JAX package's fresh init (PRNGKey(0), as
its CLIs build it) carried into the port by a checkpoint of this package
(`--run`).  Compared:

- the f32 artifact: logits at batches 1, 3 and 5 of one program (symbolic
  batch) against JAX's artifact within 1e-4 (both float32, other summation
  orders), the micro-batched predict, and the artifact served over two
  copies (shard) against one, the padded batch too;
- the artifacts of the other six PRECISION_MODES (`--bf16`, `--int8`
  with and without `--bf16`, `--int8_dynamic`, `--int8_weights` with and
  without `--bf16`) against JAX's same-mode artifacts: the relative L2 of
  the logits under 1e-2 (measured 1.4e-7 to 2.1e-3, bf16 the largest).
  Not bit for bit: JAX's artifact is one XLA program, which divides by a
  calibrated scale as a product with its reciprocal and fuses the
  epilogue's product and bias into an FMA (each a last-bit move, so a
  rounding tie may flip), and in bf16 the two packages round their sums
  at other points; the weights-only artifact holds no float weight of the
  quantized layers: its file is smaller than the f32 one's, its tensors
  under half of them;
- a ViT's `--int8` artifact (vit_tiny_patch16_224 at 32^2, its trunk
  dense layers quantized, as JAX's test_cli_int8_vit_export): `--verify`
  against its live model at batch 3, and batch 1 through the same program;
- serve's CSV against JAX's serve on the same files (4 JPEGs and a PNG,
  which the native decoder cannot read: the PIL row), --bs 3: names,
  predictions and top-3 equal, probabilities within 1e-4;
- export_torch's tensors against JAX's export_torch: bit for bit;
- the flag conflicts and refusals, with JAX's messages where it has them.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from moma_tpu.cli.export_model import PRECISION_MODES as J_PRECISION_MODES
from moma_tpu.cli.export_model import main as j_export
from moma_tpu.cli.export_torch import main as j_export_torch
from moma_tpu.cli.serve import main as j_serve
from moma_tpu.core.export import ExportedClassifier as JExported
from moma_tpu.models import create_model as j_create_model

from moma_tpu_torch.cli.export_model import PRECISION_MODES
from moma_tpu_torch.cli.export_model import main as export
from moma_tpu_torch.cli.export_torch import main as export_torch
from moma_tpu_torch.cli.serve import main as serve
from moma_tpu_torch.core.export import ExportedClassifier
from moma_tpu_torch.interop import load_jax_variables
from moma_tpu_torch.models import create_model

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import run_once

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--model", "resnet8", "--n_cls", "10", "--image_size", "32"]


def _jax_fresh_init():
    """The port's resnet8 state dict at the JAX CLIs' fresh init: an eager
    init, as they run it (a jitted one differs in the last bits)."""
    jm = j_create_model("resnet8", num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), jax.numpy.zeros((2, 32, 32, 3)),
                train=False)
    model = create_model("resnet8", 10)
    load_jax_variables(model, v)
    return model.state_dict()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory whose best_acc checkpoint holds JAX's fresh init
    (computed once for the workers of a run)."""
    root = tmp_path_factory.mktemp("run")
    os.makedirs(root / "ckpt")
    torch.save({"teacher": run_once("export_resnet8_jax_init",
                                    _jax_fresh_init)},
               str(root / "ckpt" / "best_acc.pt"))
    return str(root)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_f32_artifact_matches_jax(run_dir, tmp_path):
    out, j_out = str(tmp_path / "m"), str(tmp_path / "j")
    path = export(ARGS + ["--run", run_dir, "--out", out, "--device", "cpu",
                          "--verify"])
    j_export(ARGS + ["--out", j_out])
    clf, jclf = ExportedClassifier(path), JExported(j_out)
    assert clf.meta == {**jclf.meta, "ckpt": run_dir, "device": "cpu"}
    rs = np.random.RandomState(1)
    for b in (1, 3, 5):   # one program, any batch size
        x = rs.randint(0, 256, (b, 32, 32, 3), np.uint8)
        got = clf(x).numpy()
        assert got.shape == (b, 10)
        np.testing.assert_allclose(got, np.asarray(jclf(x)), rtol=1e-4,
                                   atol=1e-4)
    x = rs.randint(0, 256, (11, 32, 32, 3), np.uint8)
    np.testing.assert_array_equal(clf.predict(x, batch_size=4),
                                  jclf.predict(x, batch_size=4))
    sharded = ExportedClassifier(path).shard(["cpu", "cpu"])
    for b in (6, 5):   # 5: padded to 6, sliced back
        x = rs.randint(0, 256, (b, 32, 32, 3), np.uint8)
        np.testing.assert_allclose(sharded(x).numpy(), clf(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_bf16",
                                  "int8_dynamic", "w8", "w8_bf16"])
def test_precision_mode_artifact_matches_jax(run_dir, tmp_path, mode):
    assert PRECISION_MODES == J_PRECISION_MODES
    rs = np.random.RandomState(2)
    x = rs.randint(0, 256, (4, 32, 32, 3), np.uint8)
    flags = PRECISION_MODES[mode]
    out, j_out = str(tmp_path / mode), str(tmp_path / f"j_{mode}")
    path = export(ARGS + flags + ["--run", run_dir, "--out", out,
                                  "--device", "cpu", "--verify"])
    j_export(ARGS + flags + ["--out", j_out])
    clf, jclf = ExportedClassifier(path), JExported(j_out)
    assert clf.meta["quantized"] == jclf.meta["quantized"] == {
        "bf16": None, "int8_bf16": "int8", "w8": "int8_weights",
        "w8_bf16": "int8_weights"}.get(mode, mode)
    rel = _rel(clf(x).numpy(), np.asarray(jclf(x)))
    assert rel < 1e-2, (mode, rel)
    if mode != "w8_bf16":
        return
    # the file is smaller than the f32 artifact's; the program's tensors (a
    # few hundred KB of the file are the program's description) less than
    # half the f32 ones
    f32 = export(ARGS + ["--run", run_dir, "--out", str(tmp_path / "f32"),
                         "--device", "cpu"])
    assert os.path.getsize(path) < os.path.getsize(f32)
    held = {m: _tensor_bytes(p) for m, p in (("w8_bf16", path),
                                             ("f32", f32))}
    assert held["w8_bf16"] < 0.5 * held["f32"], held


def test_backbone_exports_with_a_symbolic_batch(tmp_path):
    """A ViT's int8 artifact (its trunk dense layers quantized, as JAX's
    test_cli_int8_vit_export): --verify holds it to the live model at batch
    3; batch 1 runs the same program.  A model whose forward cannot take a
    symbolic batch raises, naming it (the MoE's expert capacity is
    ceil(k * tokens * cf / E))."""
    path = export(["--model", "vit_tiny_patch16_224", "--n_cls", "10",
                   "--image_size", "32", "--out", str(tmp_path / "m"),
                   "--device", "cpu", "--verify", "--int8", "--calib_n",
                   "1"])
    logits = ExportedClassifier(path)(np.zeros((1, 32, 32, 3), np.uint8))
    assert logits.shape == (1, 10) and bool(torch.isfinite(logits).all())
    with pytest.raises(RuntimeError, match="vit_tiny_moe_patch16_224"):
        export(["--model", "vit_tiny_moe_patch16_224", "--n_cls", "10",
                "--image_size", "32", "--out", str(tmp_path / "moe"),
                "--device", "cpu"])
    assert not (tmp_path / "moe.pt2").exists()


def _tensor_bytes(path):
    program = ExportedClassifier(path)._program
    return sum(t.numel() * t.element_size() for t in
               list(program.state_dict.values())
               + list(program.constants.values())
               if isinstance(t, torch.Tensor))


def _write_images(d):
    from PIL import Image

    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, (5, 32, 32, 3), np.uint8)
    os.makedirs(d)
    for i in range(4):
        Image.fromarray(imgs[i]).save(str(d / f"im{i}.jpg"), quality=95)
    # a PNG: the native decoder's failed row, decoded by PIL
    Image.fromarray(imgs[4]).save(str(d / "im4.png"))


def _rows(path):
    with open(path) as f:
        return [(os.path.basename(r["name"]), r["pred"], float(r["prob"]),
                 r["top3"]) for r in csv.DictReader(f)]


def test_serve_and_export_torch_match_jax(run_dir, tmp_path):
    art, j_art = str(tmp_path / "a"), str(tmp_path / "ja")
    export(ARGS + ["--run", run_dir, "--out", art, "--device", "cpu"])
    j_export(ARGS + ["--out", j_art])
    d = tmp_path / "imgs"
    _write_images(d)
    res = serve(["--artifact", art, "--images", str(d / "*"), "--bs", "3",
                 "--out", str(tmp_path / "p.csv")])
    j_serve(["--artifact", j_art, "--images", str(d / "*"), "--bs", "3",
             "--out", str(tmp_path / "jp.csv")])
    got, want = _rows(tmp_path / "p.csv"), _rows(tmp_path / "jp.csv")
    assert res["n"] == len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        assert abs(g[2] - w[2]) <= 1e-4
    # export_torch: a template with the reference's layout of resnet8 (the
    # port's own module: the same conv / bn / linear streams)
    template = str(tmp_path / "template.pth")
    torch.save(create_model("resnet8", 10).state_dict(), template)
    out, j_out = str(tmp_path / "w.pth"), str(tmp_path / "jw.pth")
    export_torch(["--model", "resnet8", "--n_cls", "10", "--run", run_dir,
                  "--template", template, "--out", out])
    j_export_torch(["--model", "resnet8", "--n_cls", "10", "--template",
                    template, "--out", j_out])
    got = torch.load(out, weights_only=False)
    want = torch.load(j_out, weights_only=False)
    assert list(got["model"]) == list(want["model"])
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    assert got["framework"] == "moma_tpu_torch"


def test_export_flag_conflicts_carry_the_jax_messages(tmp_path):
    for extra in (["--int8", "--int8_weights"], ["--int8", "--int8_dynamic"],
                  ["--int8", "--calib_images", "none*.jpg"]):
        extra = [str(tmp_path / a) if a.endswith(".jpg") else a
                 for a in extra]
        with pytest.raises(SystemExit) as want:
            j_export(ARGS + ["--out", str(tmp_path / "y")] + extra)
        with pytest.raises(SystemExit) as got:
            export(ARGS + ["--out", str(tmp_path / "x"), "--device", "cpu"]
                   + extra)
        assert str(got.value) == str(want.value)
        # nothing was written by a refused export
        assert not (tmp_path / "x.json").exists()
    # export_torch's and serve's refusals
    template = str(tmp_path / "t.pth")
    torch.save({}, template)
    for fn in (j_export_torch, export_torch):
        with pytest.raises(SystemExit, match="pass ONE of --run"):
            fn(["--model", "resnet8", "--run", "r", "--pretrain", "p",
                "--template", template, "--out", str(tmp_path / "o")])
    # a TPU-only flag the port has nothing to tune with: argparse refuses
    with pytest.raises(SystemExit):
        serve(["--artifact", "a", "--synthetic", "2", "--scoped_vmem_kib",
               "0"])
