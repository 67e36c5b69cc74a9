"""`python -m moma_tpu_torch.cli.train_student --distill moma` on the CPU.

The whole slice at a small size: synthetic prostate_hv images through the
RandAugment layers, effiB0 student and teacher, the MoMA step with the
'exact' KL-BN schedule, the epoch loop, the evaluation and the run
directory — every kernel wrapper taking its plain version because the
tensors are on the CPU.  The CLI runs train on synthetic sets cut to 16
training images (4 steps: the epoch's eval-BN first step and three
train-BN steps) and 8 val / test images, and write under pytest's
tmp_path (--save_dir).
"""

import dataclasses
import math
import os

import pytest
import torch

from moma_tpu.core.config import parse_student_args as j_parse_student_args
from moma_tpu_torch.cli import train_student
from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.data.pipeline import ArrayDataset
from moma_tpu_torch.runtime import launch_counts, reset_launch_counts
from moma_tpu_torch.train import moma as moma_train

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s", "effiB0",
        "--model_t", "effiB0", "--distill", "moma", "--head", "mlp",
        "--attn", "self", "--synthetic", "--image_size", "64",
        "--batch_size", "4", "--nce_k", "64", "--epochs", "1", "--fp32"]


@pytest.fixture
def small_sets(monkeypatch):
    full = moma_train.build_datasets

    def cut(cfg, synthetic):
        return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (16, 8, 8)))

    monkeypatch.setattr(moma_train, "build_datasets", cut)


def test_cli_trains_one_epoch_on_cpu(capsys, small_sets, tmp_path):
    reset_launch_counts()
    state, result = train_student.main(
        ARGS + ["--feat_dim", "32", "--save_dir", str(tmp_path)])
    tr = result["train"]
    assert tr["steps"] == 4  # 16 synthetic images / batch 4
    assert math.isfinite(tr["loss"]) and math.isfinite(result["val"]["loss"])
    assert 0.0 <= result["best_acc"] <= 100.0
    assert state.queue.ptr == (4 * 4) % 64
    assert state.step == 4
    assert state.queue.memory["memory"].shape == (64, 32)
    # CPU tensors never reach a CUDA kernel
    assert launch_counts() == {}
    out = capsys.readouterr().out
    assert "epoch 1: loss" in out and "done: best val acc" in out
    assert "(trial 0)" in out and f"run_dir {result['run_dir']}" in out


def test_cli_writes_nothing_outside_save_dir(small_sets, tmp_path,
                                            monkeypatch):
    cwd, save = tmp_path / "cwd", tmp_path / "save"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    argv = [a if a != "64" else "32" for a in ARGS]   # 32^2 images, K below
    argv[argv.index("--nce_k") + 1] = "64"
    _, result = train_student.main(argv + ["--feat_dim", "16",
                                           "--save_dir", str(save)])
    assert os.listdir(cwd) == [] and os.listdir(tmp_path) == ["cwd", "save"]
    run = os.path.basename(result["run_dir"])
    assert os.listdir(save) == [run]
    files = sorted(os.path.relpath(os.path.join(d, f), save / run)
                   for d, _, fs in os.walk(save / run) for f in fs)
    assert [f for f in files if not f.startswith("tb")] == [
        "ckpt/best_acc.meta.json", "ckpt/best_acc.pt",
        "ckpt/best_f1.meta.json", "ckpt/best_f1.pt",
        "ckpt/latest.meta.json", "ckpt/latest.pt", "parameters.json",
        "scalars.jsonl", "stat.json"]


# --grad_accum with --model_parallel is ported ([5b-accum]), and so are the
# MoE ViTs ([5b-teachers] (a, d)) and --teacher_quant ([6]): the cases that
# name one parse as the JAX package parses them; the first two stay refused
@pytest.mark.parametrize("extra", [
    ["--distill", "kd_zoo"], ["--attn", "selff"],
    ["--model_parallel", "2", "--teacher_quant", "int8"],
    ["--model_s", "vit_small_moe_patch16_224"], ["--teacher_quant", "int8"],
    ["--bn", "local", "--model_parallel", "4", "--model_s",
     "vit_tiny_moe_patch16_224"],
    ["--model_t", "vit_tiny_moe_patch16_224"],
])
def test_choices_outside_the_slice_raise(extra):
    argv = [a for a in ARGS if a != "--synthetic"]  # a CLI-only flag
    if not any("_moe_" in a or a == "--teacher_quant" for a in extra):
        with pytest.raises(NotImplementedError):
            parse_student_args(argv + extra)
        return
    got = parse_student_args(argv + extra)
    want = j_parse_student_args(
        [a for a in argv if a not in ("--device", "cpu")] + extra)
    for part in ("model_s", "model_t", "run", "moma"):
        assert _fields(getattr(got, part)) == _fields(getattr(want, part)), \
            part


@pytest.mark.parametrize("extra", [
    ["--grad_accum", "2"], ["--bn", "local"], ["--teacher_quant", "int8"],
    ["--bn", "sync", "--grad_accum", "4"],
])
def test_fused_teacher_keeps_the_reference_refusals(extra):
    """--fused_teacher on is a one-device path: with gradient accumulation,
    per-device BN or the int8 teacher the JAX package raises too, and so
    does the port, when the step is built, with JAX's messages."""
    from moma_tpu_torch.train.moma import make_moma_train_step

    argv = [a for a in ARGS if a != "--synthetic"]
    assert parse_student_args(
        argv + ["--fused_teacher", "on"]).moma.fused_teacher == "on"
    cfg = parse_student_args(argv + ["--fused_teacher", "on"] + extra)
    with pytest.raises(ValueError,
                       match="fused_teacher|nest two rank semantics"):
        make_moma_train_step(cfg, None, kl_train_bn_override=True)


def test_cli_trains_with_the_fused_teacher_on_cpu(small_sets, tmp_path):
    """--fused_teacher on: both teacher forwards through the fused forward,
    on the CPU through the plain versions of its three kernels."""
    reset_launch_counts()
    argv = [a if a != "64" else "32" for a in ARGS]   # 32^2 images, K below
    argv[argv.index("--nce_k") + 1] = "64"
    state, result = train_student.main(
        argv + ["--feat_dim", "16", "--fused_teacher", "on",
                "--save_dir", str(tmp_path)])
    tr = result["train"]
    assert tr["steps"] == 4 and math.isfinite(tr["loss"])
    assert math.isfinite(result["val"]["loss"])
    assert state.queue.ptr == (4 * 4) % 64 and state.step == 4
    assert launch_counts() == {}
    # the fused forward updated the teacher's running statistics in place
    assert float(state.teacher.bn1.running_mean.abs().max()) > 0


@pytest.mark.parametrize("extra,want", [
    (["--mem", "MoCoST"], ("MoCoST", "mlp", "self")),
    (["--attn", "all"], ("MoCo", "mlp", "all")),
    (["--head", "linear"], ("MoCo", "linear", "self")),
    (["--mem", "MoCoAtt", "--attn", "dual", "--head", "mlp_byol"],
     ("MoCoAtt", "mlp_byol", "dual")),
    (["--mem", "MoCoSSTT", "--head", "None", "--attn", "self_viz"],
     ("MoCoSSTT", "None", "self_viz")),
])
def test_memory_variants_heads_and_attention_modes_parse(extra, want):
    argv = [a for a in ARGS if a != "--synthetic"]
    m = parse_student_args(argv + extra).moma
    assert (m.mem, m.head, m.attn) == want


def test_cli_trains_mocoatt_through_the_streaming_path_on_cpu(small_sets,
                                                              tmp_path):
    """--mem MoCoAtt --attn all over 2*4 + 2048 tokens: above the dense
    limit, so the attention takes the flash wrappers' plain versions."""
    reset_launch_counts()
    argv = [a if a != "64" else "32" for a in ARGS]   # 32^2 images, K below
    i = argv.index("--nce_k")
    argv[i + 1] = "2048"
    state, result = train_student.main(
        argv + ["--feat_dim", "16", "--mem", "MoCoAtt", "--attn", "all",
                "-b", "1", "--save_dir", str(tmp_path)])
    tr = result["train"]
    assert tr["steps"] == 4 and math.isfinite(tr["loss"])
    assert state.queue.ptr == (4 * tr["steps"]) % 2048 and state.step == 4
    assert list(state.heads.attn) == ["atts"]
    assert launch_counts() == {}


@pytest.mark.parametrize("extra", [
    ["--scoped_vmem_kib", "0"],
])
def test_flags_the_port_would_ignore_are_refused(extra, capsys):
    argv = [a for a in ARGS if a != "--synthetic"]
    with pytest.raises(SystemExit):
        parse_student_args(argv + extra)
    assert "unrecognized arguments" in capsys.readouterr().err


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in ("scoped_vmem_kib", "donate", "device")}


@pytest.mark.parametrize("extra", [
    ["--save_dir", "/tmp/runs"], ["--crop", "0.5", "--image_resize"],
    ["--fold_idx", "1", "--n_folds", "3"], ["--resume"], ["--fast_teacher"],
    ["--profile_dir", "/tmp/trace"], ["--skip_validation"],
    ["--std_pre", "PRE", "--std_strict"],
    ["--tec_pre", "PRE", "--tec_strict"], ["--grad_clip", "1"],
    ["--trust_ratio", "1e-3"],
], ids=lambda e: " ".join(e))
def test_reference_flags_parse_alike(extra, tmp_path):
    """Each flag set parses to the same fields in both packages, and the
    port's slice takes it."""
    pre = tmp_path / "student.pth"
    pre.write_bytes(b"")
    extra = [str(pre) if a == "PRE" else a for a in extra]
    argv = [a for a in ARGS if a != "--synthetic"]
    got = parse_student_args(argv + extra)
    want = j_parse_student_args(
        [a for a in argv if a not in ("--device", "cpu")] + extra)
    for part in ("data", "model_s", "model_t", "optim", "distill", "moma",
                 "run"):
        assert _fields(getattr(got, part)) == _fields(getattr(want, part)), \
            part
    assert got.run_name == want.run_name


@pytest.mark.parametrize("bad", [["--fold_idx", "3", "--n_folds", "3"],
                                 ["--fold_idx", "0", "--n_folds", "1"]])
def test_fold_choices_are_checked_alike(bad):
    argv = [a for a in ARGS if a != "--synthetic"]
    with pytest.raises(ValueError):
        parse_student_args(argv + bad)
    with pytest.raises(ValueError):
        j_parse_student_args([a for a in argv if a not in ("--device",
                                                           "cpu")] + bad)


def test_an_unresolvable_pretrain_tag_raises_at_run_moma(tmp_path,
                                                         monkeypatch):
    """--std_pre imagenet parses, and the run raises on the tag, as the
    JAX package does: it would otherwise train another model."""
    from moma_tpu_torch.models.pretrained import PretrainResolutionError

    monkeypatch.delenv("MOMA_PRETRAIN_REGISTRY", raising=False)
    monkeypatch.setenv("MOMA_PRETRAIN_DIR", str(tmp_path / "none"))
    argv = [a for a in ARGS if a != "--synthetic"]
    cfg = parse_student_args(argv + ["--std_pre", "imagenet",
                                     "--save_dir", str(tmp_path)])
    with pytest.raises(PretrainResolutionError, match="imagenet"):
        moma_train.run_moma(cfg, synthetic=True)


@pytest.mark.parametrize("intervals,want", [
    ([], (0.0, 0.0, None, 0.0, 0)),
    ([(0, 10), (5, 10), (40, 10)], (25.0, 50.0, 0.5, 25.0, 1)),
    ([(100, 4), (0, 50), (60, 5), (20, 10)], (59.0, 104.0, 45 / 104, 35.0,
                                              1)),  # a 10 us gap is no gap
], ids=["none", "overlap-and-gap", "unsorted"])
def test_device_busy_takes_the_union_of_intervals(intervals, want):
    from moma_tpu_torch.core.profiling import device_busy

    got = device_busy(intervals)
    keys = ("busy_us", "span_us", "idle_share", "largest_gap_us",
            "gaps_over_10us")
    assert tuple(got[k] for k in keys) == pytest.approx(want)


@pytest.mark.parametrize("extra", [
    [], ["--mem", "MoCoAtt", "--attn", "all", "-b", "1"],
    ["--fused_teacher", "on"],
], ids=["moco", "mocoatt", "fused_teacher"])
def test_profile_step_runs_on_cpu(tmp_path, monkeypatch, extra):
    from moma_tpu_torch.cli import profile_step

    for name in ("WARMUP", "STEPS", "PROFILE_STEPS", "PHASE_ITERS"):
        monkeypatch.setattr(profile_step, name, 1)
    s = profile_step.main([
        "--out", str(tmp_path), "--device", "cpu", "--distill", "moma",
        "--dataset", "prostate_hv", "--model_s", "effiB0", "--model_t",
        "effiB0", "--image_size", "32", "--batch_size", "2", "--nce_k", "8",
        "--feat_dim", "16", "--head", "mlp", "--attn", "self", "--fp32"]
        + extra)
    assert s["mem"] == (extra[1] if "--mem" in extra else "MoCo")
    assert s["fused_teacher"] == ("on" if "--fused_teacher" in extra
                                  else "off")
    assert s["step_ms"]["n"] == 1 and s["step_ms"]["median"] > 0
    assert set(s["phase_ms"]) == {"augment", "teacher_forward",
                                  "student_forward_backward"}
    assert s["trace"]["idle_share"] is None  # no device on the CPU
    assert s["idle_share_vs_step"] is None
    for name in ("moma_step_trace.json", "profile_ops.txt",
                 "profile_summary.json"):
        assert (tmp_path / name).stat().st_size > 0


def test_cuda_device_is_required_when_asked():
    from moma_tpu_torch.runtime import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
