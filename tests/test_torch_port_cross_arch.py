"""Cross-arch MoMA (CMO_EmaTec): moma_tpu_torch against moma_tpu on the CPU.

The step: the same weights (carried by moma_tpu_torch.interop), queue,
batch and Shuffle-BN permutation (`shuffle_perm`) go through moma_tpu's
`make_moma_train_step(cross_arch=True)` and the port's: effiB0 student at
64^2, batch 4, K=64, feat_dim 32, float32, no augmentation, with a small
ViT teacher (patch 8, dim 32, depth 2, 2 heads) for MoCo over 1 and 3
steps and MoCoST over 1, and an effiB1 teacher for MoCo over 1.  Compared:
the four losses; the student, every CMO head (embed_s, the EMA'd
embed_ema, embed_t, which decays in the SGD chain on a zero gradient) and
the attention set, and the EMA copy, by value and by their update over the
run; the student's and the EMA copy's BN running statistics; the fixed
teacher, unchanged bit for bit on both sides; every queue bank and the
pointer.  Tolerances as tests/test_torch_port_moma_step.py sets them
(values, BN stats, queue: rtol 1e-4 after one step, 1e-3 after three;
loss_div 5e-4 / 3e-3; updates 2e-3 / 1e-2), each with a floor at the
tensor's own scale, itself floored at 1e-3 of its group's scale.

The heads: RFFHead fixed (its draw carried) and non-fixed (JAX's draws
injected), attn_maps, and CMOEmaTecHeads' three embeds against the JAX
functions, float32, within 1e-5 of max|ref|.

The CLI: two steps of the cross-arch run (vit_tiny teacher) on the CPU,
then --resume, then test_eval --num_per_class 2 --dump_attn, whose .npz
keys are those moma_tpu/moma/viz.py writes for the run's attention set.
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
from moma_tpu.models.efficientnet import efficientnet_b0, efficientnet_b1
from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.moma import cmo as jcmo
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.cli import test_eval, train_student
from moma_tpu_torch.core.config import Config, DistillConfig, MomaConfig
from moma_tpu_torch.core.config import ModelConfig
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data.pipeline import ArrayDataset
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.moma import cmo
from moma_tpu_torch.moma.queue import QueueState
from moma_tpu_torch.train import moma as moma_train
from moma_tpu_torch.train.moma import make_moma_train_step
from moma_tpu_torch.train.state import MomaState, make_sgd

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                jax_template, make_init_ordered,
                                ordered_numpy, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS, K, FEAT = 4, 64, 4, 64, 32
ALPHA, LR, EPOCHS, STEPS_PER_EPOCH = 0.99, 0.05, 5, 4
VIT = dict(patch_size=8, dim=32, depth=2, num_heads=2)
# one student module for the file: its apply is a static field of the JAX
# state, so a new module would make every case trace its step again
J_STUDENT = efficientnet_b0(num_classes=N_CLS)


def _teachers():
    return {"vit": (JViT(num_classes=N_CLS, **VIT),
                    lambda: VisionTransformer(8, 32, 2, 2, N_CLS, HW), 32),
            "effiB1": (efficientnet_b1(num_classes=N_CLS),
                       lambda: EfficientNet("b1", num_classes=N_CLS), 1280)}


def _teacher_variables(teacher):
    """The teacher's JAX variables: the small ViT's from its init; effiB1's
    the port's own seeded init carried into a JAX-shaped tree (no compiled
    JAX init of effiB1, which costs 5 s more)."""
    jt, make_t, _ = _teachers()[teacher]
    if teacher == "vit":
        return make_init_ordered(jt, (2, HW, HW, 3))(jax.random.PRNGKey(1))
    return jax_variables(make_t(), jax_template(jt, (2, HW, HW, 3)))


def _cfgs(mem, teacher):
    # the small ViT stands in for a registered name (the step reads it only
    # to check the slice); the test builds the modules itself
    teacher = {"vit": "vit_tiny_patch16_224"}.get(teacher, teacher)
    jc = JConfig()
    jc.model_t = JModel(name=teacher, n_cls=N_CLS)
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA, mem=mem,
                    head="mlp", attn="self")
    tc = Config()
    tc.model_s = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.model_t = ModelConfig(name=teacher, n_cls=N_CLS)
    tc.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                         mem=mem, head="mlp", attn="self")
    return jc, tc


_INIT = {}


def _init(teacher, mem):
    """Insertion-ordered JAX variables of student, teacher, heads, and the
    queue banks: one set per (teacher, mem) for the module."""
    key = (teacher, mem)
    if key not in _INIT:
        jt, _, t_dim = _teachers()[teacher]
        vs = make_init_ordered(J_STUDENT, (2, HW, HW, 3))(
            jax.random.PRNGKey(0))
        vt = _teacher_variables(teacher)
        # the EMA copy starts away from the student, so its first update,
        # (1 - alpha)(student - ema), is no rounding noise around zero
        ve = make_init_ordered(J_STUDENT, (2, HW, HW, 3))(
            jax.random.PRNGKey(4))
        jheads = jcmo.CMOHeads(head="mlp", attn="self", feat_dim=FEAT,
                               s_dim=1280, t_dim=t_dim, include_ema=True)
        cmo_params, _ = jheads.init(jax.random.PRNGKey(2))
        rs = np.random.RandomState(3)
        banks = ("memory_s", "memory_t") if mem == "MoCoST" else ("memory",)
        mem_rows = {}
        for name in banks:
            m = rs.randn(K, FEAT).astype(np.float32)
            mem_rows[name] = m / np.linalg.norm(m, axis=1, keepdims=True)
        _INIT[key] = (jt, jheads, vs, vt, ve,
                      ordered_numpy({"params": cmo_params}), mem_rows)
    return _INIT[key]


def _batches(n):
    rs = np.random.RandomState(7)
    return [{"image": rs.randn(B, HW, HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
             "shuffle_perm": rs.permutation(B).astype(np.int32)}
            for _ in range(n)]


_JAX_PROGRAMS = {}


def _jax_run(teacher, mem, batches):
    jt, jheads, vs, vt, ve, cmo_v, mem_rows = _init(teacher, mem)
    jc, _ = _cfgs(mem, teacher)
    if "tx" not in _JAX_PROGRAMS:
        _JAX_PROGRAMS["tx"] = j_make_sgd(
            j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True), 0.9, 5e-4)
        _JAX_PROGRAMS["tx_init"] = jax.jit(_JAX_PROGRAMS["tx"].init)
    tx = _JAX_PROGRAMS["tx"]
    params = {"student": vs["params"], "cmo": cmo_v["params"]}
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "cmo": {}},
        teacher_params=vt["params"],
        teacher_batch_stats=vt.get("batch_stats", {}),
        queue=JQueue(memory={k: jnp.asarray(v) for k, v in mem_rows.items()},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=_JAX_PROGRAMS["tx_init"](params), tx=tx,
        ema_params=ve["params"], ema_batch_stats=ve["batch_stats"],
        apply_fn=J_STUDENT.apply, teacher_apply_fn=jt.apply)
    prog = _JAX_PROGRAMS.get((teacher, mem))
    if prog is None:
        prog = _JAX_PROGRAMS[(teacher, mem)] = j_make_step(
            jc, jheads, augment_fn=None, donate=False, cross_arch=True,
            kl_train_bn_override=True)
    metrics = []
    for b in batches:
        state, m = prog(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _torch_state(teacher, mem):
    _, _, vs, vt, ve, cmo_v, mem_rows = _init(teacher, mem)
    _, make_t, t_dim = _teachers()[teacher]
    student = EfficientNet("b0", num_classes=N_CLS)
    t = make_t()
    heads = cmo.CMOHeads("mlp", "self", FEAT, s_dim=1280, t_dim=t_dim,
                         include_ema=True)
    load_jax_variables(student, vs)
    load_jax_variables(t, vt)
    load_jax_variables(heads, cmo_v)
    ema = EfficientNet("b0", num_classes=N_CLS)
    load_jax_variables(ema, ve)
    for m in (t, ema, heads.embed_t, heads.embed_ema):
        m.requires_grad_(False)
    state = MomaState(
        student=student, teacher=t, heads=heads, ema=ema,
        queue=QueueState({k: torch.from_numpy(v.copy())
                          for k, v in mem_rows.items()}),
        optimizer=None,
        schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    return state


def _torch_run(teacher, mem, batches):
    _, tc = _cfgs(mem, teacher)
    state = _torch_state(teacher, mem)
    step = make_moma_train_step(tc, None, kl_train_bn_override=True,
                                cross_arch=True)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.Generator().manual_seed(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("teacher,mem,n,rtol,div_rtol,upd_rtol", [
    ("vit", "MoCo", 1, 1e-4, 5e-4, 2e-3),
    ("vit", "MoCo", 3, 1e-3, 3e-3, 1e-2),
    ("vit", "MoCoST", 1, 1e-4, 5e-4, 2e-3),
    ("effiB1", "MoCo", 1, 1e-4, 5e-4, 2e-3),
], ids=["vit-moco-1step", "vit-moco-3step", "vit-mocost-1step",
        "effiB1-moco-1step"])
def test_cross_arch_step_matches_jax(teacher, mem, n, rtol, div_rtol,
                                     upd_rtol):
    batches = _batches(n)
    js, jm = _jax_run(teacher, mem, batches)
    ts, tm = _torch_run(teacher, mem, batches)
    _, _, vs, vt, ve, cmo_v, mem_rows = _init(teacher, mem)

    for a, b in zip(tm, jm):
        for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
            tol = div_rtol if k == "loss_div" else rtol
            assert abs(a[k] - b[k]) <= tol * abs(b[k]), (k, a[k], b[k])
        assert a["queue_ptr"] == b["queue_ptr"]
    assert ts.queue.ptr == int(js.queue.ptr) == (B * n) % K

    # the fixed teacher: untouched on both sides, bit for bit
    for path, got, want in walk_pairs(jax_variables(ts.teacher, vt), vt):
        np.testing.assert_array_equal(got, want, err_msg=path)
    for path, got, want in walk_pairs(jax.device_get(js.teacher_params),
                                      vt["params"]):
        np.testing.assert_array_equal(got, want, err_msg=path)

    got_s = jax_variables(ts.student, vs)
    got_e = jax_variables(ts.ema, vs)
    got_c = jax_variables(ts.heads, cmo_v)
    want = {
        "student": (got_s["params"], js.params["student"]),
        "student_bs": (got_s["batch_stats"], js.batch_stats["student"]),
        "ema": (got_e["params"], js.ema_params),
        "ema_bs": (got_e["batch_stats"], js.ema_batch_stats),
        "cmo": (got_c["params"], js.params["cmo"]),
    }
    for name, (got, ref) in want.items():
        ref = jax.device_get(ref)
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got, ref, name):
            assert_close_scaled(g, w, rtol, path, floor)

    before = {"student": vs["params"], "ema": ve["params"],
              "cmo": cmo_v["params"]}
    for name, init in before.items():
        got, ref = want[name]
        upd_ref = jax.tree_util.tree_map(
            lambda r, i: np.asarray(r) - np.asarray(i),
            jax.device_get(ref), init)
        floor = group_floor(upd_ref)
        init_leaves = {p: w for p, _, w in walk_pairs(init, init, name)}
        for path, g, w in walk_pairs(got, upd_ref, name):
            assert_close_scaled(np.asarray(g) - init_leaves[path], w,
                                upd_rtol, path + " update", floor)
    # embed_t, no key head here, decays in the SGD chain: never zero update
    decay = [np.asarray(g) - i for (_, g, i) in walk_pairs(
        got_c["params"]["embed_t"], cmo_v["params"]["embed_t"])]
    assert all(np.abs(d).max() > 0 for d in decay)
    for name in mem_rows:
        assert_close_scaled(ts.queue.memory[name].numpy(),
                            np.asarray(js.queue.memory[name]), rtol,
                            f"queue {name}")
    if mem == "MoCoST":
        # memory_t takes the fixed teacher's keys, memory_s the EMA copy's
        ms = ts.queue.memory["memory_s"][:B]
        mt = ts.queue.memory["memory_t"][:B]
        assert float((ms - mt).abs().sum()) > 1e-3


def test_cross_arch_step_refuses_a_same_arch_state():
    _, tc = _cfgs("MoCo", "vit")
    state = _torch_state("vit", "MoCo")
    state.ema = None
    step = make_moma_train_step(tc, None, cross_arch=True)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    with pytest.raises(ValueError, match="without an EMA copy"):
        step(state, batch, torch.Generator())


def test_rff_head_matches_jax():
    x = np.random.RandomState(0).randn(4, 24).astype(np.float32)
    head = jcmo.RFFHead(out_dim=16, w_scale=0.5, b_scale=2.0, fixed=True)
    v = head.init(jax.random.PRNGKey(0), x)
    mod = cmo.RFFHead(24, 16, w_scale=0.5, b_scale=2.0, fixed=True)
    load_jax_variables(mod, ordered_numpy(v))
    want = np.asarray(head.apply(v, x))
    got = mod(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for k, g in jax_variables(mod, None)["constants"].items():
        np.testing.assert_array_equal(g, np.asarray(v["constants"][k]))
    # non-fixed: JAX's draws for one rng, injected
    head = jcmo.RFFHead(out_dim=16, w_scale=0.5, b_scale=2.0, fixed=False)
    rng = jax.random.PRNGKey(5)
    v = head.init(jax.random.PRNGKey(0), x, rng=rng)
    k1, k2 = jax.random.split(rng)
    draws = (torch.from_numpy(np.array(jax.random.normal(k1, (24, 16)))),
             torch.from_numpy(np.array(jax.random.uniform(
                 k2, (1, 16), minval=0.0, maxval=6.283))))
    mod = cmo.RFFHead(24, 16, w_scale=0.5, b_scale=2.0, fixed=False)
    want = np.asarray(head.apply(v, x, rng=rng))
    got = mod(torch.from_numpy(x), draws=draws).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="draws or a generator"):
        mod(torch.from_numpy(x))
    g1 = mod(torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
    g2 = mod(torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
    assert torch.equal(g1, g2)


def test_attn_maps_match_jax():
    jheads = jcmo.CMOHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=48,
                           t_dim=40)
    params, _ = jheads.init(jax.random.PRNGKey(0))
    heads = cmo.CMOHeads("mlp", "self", FEAT, s_dim=48, t_dim=40)
    load_jax_variables(heads, ordered_numpy({"params": params}))
    rs = np.random.RandomState(1)
    inputs = {"atts_q": rs.randn(6, FEAT), "atts_k": rs.randn(6, FEAT),
              "atts_queue": rs.randn(10, FEAT)}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    want = jheads.attn_maps(params, inputs)
    got = heads.attn_maps({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(got) == set(want) == set(inputs)
    for name, (y, amap) in got.items():
        wy, wmap = (np.asarray(a) for a in want[name])
        n = inputs[name].shape[0]
        assert amap.shape == wmap.shape == (4, n, n)
        np.testing.assert_allclose(amap.sum(-1).detach().numpy(), 1.0,
                                   atol=1e-5)
        for g, w in ((y, wy), (amap, wmap)):
            g = g.detach().numpy()
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name
    # the Attention2 modes have no map, in both packages
    j2 = jcmo.CMOHeads(head="mlp", attn="selfv2", feat_dim=FEAT, s_dim=48,
                       t_dim=40)
    with pytest.raises(ValueError, match="Attention2"):
        j2.attn_maps(j2.init(jax.random.PRNGKey(0))[0],
                     {"atts_q": inputs["atts_q"]})
    t2 = cmo.CMOHeads("mlp", "selfv2", FEAT, s_dim=48, t_dim=40)
    with pytest.raises(ValueError, match="Attention2"):
        t2.attn_maps({"atts_q": torch.from_numpy(inputs["atts_q"])})


def test_ema_tec_heads_embed_like_jax():
    jheads = jcmo.CMOEmaTecHeads(head="mlp", feat_dim=FEAT, s_dim=48,
                                 t_dim=40)
    params, _ = jheads.init(jax.random.PRNGKey(0))
    heads = cmo.CMOEmaTecHeads("mlp", FEAT, s_dim=48, t_dim=40)
    load_jax_variables(heads, ordered_numpy({"params": params}))
    rs = np.random.RandomState(2)
    for which, dim in (("embed_s", 48), ("embed_ema", 48), ("embed_t", 40)):
        x = rs.randn(5, dim).astype(np.float32)
        want = np.asarray(jheads.embed(which, params, x, train=False))
        got = heads.embed(which, torch.from_numpy(x), train=False)
        assert got.shape == (5, FEAT)
        assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), which


# with --fast_teacher and --fused_teacher on, which EmaTec mode ignores
CLI = ["--device", "cpu", "--dataset", "prostate_hv", "--model_s", "effiB0",
       "--model_t", "vit_tiny_patch16_224", "--distill", "moma", "--head",
       "mlp", "--attn", "self", "--synthetic", "--image_size", "32",
       "--batch_size", "4", "--nce_k", "64", "--feat_dim", "32", "--fp32",
       "--print_freq", "1", "--fast_teacher", "--fused_teacher", "on"]


def test_cross_arch_cli_resumes_and_dumps_attention(tmp_path, monkeypatch,
                                                    capsys):
    full = moma_train.build_datasets
    monkeypatch.setattr(moma_train, "build_datasets", lambda cfg, syn: tuple(
        ArrayDataset(ds.images[:n], ds.labels[:n])
        for ds, n in zip(full(cfg, syn), (4, 8, 8))))
    save = ["--save_dir", str(tmp_path)]
    straight, r_st = train_student.main(
        CLI + ["--epochs", "2", "--save_dir", str(tmp_path / "straight")])
    out = capsys.readouterr().out
    assert ("[moma] cross-arch (vit_tiny_patch16_224 teacher -> effiB0 "
            "student): EmaTec momentum-encoder mode") in out
    for flag in ("--fast_teacher", "--fused_teacher on"):
        assert (f"[moma] {flag} does nothing in EmaTec mode: the fixed "
                "teacher runs its own module forward") in out
    _, r_1 = train_student.main(CLI + ["--epochs", "1"] + save)
    resumed, r_re = train_student.main(CLI + ["--epochs", "2", "--resume"]
                                       + save)
    assert "[resume] from epoch 2" in capsys.readouterr().out
    assert resumed.step == straight.step == 2
    assert resumed.queue.ptr == straight.queue.ptr == 8

    def losses(run_dir):
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            return [(r["step"], r["loss"]) for r in map(json.loads, f)]

    assert losses(r_re["run_dir"]) == losses(r_st["run_dir"])
    full_re = moma_train.full_state(resumed)
    full_st = moma_train.full_state(straight)
    assert set(full_re) == set(full_st) and "ema" in full_re
    for group in ("student", "ema", "teacher", "heads"):
        for k, t in full_st[group].items():
            assert torch.equal(full_re[group][k], t), (group, k)
    for k, t in full_st["queue"]["memory"].items():
        assert torch.equal(full_re["queue"]["memory"][k], t), k

    # test_eval over the run: a per-class subset, and its attention maps
    dump = tmp_path / "attn"
    res = test_eval.main([
        "--runs", r_re["run_dir"], "--synthetic", "--model", "effiB0",
        "--n_cls", "4", "--image_size", "32", "--batch_size", "8",
        "--device", "cpu", "--out", str(tmp_path / "t.json"),
        "--num_per_class", "2", "--dump_attn", str(dump)])
    name = os.path.basename(r_re["run_dir"])
    assert res[name]["n"] == 8
    npz = np.load(dump / f"{name}_attn.npz")
    assert set(npz) == {"labels"} | {f"{m}_map"
                                     for m in jcmo.ATTN_SETS["self"]}
    assert npz["atts_q_map"].shape == (4, 8, 8)
    assert npz["atts_queue_map"].shape == (4, 64, 64)
    np.testing.assert_allclose(npz["atts_k_map"].sum(-1), 1.0, atol=1e-5)


def test_resume_without_the_ema_copy_restores_the_rest(capsys):
    """A cross-arch checkpoint that lacks the EMA copy (written before it
    was checkpointed) restores everything else and warns; the momentum
    encoder keeps the copy made at start (moma_tpu/train/moma.py:1485-1500)."""
    from moma_tpu_torch.core.config import parse_student_args

    cfg = parse_student_args([a for a in CLI if a != "--synthetic"])
    src = moma_train.build_state(cfg, torch.device("cpu"), 1, seed=1)
    dst = moma_train.build_state(cfg, torch.device("cpu"), 1, seed=0)
    ema0 = {k: t.clone() for k, t in dst.ema.state_dict().items()}
    saved = moma_train.full_state(src)
    del saved["ema"]
    moma_train.load_full_state(dst, saved)
    assert "old cross-arch checkpoint without the EMA copy" in (
        capsys.readouterr().out)
    for k, t in src.student.state_dict().items():
        assert torch.equal(dst.student.state_dict()[k], t), k
    for k, t in ema0.items():
        assert torch.equal(dst.ema.state_dict()[k], t), k

