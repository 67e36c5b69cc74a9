"""MoMA train step: moma_tpu_torch against moma_tpu on the CPU.

Same weights (carried by moma_tpu_torch.interop), same queue memory, same
batch and the same Shuffle-BN permutation (the `shuffle_perm` hook) go
through `make_moma_train_step` of both packages: effiB0 at 64^2, batch 4,
K=64, feat_dim 32, float32, no augmentation.  Both kl_train_bn programs
run; the 3-step case follows the 'exact' schedule (eval-BN KL forward on
the first batch, train-BN after).

Compared: the four losses, each to its own value; student and CMO head
parameters (embed_s, embed_t, atts_*) and the EMA teacher, both by value
and by their update over the run (after - before, which holds the
gradients to their own scale rather than to the weights'); teacher and
student BN running statistics; the queue rows and pointer.  Tensors are compared
by relative error with a floor at each tensor's own scale, itself floored
at 1e-3 of its group's scale for tensors that are zero up to float noise
(torch_port_helpers.assert_close_scaled).  The two packages take their
float32 sums in different orders (XLA's and oneDNN's convolutions, the
port's channel sums vs flax's mean), so:

- losses, values, BN stats, queue: rtol 1e-4 after one step, 1e-3 after
  three;
- loss_div: 5e-4 / 3e-3.  It is a KL of two near-uniform distributions at
  T=4, about 1e-2, made of float32 terms of order T^2*log(n_cls) that
  cancel; rounding alone moves it by 1.01e-4 of itself after one step;
- updates: 2e-3 / 1e-2.  Rounding alone gives at most 6.1e-4 after one
  step and 1.9e-3 after three; a KL gradient 10% off gives 1.1e-2 and
  0.42 (measured on the CPU with a deliberately wrong copy of the step).

With `fast_teacher` (one step) the KL logits are the key forward's, in
both packages, held to the one-step tolerances.

The same runs with `fused_teacher='on'` (both teacher forwards through the
fused EfficientNet forward of each package) are held to the same
tolerances, with the teacher's running statistics compared after every
step.  The JAX step calls its fused forward without a compute dtype, i.e.
in bfloat16 whatever the run's precision, while the port follows the
teacher's dtype (float32 here), so the test pins the JAX side to float32
by replacing `fused_effnet_pallas.fused_forward` with a partial that passes
`compute_dtype=float32` (the step looks the name up when it is traced).
And the port's own step gives the same losses by either route.
"""

import functools

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
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.ops import fused_effnet_pallas as JFEP
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core.config import Config, DistillConfig, MomaConfig
from moma_tpu_torch.core.config import ModelConfig
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.moma.cmo import CMOHeads
from moma_tpu_torch.moma.queue import QueueState
from moma_tpu_torch.train.moma import make_moma_train_step
from moma_tpu_torch.train.state import MomaState, make_sgd

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS, K, FEAT = 4, 64, 4, 64, 32
ALPHA, LR, EPOCHS, STEPS_PER_EPOCH = 0.99, 0.05, 5, 4


def _cfgs(fused="off", fast=False, remat=False):
    jc = JConfig()
    jc.run.remat = remat
    jc.model_t = JModel(name="effiB0", n_cls=N_CLS)
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                    mem="MoCo", head="mlp", attn="self", fused_teacher=fused,
                    fast_teacher=fast)
    tc = Config()
    tc.model_s = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.model_t = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                         mem="MoCo", head="mlp", attn="self",
                         fused_teacher=fused, fast_teacher=fast)
    tc.run.remat = remat
    return jc, tc


@pytest.fixture(scope="module")
def init_vars():
    model = efficientnet_b0(num_classes=N_CLS)
    init = make_init_ordered(model, (2, HW, HW, 3))
    vs = init(jax.random.PRNGKey(0))
    vt = init(jax.random.PRNGKey(1))
    jheads = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=1280,
                    t_dim=1280)
    cmo_params, _ = heads_init(jheads, 2)
    cmo = ordered_numpy({"params": cmo_params})
    rs = np.random.RandomState(3)
    mem = rs.randn(K, FEAT).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    return model, jheads, vs, vt, cmo, mem


def _batches(n):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(n):
        out.append({
            "image": rs.randn(B, HW, HW, 3).astype(np.float32),
            "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
            "shuffle_perm": rs.permutation(B).astype(np.int32),
        })
    return out


_JAX_PROGRAMS = {}


def _jax_run(init_vars, programs, batches, fused="off", fast=False,
             remat=False):
    """Returns (state, metrics per step, teacher batch_stats per step)."""
    model, jheads, vs, vt, cmo, mem = init_vars
    jc, _ = _cfgs(fused, fast, remat)
    # one optimizer and one jitted step per (route, BN mode) for the whole
    # module: a later test on the same process reuses the compiled program
    # (the optimizer is a static field of the state, so it must be the same
    # object for the cache to hit)
    if "tx" not in _JAX_PROGRAMS:
        _JAX_PROGRAMS["tx"] = j_make_sgd(
            j_lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True), 0.9, 5e-4)
        # one jitted init: eagerly, its zeros compile one program per shape
        _JAX_PROGRAMS["tx_init"] = jax.jit(_JAX_PROGRAMS["tx"].init)
    tx = _JAX_PROGRAMS["tx"]
    params = {"student": vs["params"], "cmo": cmo["params"]}
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "cmo": {}},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        queue=JQueue(memory={"memory": jnp.asarray(mem)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=_JAX_PROGRAMS["tx_init"](params), tx=tx,
        apply_fn=model.apply,
        teacher_apply_fn=model.apply)
    steps = {}
    for flag in set(programs):
        key = (id(jheads), fused, fast, remat, flag)
        if key not in _JAX_PROGRAMS:
            _JAX_PROGRAMS[key] = quick_compiled(j_make_step(
                jc, jheads, augment_fn=None, donate=False,
                kl_train_bn_override=flag))
        steps[flag] = _JAX_PROGRAMS[key]
    metrics, teacher_bs = [], []
    for flag, b in zip(programs, batches):
        state, m = steps[flag](state, {k: jnp.asarray(v) for k, v in
                                       b.items()}, jax.random.PRNGKey(9))
        metrics.append({k: float(v) for k, v in m.items()})
        teacher_bs.append(jax.device_get(state.teacher_batch_stats))
    return state, metrics, teacher_bs


def _torch_run(init_vars, programs, batches, fused="off", fast=False,
               remat=False):
    _, _, vs, vt, cmo, mem = init_vars
    _, tc = _cfgs(fused, fast, remat)
    student = EfficientNet("b0", num_classes=N_CLS)
    teacher = EfficientNet("b0", num_classes=N_CLS)
    heads = CMOHeads("mlp", "self", FEAT, s_dim=1280, t_dim=1280)
    load_jax_variables(student, vs)
    load_jax_variables(teacher, vt)
    load_jax_variables(heads, cmo)
    teacher.requires_grad_(False)
    heads.embed_t.requires_grad_(False)
    state = MomaState(
        student=student, teacher=teacher, heads=heads,
        queue=QueueState({"memory": torch.from_numpy(mem.copy())}),
        optimizer=None,
        schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    steps = {flag: make_moma_train_step(tc, None, kl_train_bn_override=flag)
             for flag in set(programs)}
    metrics, teacher_bs = [], []
    for flag, b in zip(programs, batches):
        state, m = steps[flag](
            state, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.Generator().manual_seed(9))
        metrics.append({k: float(v) for k, v in m.items()})
        # a copy: the converter's arrays share the module's memory
        teacher_bs.append(jax.tree_util.tree_map(
            np.array, jax_variables(state.teacher, vt)["batch_stats"]))
    return state, metrics, teacher_bs


@pytest.mark.parametrize("programs,rtol,div_rtol,upd_rtol,fast", [
    ((False,), 1e-4, 5e-4, 2e-3, False),
    ((True,), 1e-4, 5e-4, 2e-3, False),
    ((False, True, True), 1e-3, 3e-3, 1e-2, False),
    ((True,), 1e-4, 5e-4, 2e-3, True),
], ids=["1step-evalbn", "1step-trainbn", "3step-exact", "1step-fast_teacher"])
def test_moma_step_matches_jax(init_vars, programs, rtol, div_rtol,
                               upd_rtol, fast):
    _check_against_jax(init_vars, programs, rtol, div_rtol, upd_rtol, "off",
                       fast)


@pytest.mark.parametrize("programs,rtol,div_rtol,upd_rtol", [
    ((True,), 1e-4, 5e-4, 2e-3),
    ((False, True, True), 1e-3, 3e-3, 1e-2),
], ids=["1step-trainbn", "3step-exact"])
def test_moma_step_with_fused_teacher_matches_jax(
        init_vars, programs, rtol, div_rtol, upd_rtol, monkeypatch):
    monkeypatch.setattr(JFEP, "fused_forward", functools.partial(
        JFEP.fused_forward, compute_dtype=jnp.float32))
    _check_against_jax(init_vars, programs, rtol, div_rtol, upd_rtol, "on")


def test_fused_teacher_step_gives_the_module_route_its_losses(init_vars):
    """Same function, other route: two 'exact' steps of the port with
    `fused_teacher` on and off, float32."""
    programs = (False, True)
    batches = _batches(len(programs))
    s_off, m_off, bs_off = _torch_run(init_vars, programs, batches, "off")
    s_on, m_on, bs_on = _torch_run(init_vars, programs, batches, "on")
    for a, b in zip(m_on, m_off):
        for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    floor = group_floor(bs_off[-1])
    for path, g, w in walk_pairs(bs_on[-1], bs_off[-1], "teacher_bs"):
        assert_close_scaled(g, w, 1e-4, path, floor)
    pairs = [(a.detach().numpy(), b.detach().numpy()) for a, b in
             zip(s_on.student.parameters(), s_off.student.parameters())]
    floor = 1e-3 * max(float(np.abs(b).max()) for _, b in pairs)
    for a, b in pairs:
        assert_close_scaled(a, b, 1e-4, "student", floor)


def test_fused_teacher_needs_an_efficientnet_teacher():
    """The flag is never ignored: with another teacher it raises."""
    from moma_tpu_torch.train.moma import make_teacher_forward
    _, tc = _cfgs("on")
    tc.model_t = ModelConfig(name="resnet8", n_cls=N_CLS)
    with pytest.raises(ValueError, match="EfficientNet"):
        make_teacher_forward(tc)


def _check_against_jax(init_vars, programs, rtol, div_rtol, upd_rtol, fused,
                       fast=False, remat=False):
    batches = _batches(len(programs))
    js, jm, jbs = _jax_run(init_vars, programs, batches, fused, fast, remat)
    ts, tm, tbs = _torch_run(init_vars, programs, batches, fused, fast,
                             remat)
    _, _, vs, vt, cmo, _ = init_vars

    for step, (got, ref) in enumerate(zip(tbs, jbs)):
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got, ref, f"teacher_bs step {step}"):
            assert_close_scaled(g, w, rtol, path, floor)

    for a, b in zip(tm, jm):
        for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
            tol = div_rtol if k == "loss_div" else rtol
            assert abs(a[k] - b[k]) <= tol * abs(b[k]), (k, a[k], b[k])
        assert a["queue_ptr"] == b["queue_ptr"]
    assert ts.queue.ptr == int(js.queue.ptr) == (B * len(programs)) % K

    got_s = jax_variables(ts.student, vs)
    got_t = jax_variables(ts.teacher, vt)
    got_c = jax_variables(ts.heads, cmo)
    want = {
        "student": (got_s["params"], js.params["student"]),
        "student_bs": (got_s["batch_stats"], js.batch_stats["student"]),
        "teacher": (got_t["params"], js.teacher_params),
        "teacher_bs": (got_t["batch_stats"], js.teacher_batch_stats),
        "cmo": (got_c["params"], js.params["cmo"]),
    }
    for name, (got, ref) in want.items():
        ref = jax.device_get(ref)
        floor = group_floor(ref)
        for path, g, w in walk_pairs(got, ref, name):
            assert_close_scaled(g, w, rtol, path, floor)

    before = {"student": vs["params"], "teacher": vt["params"],
              "cmo": cmo["params"]}
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
    assert_close_scaled(ts.queue.memory["memory"].numpy(),
                        np.asarray(js.queue.memory["memory"]), rtol,
                        "queue")
