"""The MoCoAtt / MoCoST / MoCoSSTT memory variants and the full CMO head and
attention sets: moma_tpu_torch against moma_tpu on the CPU.

1. Every `CMOHeads` layout (each --attn set, each --head) carries its
   weights through moma_tpu_torch.interop and computes what the JAX modules
   compute (atol 1e-5, float32 on both sides).
2. `step_moco_att` in every attention mode, `step_moco_st` and
   `step_moco_sstt`: logits, the gradient of the contrast loss with respect
   to q, the new memory and the pointer, over two steps so that the second
   reads what the first enqueued (logits rtol 1e-5 of the largest logit;
   the gradients of the attention parameters, rtol 1e-4 of each tensor's
   largest entry).
3. `make_moma_train_step` for `--mem MoCoAtt --attn all` (1 and 3 steps)
   and `--attn dual` at K=2048, batch 4 — more than 2048 tokens, so both
   packages take their streaming route, the port through the plain
   versions of its flash kernels — and 1 step of MoCoST and MoCoSSTT at
   K=64.  effiB0 at 64^2, feat_dim 32, float32, the Shuffle-BN permutation
   injected; MoCoSSTT's second view is an injected augmentation (the second
   call flips the images).  Tolerances and their reasons are those of
   tests/test_torch_port_moma_step.py; `loss_kd` of the streaming cases is
   held to 2e-4 after one step because the attention output feeds a
   2049-way softmax at temperature 0.15.  An attention module's updates
   are held to the scale of the module's largest one, and in 'dual' mode
   at half of it only: over 2052 near-uniform attention rows its gradients
   are sums of cancelling terms that float32 does not resolve (against a
   float64 run of the port, both packages are off by 15 to 30% of them,
   and atts_n's output-bias gradient, zero in float64, is 2e-6 of noise in
   both); their values after the step, the student's and embed_s's
   updates, and section 2's gradients at K=10 hold the mode tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.moma import queue as JQ
from moma_tpu.moma.cmo import ATTN_SETS as J_ATTN_SETS
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import make_sgd as j_make_sgd

from moma_tpu_torch.core.config import (Config, DistillConfig, ModelConfig,
                                        MomaConfig)
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet
from moma_tpu_torch.models.torch_import import convert_state_dict
from moma_tpu_torch.moma import queue as TQ
from moma_tpu_torch.moma.cmo import ATTN_SETS, CMOHeads
from moma_tpu_torch.train.moma import make_moma_train_step
from moma_tpu_torch.train.state import MomaState, make_sgd

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, quick_jit, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------- 1. heads and attention

S_DIM, FEAT_SMALL = 24, 16


def _heads_pair(head, attn, seed=0):
    feat = FEAT_SMALL if head != "None" else S_DIM
    jh = JHeads(head=head, attn=attn, feat_dim=feat, s_dim=S_DIM,
                t_dim=S_DIM)
    params, bs = heads_init(jh, seed)
    variables = ordered_numpy({"params": params, "batch_stats": bs})
    th = CMOHeads(head, attn, feat, s_dim=S_DIM, t_dim=S_DIM)
    load_jax_variables(th, variables)
    return jh, variables, th, feat


def test_attention_sets_are_the_jax_table():
    from moma_tpu_torch.core.config import ATTN_MODES

    assert ATTN_SETS == J_ATTN_SETS
    assert set(ATTN_MODES) == set(ATTN_SETS)   # what the CLI admits


@pytest.mark.parametrize("attn", sorted(J_ATTN_SETS))
def test_attention_set_carries_over(attn):
    jh, variables, th, feat = _heads_pair("mlp", attn)
    assert list(th.attn) == list(J_ATTN_SETS[attn])
    x = np.random.RandomState(1).randn(6, feat).astype(np.float32)
    jfns = jh.attn_fns(variables["params"])
    for name, fn in th.attn_fns().items():
        np.testing.assert_allclose(
            fn(_t(x)).detach().numpy(), np.asarray(jfns[name](jnp.asarray(x))),
            atol=1e-5, rtol=0, err_msg=name)
    # and back: the port's weights in the JAX layout are the JAX weights
    back = jax_variables(th, variables)["params"]
    for path, g, w in walk_pairs(back, variables["params"], attn):
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("head", ["mlp", "mlp_byol", "linear", "None"])
def test_projection_heads_carry_over(head):
    jh, variables, th, feat = _heads_pair(head, "self", seed=1)
    x = np.random.RandomState(2).randn(5, S_DIM).astype(np.float32)
    js, new_bs = jh.embed("embed_s", variables["params"],
                          variables["batch_stats"], jnp.asarray(x),
                          train=True)
    jt, _ = jh.embed("embed_t", variables["params"],
                     variables["batch_stats"], jnp.asarray(x), train=False)
    th.embed_s.train()
    th.embed_t.eval()
    ts, tt = th.embed_s(_t(x)), th.embed_t(_t(x))
    assert ts.shape == (5, feat)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt),
                               atol=1e-5, rtol=0)
    if head == "mlp_byol":  # flax BatchNorm's running update, momentum 0.9
        stats = new_bs["BatchNorm_0"]
        np.testing.assert_allclose(th.embed_s.bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(th.embed_s.bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)
    else:
        assert new_bs is None


# ----------------------------------------------------- 2. the queue steps

K_Q, B_Q, TEMP = 10, 4, 0.15
ATT_MODES = ["all", "qk", "dual", "dual2", "self_qk", "self_qkv2", "selfv2",
             "self"]


def _memory(rs, K, D):
    mem = rs.randn(K, D).astype(np.float32)
    return mem / np.linalg.norm(mem, axis=1, keepdims=True)


def _close_logits(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("attn", ATT_MODES)
def test_step_moco_att_matches_jax(attn):
    jh, variables, th, feat = _heads_pair("mlp", attn, seed=2)
    rs = np.random.RandomState(3)
    mem = _memory(rs, K_Q, feat)
    ts = TQ.QueueState({"memory": _t(mem.copy())})
    js = JQ.QueueState(memory={"memory": jnp.asarray(mem)},
                       ptr=jnp.zeros((), jnp.int32))

    def jloss(qq, params, k, all_k, state):
        lg, new = JQ.step_moco_att(state, qq, k, all_k, TEMP, attn,
                                   jh.attn_fns(params))
        return JQ.contrast_ce(lg), (lg, new)

    # one program for the three steps (eagerly, every op compiles alone)
    jgrad = quick_jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                         has_aux=True))
    for step in range(3):   # the pointer wraps at 10 on the third step
        q, k, all_k = (rs.randn(B_Q, feat).astype(np.float32)
                       for _ in range(3))
        tq = _t(q).requires_grad_(True)
        th.zero_grad()
        t_logits, ts = TQ.step_moco_att(ts, tq, _t(k), _t(all_k), TEMP, attn,
                                        th.attn_fns())
        TQ.contrast_ce(t_logits).backward()
        (_, (j_logits, js)), (j_dq, j_dp) = jgrad(
            jnp.asarray(q), variables["params"], jnp.asarray(k),
            jnp.asarray(all_k), js)
        # the attention parameters' gradients, in the JAX layout
        t_dp = convert_state_dict(
            {n: (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.numpy()) for n, p in th.named_parameters()},
            variables)["params"]
        for name in J_ATTN_SETS[attn]:
            # held to the module's largest gradient: some are zero by
            # construction (a shift of all keys, or in 'dual' of all of
            # atts_n's outputs, leaves the softmax unchanged)
            scale = group_floor(jax.device_get(j_dp[name]), 1.0)
            for path, g, w in walk_pairs(t_dp[name], j_dp[name], name):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=path)
        assert t_logits.shape == j_logits.shape == (
            (B_Q, 1) if attn == "dual2" else (B_Q, 1 + K_Q))
        _close_logits(t_logits.detach().numpy(), j_logits)
        _close_logits(tq.grad.numpy(), j_dq, rtol=1e-4)
        np.testing.assert_array_equal(ts.memory["memory"].numpy(),
                                      np.asarray(js.memory["memory"]))
        assert ts.ptr == int(js.ptr) == (B_Q * (step + 1)) % K_Q


@pytest.mark.parametrize("variant", ["st", "sstt", "sstt-no-qt"])
def test_dual_bank_steps_match_jax(variant):
    D = 6
    rs = np.random.RandomState(4)
    mems = {n: _memory(rs, K_Q, D) for n in ("memory_s", "memory_t")}
    ts = TQ.QueueState({n: _t(m.copy()) for n, m in mems.items()})
    js = JQ.QueueState(memory={n: jnp.asarray(m) for n, m in mems.items()},
                       ptr=jnp.zeros((), jnp.int32))
    for step in range(3):
        q, k, q_t, k_t, all_k, all_kt = (
            rs.randn(B_Q, D).astype(np.float32) for _ in range(6))
        # the gathered keys are optional: without them the own keys go in
        if step == 1:
            all_k = all_kt = None
        opt = lambda a, f: None if a is None else f(a)  # noqa: E731
        if variant == "st":
            *t_out, ts = TQ.step_moco_st(ts, _t(q), _t(k), _t(k_t),
                                         opt(all_k, _t), opt(all_kt, _t),
                                         TEMP)
            *j_out, js = JQ.step_moco_st(
                js, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k_t),
                opt(all_k, jnp.asarray), opt(all_kt, jnp.asarray), TEMP)
            assert len(t_out) == 2
        else:
            qt = None if variant == "sstt-no-qt" else q_t
            *t_out, ts = TQ.step_moco_sstt(
                ts, _t(q), _t(k), opt(qt, _t), _t(k_t), opt(all_k, _t),
                opt(all_kt, _t), TEMP)
            *j_out, js = JQ.step_moco_sstt(
                js, jnp.asarray(q), jnp.asarray(k), opt(qt, jnp.asarray),
                jnp.asarray(k_t), opt(all_k, jnp.asarray),
                opt(all_kt, jnp.asarray), TEMP)
            assert len(t_out) == (2 if qt is None else 4)
        assert len(t_out) == len(j_out)
        for a, b in zip(t_out, j_out):
            _close_logits(a.numpy(), b, rtol=1e-6)
        for n in mems:
            np.testing.assert_array_equal(ts.memory[n].numpy(),
                                          np.asarray(js.memory[n]))
        assert ts.ptr == int(js.ptr) == (B_Q * (step + 1)) % K_Q


def test_queue_bank_names_must_match():
    ts = TQ.QueueState({"memory": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="banks"):
        load_jax_variables(ts, {"memory": {"memory_s": np.zeros((4, 2)),
                                           "memory_t": np.zeros((4, 2))}})


# ------------------------------------------------------ 3. the train step

B, HW, N_CLS, FEAT = 4, 64, 4, 32
ALPHA, LR, EPOCHS, STEPS_PER_EPOCH = 0.99, 0.05, 5, 4


class FlipSecondCall:
    """The injected augmentation: identity for the first view of a step,
    a horizontal flip (NHWC axis 2) for MoCoSSTT's second view."""

    def __init__(self, flip):
        self.flip, self.calls = flip, 0

    def __call__(self, images, _rng):
        self.calls += 1
        return images if self.calls % 2 else self.flip(images)


def _cfgs(mem, attn, K):
    jc = JConfig()
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                    mem=mem, head="mlp", attn=attn)
    tc = Config()
    tc.model_s = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.model_t = ModelConfig(name="effiB0", n_cls=N_CLS)
    tc.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                         mem=mem, head="mlp", attn=attn)
    return jc, tc


@pytest.fixture(scope="module")
def backbones():
    model = efficientnet_b0(num_classes=N_CLS)
    init = make_init_ordered(model, (2, HW, HW, 3))
    return model, init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))


def _setup(mem, attn, K):
    jheads = JHeads(head="mlp", attn=attn, feat_dim=FEAT, s_dim=1280,
                    t_dim=1280)
    cmo_params, _ = heads_init(jheads, 2)
    cmo = ordered_numpy({"params": cmo_params})
    rs = np.random.RandomState(3)
    banks = (("memory_s", "memory_t") if mem in ("MoCoST", "MoCoSSTT")
             else ("memory",))
    return jheads, cmo, {n: _memory(rs, K, FEAT) for n in banks}


def _batches(n):
    rs = np.random.RandomState(7)
    return [{"image": rs.randn(B, HW, HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
             "shuffle_perm": rs.permutation(B).astype(np.int32)}
            for _ in range(n)]


_JAX_PROGRAMS = {}


def _jax_run(backbones, setup, cfg, programs, batches, augment):
    model, vs, vt = backbones
    jheads, cmo, mems = setup
    # one optimizer and, without an injected augmentation, one jitted step
    # per (mem, attn, K, BN mode) for the whole module: a later case on the
    # same process reuses the compiled program (the optimizer is a static
    # field of the state, so it must be the same object for the cache to hit)
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
        queue=JQ.QueueState(
            memory={n: jnp.asarray(m) for n, m in mems.items()},
            ptr=jnp.zeros((), jnp.int32)),
        opt_state=_JAX_PROGRAMS["tx_init"](params), tx=tx,
        apply_fn=model.apply,
        teacher_apply_fn=model.apply)
    steps = {}
    for flag in set(programs):
        key = (cfg.moma.mem, cfg.moma.attn, cfg.moma.nce_k, flag)
        if augment is not None or key not in _JAX_PROGRAMS:
            step = quick_compiled(j_make_step(
                cfg, jheads, augment_fn=augment, donate=False,
                kl_train_bn_override=flag))
            if augment is not None:
                steps[flag] = step
                continue
            _JAX_PROGRAMS[key] = step
        steps[flag] = _JAX_PROGRAMS[key]
    metrics = []
    for flag, b in zip(programs, batches):
        state, m = steps[flag](state, {k: jnp.asarray(v) for k, v in
                                       b.items()}, jax.random.PRNGKey(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _torch_run(backbones, setup, cfg, programs, batches, augment):
    _, vs, vt = backbones
    _, cmo, mems = setup
    student = EfficientNet("b0", num_classes=N_CLS)
    teacher = EfficientNet("b0", num_classes=N_CLS)
    heads = CMOHeads("mlp", cfg.moma.attn, FEAT, s_dim=1280, t_dim=1280)
    load_jax_variables(student, vs)
    load_jax_variables(teacher, vt)
    load_jax_variables(heads, cmo)
    teacher.requires_grad_(False)
    heads.embed_t.requires_grad_(False)
    queue = TQ.QueueState({n: torch.zeros(m.shape) for n, m in mems.items()})
    load_jax_variables(queue, {"memory": mems, "ptr": 0})
    state = MomaState(
        student=student, teacher=teacher, heads=heads, queue=queue,
        optimizer=None,
        schedule=lr_schedule(LR, EPOCHS, STEPS_PER_EPOCH, cosine=True))
    state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
    steps = {flag: make_moma_train_step(cfg, augment,
                                        kl_train_bn_override=flag)
             for flag in set(programs)}
    metrics = []
    for flag, b in zip(programs, batches):
        state, m = steps[flag](
            state, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.Generator().manual_seed(9))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize(
    "mem,attn,K,programs,rtol,kd_rtol,div_rtol,upd_rtol,att_rtol", [
        ("MoCoAtt", "all", 2048, (True,), 1e-4, 2e-4, 5e-4, 2e-3, 2e-3),
        ("MoCoAtt", "all", 2048, (False, True, True), 1e-3, 1e-3, 3e-3, 1e-2,
         1e-2),
        ("MoCoAtt", "dual", 2048, (True,), 1e-4, 2e-4, 5e-4, 2e-3, 0.5),
        ("MoCoST", "self", 64, (True,), 1e-4, 1e-4, 5e-4, 2e-3, 2e-3),
        ("MoCoSSTT", "self", 64, (True,), 1e-4, 1e-4, 5e-4, 2e-3, 2e-3),
    ], ids=["mocoatt-all-1step", "mocoatt-all-3step-exact", "mocoatt-dual-1step",
        "mocost-1step", "mocosstt-1step"])
def test_mem_variant_step_matches_jax(backbones, mem, attn, K, programs, rtol,
                                      kd_rtol, div_rtol, upd_rtol, att_rtol):
    setup = _setup(mem, attn, K)
    jc, tc = _cfgs(mem, attn, K)
    batches = _batches(len(programs))
    sstt = mem == "MoCoSSTT"
    j_aug = FlipSecondCall(lambda x: jnp.flip(x, 2)) if sstt else None
    t_aug = FlipSecondCall(lambda x: torch.flip(x, (2,))) if sstt else None
    js, jm = _jax_run(backbones, setup, jc, programs, batches, j_aug)
    ts, tm = _torch_run(backbones, setup, tc, programs, batches, t_aug)
    if sstt:
        assert t_aug.calls == 2 * len(programs)
    _, vs, vt = backbones
    _, cmo, mems = setup

    tols = {"loss": rtol, "loss_cls": rtol, "loss_div": div_rtol,
            "loss_kd": kd_rtol}
    for a, b in zip(tm, jm):
        for k, tol in tols.items():
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
            # an attention module's leaves are held to the module's largest
            # update: the key third of a qkv bias has a zero true gradient
            # (softmax ignores a shift of all keys), so there both sides
            # hold only the rounding of the module's other gradients
            module = path.split("/")[1]
            is_att = module.startswith("atts")
            tol = att_rtol if is_att else upd_rtol
            scale = group_floor(upd_ref[module], 1.0) if is_att else floor
            # and no update is resolved below one float32 ulp of the weight
            # it was added to
            ulp = 2.0 ** -23 * float(np.abs(init_leaves[path]).max())
            assert_close_scaled(np.asarray(g) - init_leaves[path], w, tol,
                                path + " update", max(scale, ulp / tol))
    for n in mems:
        assert_close_scaled(ts.queue.memory[n].numpy(),
                            np.asarray(js.queue.memory[n]), rtol,
                            f"queue/{n}")
