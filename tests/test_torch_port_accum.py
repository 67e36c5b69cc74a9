"""Gradient accumulation (--grad_accum): moma_tpu_torch against moma_tpu's
grad_accum steps on the CPU.

- cross-arch (EmaTec) MoMA at `grad_accum=2` against JAX's accumulated
  cross-arch step (moma.py `_make_moma_accum_step(cross_arch=True)`): the
  same resnet8 student and batch, a small ViT teacher (patch 8, dim 32,
  depth 2, 2 heads) at 16^2, the EMA copy starting at the student's
  weights, no augmentation; the MoMA cases' tolerances, the EMA copy, its
  statistics and the EMA key head at 1e-4, the fixed teacher unchanged.
- MoMA: the port's `grad_accum=2` step against JAX's, for the three cases
  of tests/test_moma_grad_accum.py (MoCo without augmentation, MoCo and
  MoCoSSTT with its noise augmentation): resnet8 at 16^2, batch 8, K=64,
  feat_dim 32, the permutation PERM, kl_teacher_bn 'train', SGD without
  momentum at lr 0.1.  The augmentation adds JAX's own noise draws: the
  port's augment looks up which virtual rank's generator (and which of
  its two views) it was called with and adds that rank's noise of
  fold_in(k_aug, i) (fold_in(k_aug2, i) for MoCoSSTT's second view), so a
  step that sends a microbatch the wrong stream fails.  Compared as
  tests/test_moma_grad_accum.py compares JAX's accum step with its
  2-device 'local' step: metrics 2e-5, parameters, BN running statistics
  and the queue (2e-4, 1e-5 for the EMA teacher, 1e-4 for the queue); and
  the updates ((after - before) / lr: the averaged gradients) to 5e-3,
  the tolerance tests/test_moma_local_bn.py holds gradients to, relative
  with a floor at 1e-3 of the group's largest entry.
- vanilla: grad_accum=2 against JAX's (tests/test_grad_accum.py's
  resnet8 at 32^2, batch 16, cifar normalization, SGD with momentum and
  decay under a cosine schedule): metrics, parameters and the chained BN
  running statistics to 1e-4, the updates to 2e-3 (the tolerances of
  tests/test_torch_port_cifar.py's resnet8 step).
- distill: kd and crd at grad_accum=2 against JAX's (resnet8 student and
  teacher at 32^2, batch 8; crd's banks chain across the microbatches):
  metrics, parameters, aux modules, BN statistics and the banks to 1e-4
  (tests/test_torch_port_distill.py's one-step tolerance).
- the refusals, with the JAX package's messages (each compared with the
  exception JAX raises for the same configuration);
- --remat inside the accumulated MoMA step: the same step, to 1e-6.

resnet8 is a ReLU net: every batch keeps the student's ReLU inputs (and
the mlp head's), over each microbatch, 5e-6 away from 0 (`_check_kinks`;
README, "ReLU nets and parity"), the data seeds chosen so.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.core.config import Config as JConfig
from moma_tpu.core.config import DistillConfig as JDistill
from moma_tpu.core.config import ModelConfig as JModel
from moma_tpu.core.config import MomaConfig as JMoma
from moma_tpu.core.mesh import create_mesh
from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
from moma_tpu.data.augment import cifar_eval_normalize as j_cifar_norm
from moma_tpu.losses.crd import CRDMemory as JCRD
from moma_tpu.models import create_model as j_create_model
from moma_tpu.models.vit import VisionTransformer as JViT
from moma_tpu.moma.cmo import CMOHeads as JHeads
from moma_tpu.moma.queue import QueueState as JQueue
from moma_tpu.train import distill as JD
from moma_tpu.train.moma import make_moma_train_step as j_make_step
from moma_tpu.train.state import DistillState as JDState
from moma_tpu.train.state import MomaState as JState
from moma_tpu.train.state import TrainState as JTrainState
from moma_tpu.train.state import make_sgd as j_make_sgd
from moma_tpu.train.steps import make_vanilla_train_step as j_vanilla_step

from moma_tpu_torch.core.config import (Config, DistillConfig, ModelConfig,
                                        MomaConfig)
from moma_tpu_torch.core.mesh import rank_generator
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data.augment import cifar_eval_normalize
from moma_tpu_torch.interop import (jax_aux_variables, jax_variables,
                                    load_jax_aux, load_jax_variables)
from moma_tpu_torch.losses.crd import CRDMemory
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.vit import VisionTransformer
from moma_tpu_torch.moma.cmo import CMOHeads
from moma_tpu_torch.train import distill as TD
from moma_tpu_torch.train.moma import make_moma_train_step
from moma_tpu_torch.train.state import DistillState, TrainState, make_sgd
from moma_tpu_torch.train.steps import make_vanilla_train_step

import torch_dist_workers as W
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled, group_floor,
                                heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = 2
# the MoMA cases (tests/test_moma_grad_accum.py)
B, HW, N_CLS, S_DIM, FEAT, K = 8, 16, 6, 64, 32, 64
ALPHA, LR = 0.999, 0.1
PERM = np.array([5, 2, 7, 0, 3, 6, 1, 4], dtype=np.int64)
MOMA_SEED = 3   # tests/test_moma_grad_accum.py's own
# the vanilla and distill steps
V_B, V_HW, V_N_CLS, V_SEED = 16, 32, 10, 20
D_B, D_FEAT, D_N_DATA, D_NCE_K, D_SEED = 8, 16, 64, 16, 7
KINK = 5e-6


def _check_kinks(model, images, n_micro, head=None):
    """Every ReLU input of the train-mode forward of each microbatch (and
    of `head` on its pooled features) is at least KINK away from 0; run
    on copies, whose running statistics the forwards may change."""
    model = copy.deepcopy(model).train()
    head = copy.deepcopy(head)
    mb = images.shape[0] // n_micro
    for i in range(n_micro):
        with torch.no_grad(), ReluInputs() as kinks:
            feats, _ = model(images[i * mb:(i + 1) * mb])
            if head is not None:
                head.train()(feats[-1])
        assert kinks.low > KINK, (i, kinks.low)


def _close_tree(got, want, rtol, tag, floor_frac=1e-3):
    want = jax.device_get(want)
    floor = group_floor(want, floor_frac)
    for path, g, w in walk_pairs(got, want, tag):
        assert_close_scaled(g, w, rtol, path, floor)


def _updates(after, before, lr):
    return jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        / lr, after, before)


# ------------------------------------------------------------------ MoMA

def _jax_noise_augment(images, key):
    return images + 0.05 * jax.random.normal(key, images.shape, images.dtype)


@pytest.fixture(scope="module")
def moma_init():
    model = j_create_model("resnet8", num_classes=N_CLS)
    init = make_init_ordered(model, (2, HW, HW, 3))
    vs, vt = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
    jh = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=S_DIM,
                t_dim=S_DIM)
    p, bs = heads_init(jh, 2)
    hv = ordered_numpy({"params": p, "batch_stats": bs})
    rs = np.random.RandomState(MOMA_SEED)
    images = rs.rand(B, HW, HW, 3).astype(np.float32)
    labels = rs.randint(0, N_CLS, (B,)).astype(np.int64)
    memory = rs.randn(K, FEAT).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=1, keepdims=True)
    # the noise of each virtual rank's two views (rng splits of the JAX
    # accum step with a shuffle_perm given: k_aug, then MoCoSSTT's k_aug2)
    rng, k_aug = jax.random.split(jax.random.PRNGKey(7))
    _, k_aug2 = jax.random.split(rng)
    mb = B // M
    noise = [[np.asarray(0.05 * jax.random.normal(
        jax.random.fold_in(k, i), (mb, HW, HW, 3), jnp.float32))
        for i in range(M)] for k in (k_aug, k_aug2)]
    st = create_model("resnet8", N_CLS)
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=S_DIM)
    load_jax_variables(st, vs)
    load_jax_variables(ph, hv)
    for view in (0, 1):
        noisy = images + np.concatenate(noise[view])
        for ims in (images, noisy):
            _check_kinks(st, torch.from_numpy(ims), M, ph.embed_s)
    return model, jh, vs, vt, hv, images, labels, memory, noise


def _port_inputs(moma_init):
    model, jh, vs, vt, hv, images, labels, memory, _ = moma_init
    st, te = create_model("resnet8", N_CLS), create_model("resnet8", N_CLS)
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=S_DIM)
    load_jax_variables(st, vs)
    load_jax_variables(te, vt)
    load_jax_variables(ph, hv)
    return {"B": B, "model": "resnet8", "n_cls": N_CLS, "feat": FEAT,
            "K": K, "alpha": ALPHA, "lr": LR, "s_dim": S_DIM,
            "kl_teacher_bn": "train",
            "weights": {"mlp": {"student": st.state_dict(),
                                "teacher": te.state_dict(),
                                "heads": ph.state_dict()}},
            "images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels),
            "memory": torch.from_numpy(memory)}


class JaxNoise:
    """The port's augment_fn for the parity runs: a generator of virtual
    rank i gets rank i's JAX noise, its first call the first view's, its
    second MoCoSSTT's second view's."""

    def __init__(self, noise, generator):
        self.noise = noise
        self.rank_of = {rank_generator(generator, i).initial_seed(): i
                        for i in range(M)}
        self.calls = {}

    def __call__(self, images, generator):
        i = self.rank_of[generator.initial_seed()]
        view = self.calls.get(i, 0)
        self.calls[i] = view + 1
        return images + torch.from_numpy(self.noise[view][i])


def _jax_moma(moma_init, mem, augment):
    model, jh, vs, vt, hv, images, labels, memory, _ = moma_init
    cfg = JConfig()
    cfg.data.dataset = "synthetic"
    cfg.data.batch_size = B
    cfg.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0,
                           kd_T=4.0)
    cfg.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                     mem=mem, head="mlp", attn="self", shuffle_bn=True,
                     kl_teacher_bn="train")
    cfg.model_s = JModel(name="resnet8", n_cls=N_CLS)
    cfg.model_t = JModel(name="resnet8", n_cls=N_CLS)
    cfg.run.grad_accum = M
    names = (("memory_s", "memory_t") if mem in ("MoCoST", "MoCoSSTT")
             else ("memory",))
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "cmo": hv["params"]}
    state = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        queue=JQueue(memory={n: jnp.asarray(memory) for n in names},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, apply_fn=model.apply,
        teacher_apply_fn=model.apply)
    step = quick_compiled(j_make_step(
        cfg, jh, augment_fn=_jax_noise_augment if augment else None,
        donate=False))
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(labels.astype(np.int32)),
             "shuffle_perm": jnp.asarray(PERM.astype(np.int32))}
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return jax.device_get(new), {k: float(v) for k, v in metrics.items()}


def _port_moma(moma_init, mem, augment, remat=False):
    noise = moma_init[-1]
    inp = _port_inputs(moma_init)
    state = W.moma_state(inp, "mlp", mem=mem)
    cfg = W.moma_config("global", "mlp", inp, grad_accum=M, mem=mem)
    cfg.run.remat = remat
    g = torch.Generator().manual_seed(7)
    step = make_moma_train_step(cfg, JaxNoise(noise, g) if augment
                                else None)
    state, metrics = step(state, W.rank_batch(inp, 0, 1,
                                              torch.from_numpy(PERM)), g)
    return state, metrics


@pytest.mark.parametrize("mem,augment", [
    ("MoCo", False), ("MoCo", True), ("MoCoSSTT", True),
], ids=["moco", "moco-noise", "mocosstt-noise"])
def test_moma_accum_matches_jax(moma_init, mem, augment):
    model, jh, vs, vt, hv, *_ = moma_init
    js, jm = _jax_moma(moma_init, mem, augment)
    ts, tm = _port_moma(moma_init, mem, augment)
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    assert int(tm["queue_ptr"]) == int(jm["queue_ptr"]) == B

    s = jax_variables(ts.student, vs)
    t = jax_variables(ts.teacher, vt)
    cmo = jax_variables(ts.heads, hv)
    _close_tree(s["params"], js.params["student"], 2e-4, "student")
    _close_tree(cmo["params"], js.params["cmo"], 2e-4, "cmo")
    _close_tree(_updates(s["params"], vs["params"], LR),
                _updates(js.params["student"], vs["params"], LR), 5e-3,
                "student_grad")
    for name in ("embed_s", "atts_q"):
        _close_tree(_updates(cmo["params"][name], hv["params"][name], LR),
                    _updates(js.params["cmo"][name], hv["params"][name], LR),
                    5e-3, name + "_grad")
    _close_tree(t["params"], js.teacher_params, 1e-5, "teacher")
    # phase B's running statistics, averaged over the virtual ranks
    _close_tree(t["batch_stats"], js.teacher_batch_stats, 2e-4, "teacher_bs")
    _close_tree(s["batch_stats"], js.batch_stats["student"], 2e-4, "bs")
    for name, mem_t in ts.queue.memory.items():
        assert_close_scaled(mem_t.numpy(), np.asarray(js.queue.memory[name]),
                            1e-4, f"queue:{name}")


VIT = dict(patch_size=8, dim=32, depth=2, num_heads=2)


def test_cross_arch_accum_matches_jax(moma_init):
    """Cross-arch MoMA at --grad_accum 2: each microbatch its own teacher,
    EMA-copy and student forwards, the keys of both enqueued in order, one
    SGD step and one EMA update, as JAX's accumulated cross-arch step."""
    model, _, vs, _, _, images, labels, memory, _ = moma_init
    jvit = JViT(num_classes=N_CLS, **VIT)
    vt_x = make_init_ordered(jvit, (2, HW, HW, 3))(jax.random.PRNGKey(1))
    jh = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=S_DIM,
                t_dim=VIT["dim"], include_ema=True)
    p, bs = heads_init(jh, 2)
    hv = ordered_numpy({"params": p, "batch_stats": bs})
    vit = VisionTransformer(**VIT, num_classes=N_CLS, image_size=HW)
    load_jax_variables(vit, vt_x)
    ph = CMOHeads("mlp", "self", FEAT, s_dim=S_DIM, t_dim=VIT["dim"],
                  include_ema=True)
    load_jax_variables(ph, hv)
    inp = _port_inputs(moma_init)
    inp.update(HW=HW, cross={"vit": VIT, "teacher": vit.state_dict(),
                             "heads": ph.state_dict()})
    state, cfg = W.cross_state(inp, grad_accum=M)
    # the EMA copy is the student at the step's start
    _check_kinks(state.student, torch.from_numpy(images), M, ph.embed_s)
    _check_kinks(state.student, torch.from_numpy(images), M, ph.embed_ema)

    jc = JConfig()
    jc.data.dataset = "synthetic"
    jc.data.batch_size = B
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0,
                          kd_T=4.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=ALPHA,
                    mem="MoCo", head="mlp", attn="self", shuffle_bn=True,
                    kl_teacher_bn="train")
    jc.model_s = JModel(name="resnet8", n_cls=N_CLS)
    jc.model_t = JModel(name="vit_tiny_patch16_224", n_cls=N_CLS)
    jc.run.grad_accum = M
    tx = j_make_sgd(LR, momentum=0.0, weight_decay=0.0)
    params = {"student": vs["params"], "cmo": hv["params"]}
    js = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"],
                     "cmo": hv["batch_stats"]},
        teacher_params=vt_x["params"],
        teacher_batch_stats=vt_x.get("batch_stats", {}),
        queue=JQueue(memory={"memory": jnp.asarray(memory)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=tx.init(params), tx=tx, ema_params=vs["params"],
        ema_batch_stats=vs["batch_stats"], apply_fn=model.apply,
        teacher_apply_fn=jvit.apply)
    js, jm = quick_compiled(j_make_step(jc, jh, augment_fn=None,
                                        donate=False, cross_arch=True))(
        js, {"image": jnp.asarray(images),
             "label": jnp.asarray(labels.astype(np.int32)),
             "shuffle_perm": jnp.asarray(PERM.astype(np.int32))},
        jax.random.PRNGKey(7))
    js = jax.device_get(js)

    step = make_moma_train_step(cfg, None, cross_arch=True)
    ts, tm = step(state, W.rank_batch(inp, 0, 1, torch.from_numpy(PERM)),
                  torch.Generator().manual_seed(7))
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    assert int(tm["queue_ptr"]) == int(jm["queue_ptr"]) == B
    s = jax_variables(ts.student, vs)
    e = jax_variables(ts.ema, vs)
    cmo = jax_variables(ts.heads, hv)
    _close_tree(s["params"], js.params["student"], 2e-4, "student")
    _close_tree(cmo["params"], js.params["cmo"], 2e-4, "cmo")
    _close_tree(_updates(s["params"], vs["params"], LR),
                _updates(js.params["student"], vs["params"], LR), 5e-3,
                "student_grad")
    for name in ("embed_s", "atts_q"):
        _close_tree(_updates(cmo["params"][name], hv["params"][name], LR),
                    _updates(js.params["cmo"][name], hv["params"][name], LR),
                    5e-3, name + "_grad")
    _close_tree(e["params"], js.ema_params, 1e-4, "ema")
    _close_tree(e["batch_stats"], js.ema_batch_stats, 1e-4, "ema_bs")
    _close_tree(cmo["params"]["embed_ema"], js.params["cmo"]["embed_ema"],
                1e-4, "embed_ema")
    _close_tree(s["batch_stats"], js.batch_stats["student"], 2e-4, "bs")
    for path, g, w in walk_pairs(jax_variables(ts.teacher, vt_x), vt_x):
        np.testing.assert_array_equal(g, w, err_msg=path)
    assert_close_scaled(ts.queue.memory["memory"].numpy(),
                        np.asarray(js.queue.memory["memory"]), 1e-4,
                        "queue")


def test_moma_accum_composes_with_remat(moma_init):
    """--remat recomputes each microbatch's student forward in its
    backward: the same step."""
    (sa, ma), (sb, mb) = (_port_moma(moma_init, "MoCo", True, remat=r)
                          for r in (False, True))
    for k in W.MOMA_KEYS:
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=1e-6)
    for part in ("student", "heads", "teacher"):
        a, b = getattr(sa, part).state_dict(), getattr(sb, part).state_dict()
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{part}/{k}")


# --------------------------------------------------------------- vanilla

def test_vanilla_accum_matches_jax():
    """BN statistics chained from one microbatch to the next, gradients
    averaged: the port's step against JAX's."""
    jm = j_create_model("resnet8", num_classes=V_N_CLS)
    v0 = make_init_ordered(jm, (2, V_HW, V_HW, 3))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(V_SEED)
    images = rs.randint(0, 256, (V_B, V_HW, V_HW, 3), dtype=np.uint8)
    labels = rs.randint(0, V_N_CLS, (V_B,)).astype(np.int32)
    tm = create_model("resnet8", V_N_CLS)
    load_jax_variables(tm, v0)
    tm = tm.to(memory_format=torch.channels_last)
    _check_kinks(tm, cifar_eval_normalize(torch.from_numpy(images)), M)

    tx = j_make_sgd(j_lr_schedule(0.1, 4, 4, cosine=True), 0.9, 5e-4)
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=v0["params"],
                     batch_stats=v0["batch_stats"],
                     opt_state=jax.jit(tx.init)(v0["params"]), tx=tx,
                     apply_fn=jm.apply)
    js, jmet = quick_compiled(j_vanilla_step(
        lambda im, rng: j_cifar_norm(im), donate=False, grad_accum=M))(
        js, {"image": jnp.asarray(images), "label": jnp.asarray(labels)},
        jax.random.PRNGKey(5))
    ts = TrainState(model=tm, optimizer=make_sgd(tm.parameters(), 0.9, 5e-4),
                    schedule=lr_schedule(0.1, 4, 4, cosine=True))
    ts, tmet = make_vanilla_train_step(
        lambda im, g: cifar_eval_normalize(im), grad_accum=M)(
        ts, {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)},
        torch.Generator().manual_seed(5))
    for k in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    got = jax_variables(ts.model, v0)
    _close_tree(got["params"], js.params, 1e-4, "params")
    _close_tree(got["batch_stats"], js.batch_stats, 1e-4, "batch_stats")
    _close_tree(_updates(got["params"], v0["params"], 1.0),
                _updates(js.params, v0["params"], 1.0), 2e-3, "update")


# --------------------------------------------------------------- distill

def _distill_cfgs(method):
    jc = JConfig()
    jc.data.batch_size = D_B
    jc.model_t = JModel(name="resnet8", n_cls=V_N_CLS)
    jc.distill = JDistill(distill=method, cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=D_FEAT, nce_k=D_NCE_K, nce_t=0.07, nce_m=0.5)
    tc = Config()
    tc.data.batch_size = D_B
    tc.model_s = ModelConfig(name="resnet8", n_cls=V_N_CLS)
    tc.model_t = ModelConfig(name="resnet8", n_cls=V_N_CLS)
    tc.distill = DistillConfig(distill=method, cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=D_FEAT, nce_k=D_NCE_K, nce_t=0.07,
                         nce_m=0.5)
    return jc, tc


@pytest.mark.parametrize("method", ["kd", "crd"])
def test_distill_accum_matches_jax(method):
    """kd, and crd whose banks and Z constants chain across the
    microbatches (every sample's rows written once a step)."""
    jm = j_create_model("resnet8", num_classes=V_N_CLS)
    init = make_init_ordered(jm, (2, V_HW, V_HW, 3))
    vs, vt = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
    rs = np.random.RandomState(D_SEED)
    images = rs.rand(D_B, V_HW, V_HW, 3).astype(np.float32)
    labels = rs.randint(0, V_N_CLS, (D_B,)).astype(np.int32)
    idx = rs.permutation(D_N_DATA)[:D_B].astype(np.int32)
    cidx = rs.randint(0, D_N_DATA, (D_B, D_NCE_K + 1)).astype(np.int32)
    cidx[:, 0] = idx
    stdv = 1.0 / np.sqrt(D_FEAT / 3)
    v1, v2 = (rs.uniform(-stdv, stdv, (D_N_DATA, D_FEAT)).astype(np.float32)
              for _ in range(2))
    batch = {"image": images, "label": labels, "index": idx,
             "contrast_idx": cidx}

    student, teacher = (create_model("resnet8", V_N_CLS) for _ in range(2))
    load_jax_variables(student, vs)
    load_jax_variables(teacher, vt)
    _check_kinks(student, torch.from_numpy(images), M)
    shapes = TD.probe_shapes(student, V_HW, D_B)[0]
    jc, tc = _distill_cfgs(method)
    jd = JD.Distiller(jc, shapes, shapes, n_data=D_N_DATA, batch_size=D_B)
    aux_p, aux_bs = (ordered_numpy(t) for t in
                     jd.init_aux(jax.random.PRNGKey(3)))
    tx = j_make_sgd(j_lr_schedule(0.05, 5, 4, cosine=True), 0.9, 5e-4)
    params = {"student": vs["params"], "aux": aux_p}
    js = JDState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "aux": aux_bs},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        opt_state=jax.jit(tx.init)(params), tx=tx,
        extra=(JCRD(v1=jnp.asarray(v1), v2=jnp.asarray(v2),
                    z_v1=jnp.asarray(-1.0), z_v2=jnp.asarray(-1.0))
               if method == "crd" else None),
        apply_fn=jm.apply, teacher_apply_fn=jm.apply)
    js, jmet = quick_compiled(JD.make_distill_train_step(
        jd, None, donate=False, grad_accum=M))(
        js, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(9))

    td = TD.Distiller(tc, shapes, shapes, n_data=D_N_DATA, batch_size=D_B)
    aux = td.init_aux(torch.Generator().manual_seed(0))
    load_jax_aux(aux, aux_p, aux_bs)
    ts = DistillState(
        student=student, aux=aux, teacher=teacher.requires_grad_(False),
        optimizer=None, schedule=lr_schedule(0.05, 5, 4, cosine=True),
        extra=(CRDMemory(torch.from_numpy(v1.copy()),
                         torch.from_numpy(v2.copy()), torch.tensor(-1.0),
                         torch.tensor(-1.0)) if method == "crd" else None))
    ts.optimizer = make_sgd(ts.trainable_params(), 0.9, 5e-4)
    ts, tmet = TD.make_distill_train_step(td, None, grad_accum=M)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(9))
    for k in ("loss", "loss_cls", "loss_div", "loss_kd", "acc1"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got = jax_variables(ts.student, vs)
    _close_tree(got["params"], js.params["student"], 1e-4, "student")
    _close_tree(got["batch_stats"], js.batch_stats["student"], 1e-4, "bs")
    if aux_p:
        got_p, got_bs = jax_aux_variables(ts.aux, aux_p, aux_bs)
        _close_tree(got_p, js.params["aux"], 1e-4, "aux")
    if method == "crd":
        for k in ("v1", "v2", "z_v1", "z_v2"):
            assert_close_scaled(getattr(ts.extra, k).numpy(),
                                np.asarray(getattr(js.extra, k)), 1e-4, k)
        moved = np.abs(ts.extra.v1.numpy() - v1).max(1) > 1e-3
        np.testing.assert_array_equal(np.flatnonzero(moved), np.sort(idx))


# -------------------------------------------------------------- refusals

def _moma_cfgs(bn="global", grad_accum=M, **moma):
    jc, tc = JConfig(), Config()
    for c, D, Mo, Md in ((jc, JDistill, JMoma, JModel),
                         (tc, DistillConfig, MomaConfig, ModelConfig)):
        c.distill = D(distill="moma")
        c.moma = Mo(**moma)
        c.model_s = Md(name="effiB0", n_cls=4)
        c.model_t = Md(name="effiB0", n_cls=4)
        c.run.bn = bn
        c.run.grad_accum = grad_accum
    return jc, tc


@pytest.mark.parametrize("bn,grad_accum,moma", [
    ("local", 2, {}), ("sync", 4, {}),
    ("global", 2, {"fused_teacher": "on"}),
    ("global", 2, {"fast_teacher": True}),
    ("local", 1, {"fused_teacher": "on"}),
], ids=["local-accum", "sync-accum", "fused-accum", "fast-accum",
        "fused-local"])
def test_moma_refusals_carry_the_jax_messages(bn, grad_accum, moma):
    jc, tc = _moma_cfgs(bn, grad_accum, **moma)
    with pytest.raises(ValueError) as want:
        j_make_step(jc, None, None, mesh=create_mesh(jax.devices()[:2]),
                    kl_train_bn_override=True)
    with pytest.raises(ValueError) as got:
        make_moma_train_step(tc, None, kl_train_bn_override=True)
    assert str(got.value) == str(want.value)


def test_indivisible_batches_raise_as_jax_does():
    """batch 8 in 3 microbatches: the MoMA, vanilla and distill steps
    raise JAX's ValueError."""
    want = "batch size 8 not divisible by grad_accum=3"
    _, tc = _moma_cfgs(grad_accum=3, feat_dim=16, nce_k=16)
    tc.model_s = ModelConfig(name="resnet8", n_cls=N_CLS)
    tc.model_t = ModelConfig(name="resnet8", n_cls=N_CLS)
    inp = {"B": B, "model": "resnet8", "n_cls": N_CLS, "feat": 16, "K": 16,
           "alpha": ALPHA, "lr": LR, "s_dim": S_DIM}
    st, te = create_model("resnet8", N_CLS), create_model("resnet8", N_CLS)
    inp["weights"] = {"mlp": {"student": st.state_dict(),
                              "teacher": te.state_dict(),
                              "heads": CMOHeads("mlp", "self", 16, S_DIM,
                                                S_DIM).state_dict()}}
    inp["memory"] = torch.nn.functional.normalize(torch.randn(16, 16), dim=1)
    batch = {"image": torch.rand(B, HW, HW, 3),
             "label": torch.zeros(B, dtype=torch.long)}
    steps = [
        (make_moma_train_step(tc, None, kl_train_bn_override=True),
         W.moma_state(inp, "mlp")),
        (make_vanilla_train_step(None, grad_accum=3),
         W.vanilla_state({**inp, "weights": inp["weights"]})),
    ]
    for step, state in steps:
        with pytest.raises(ValueError) as got:
            step(state, batch, torch.Generator().manual_seed(0))
        assert str(got.value) == want
    _, dc = _distill_cfgs("kd")
    shapes = TD.probe_shapes(st, HW, B)[0]
    td = TD.Distiller(dc, shapes, shapes)
    ds = DistillState(student=st, aux=td.init_aux(torch.Generator()),
                      teacher=te, optimizer=None, schedule=lambda s: 0.1)
    ds.optimizer = make_sgd(ds.trainable_params())
    with pytest.raises(ValueError) as got:
        TD.make_distill_train_step(td, None, grad_accum=3)(
            ds, batch, torch.Generator())
    assert str(got.value) == want
