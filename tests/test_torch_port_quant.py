"""int8 quantization (core/quantize.py, ops/int8_conv.py) and
`--teacher_quant int8`: moma_tpu_torch against moma_tpu on the CPU.

(i)   each kind of quantized layer through JAX's interception (static
      scales from `calibrate`, and dynamic ones) and the port's plain int8
      path, same numpy inputs and weights: bit for bit.  JAX runs eagerly
      here: under jit XLA's CPU backend turns a division by the (constant)
      calibrated scale into a product with its reciprocal and contracts
      the epilogue's product and bias into one FMA, both of which move a
      value by its last bit; eagerly each operation rounds once, as the
      port's kernels and plain versions do;
(ii)  the quantizable layers of one forward, their count and kinds in call
      order, against JAX's `collect_quantizable` for resnet8 (9), vgg8 (5,
      its classifier excluded), MobileNetV2 (53), effiB0 (81) and
      vit_tiny_patch16_224 with dense=True (49); and calibrated scales by
      call order for resnet8 and the ViT: the first layer's input is the
      same bits in both packages, its scale equal; the later layers' inputs
      differ by float32 rounding (other summation orders), their scales by
      at most 1e-5 of themselves;
(iii) one same-arch MoMA step (effiB0 at 64^2, batch 4, MoCo, float32,
      train-BN KL forward) with --teacher_quant int8 against JAX's, same
      weights and batch: losses within 1e-4 of JAX's (measured 5.7e-6 of
      loss_div), while the int8 step's loss_div (the KL to the int8
      teacher) differs from the fp step's by more than 10 times its gap to
      JAX's and 10 times that 1e-4 (measured: 30% of it), and loss_cls,
      which no teacher forward reaches, not at all (1e-5).  The port's int8
      activations within 1e-3 of a half-step edge take JAX's side (JAX's
      own quantization of its own input, recorded by an interceptor that
      runs before its quantizing one), and equal JAX's everywhere else: at
      fresh init one value a float32 rounding off an edge that rounds the
      other way in the first depthwise layer (3 of 131072) moves the
      train-mode BatchNorms after it until the two packages' int8 teachers
      differ as much as int8 differs from fp (measured: 22 such values in
      the step's two teacher forwards);
(iv)  a comparison-distiller (kd) step with the flag against JAX's
      (test_teacher_quant.py:121-181): the same, on resnet8 at 32^2, batch
      8 (measured: loss_div 1.1e-5 of it from JAX's, 3.5e-4 from fp);
(v)   the refusals: --fused_teacher on with the flag, an unknown mode;
      each message JAX's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.core import quantize as JQ
from moma_tpu.models import create_model as j_create_model

from moma_tpu_torch.core import quantize as Q
from moma_tpu_torch.interop import load_jax_variables
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models import vit as tvit
from moma_tpu_torch.models.common import Conv2d

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (heads_init, make_init_ordered, ordered_numpy,
                                quick_compiled, quick_jit)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _forward(model, x):
    return model(x)


# (i): (flax layer, the port's layer, input NHWC shape)
LAYERS = {
    # effiB0's stem: TF SAME pads (0, 1) at stride 2 on an even input
    "stem_3x3_s2_same": (lambda: fnn.Conv(8, (3, 3), strides=(2, 2),
                                          padding="SAME", use_bias=False),
                         lambda: Conv2d(3, 8, 3, 2), (2, 16, 16, 3)),
    # resnet's explicit symmetric padding
    "resnet_3x3_pad1": (lambda: fnn.Conv(16, (3, 3), padding=1,
                                         use_bias=False),
                        lambda: Conv2d(16, 16, 3, 1, padding=1),
                        (2, 8, 8, 16)),
    "depthwise_5x5_s2": (lambda: fnn.Conv(24, (5, 5), strides=(2, 2),
                                          padding="SAME",
                                          feature_group_count=24,
                                          use_bias=False),
                         lambda: Conv2d(24, 24, 5, 2, groups=24),
                         (2, 9, 9, 24)),
    # shufflenet's grouped 1x1
    "grouped_1x1": (lambda: fnn.Conv(24, (1, 1), feature_group_count=3,
                                     use_bias=False),
                    lambda: Conv2d(12, 24, 1, 1, groups=3), (2, 6, 6, 12)),
    # effiB0's squeeze-excite reduce: 1x1 with bias on a 1x1 map
    "se_1x1_bias": (lambda: fnn.Conv(8, (1, 1), use_bias=True),
                    lambda: Conv2d(32, 8, 1, bias=True), (2, 1, 1, 32)),
    # the ViT's trunk: a dense layer on (B, tokens, dim)
    "dense_3d": (lambda: fnn.Dense(24), lambda: tvit.Dense(16, 24),
                 (2, 5, 16)),
}


@pytest.mark.parametrize("kind", list(LAYERS))
def test_int8_layer_matches_jax_bit_for_bit(kind):
    make_j, make_t, shape = LAYERS[kind]
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    calib = (x * 0.9).astype(np.float32)   # static scale != the input's own
    jl = make_j()
    v = jl.init(jax.random.key(0), jnp.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    params = {"kernel": jnp.asarray(k)}
    tl = make_t()
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)))
        if tl.bias is not None:
            b = rs.randn(k.shape[-1]).astype(np.float32)
            params["bias"] = jnp.asarray(b)
            tl.bias.copy_(torch.from_numpy(b))
    v = {"params": params}
    dense = kind == "dense_3d"

    def port_in(a):
        t = torch.from_numpy(a)
        return t if dense else t.permute(0, 3, 1, 2)

    def port_out(t):
        return (t if dense else t.permute(0, 2, 3, 1)).detach().numpy()

    # n_cls 1: a lone dense layer is the last call, kept fp as the logits
    # layer unless its width differs from n_cls (_logits_dense_key)
    j_scales = JQ.calibrate(jl.apply, v, [jnp.asarray(calib)], dense=dense,
                            n_cls=1)
    t_scales = Q.calibrate(_forward, tl, [port_in(calib)], dense=dense,
                           n_cls=1)
    assert list(t_scales.values()) == list(j_scales.values()) and len(
        t_scales) == 1
    (scale,) = j_scales.values()
    bound, xj, xt = jl.bind(v), jnp.asarray(x), port_in(x)
    if dense:
        # JAX's dynamic scale (:283) on its dense layer, which only the
        # interception of quantized_apply_dynamic leaves out (:297)
        dyn = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-6) / JQ.QMAX
        cases = ((JQ._quantized_dense(bound, xj, scale),
                  Q._quantized_dense(tl, xt, scale)),
                 (JQ._quantized_dense(bound, xj, dyn),
                  Q._quantized_dense(tl, xt, None)),
                 (JQ.quantized_apply(jl.apply, j_scales)(v, xj),
                  Q.quantized_apply(_forward, t_scales)(tl, xt)))
        with torch.no_grad():
            assert torch.equal(Q.quantized_apply_dynamic(_forward)(tl, xt),
                               tl(xt))
    else:
        cases = ((JQ._quantized_conv(bound, xj, scale),
                  Q._quantized_conv(tl, xt, scale)),
                 (JQ._dynamic_conv(bound, xj), Q._quantized_conv(tl, xt, None)),
                 (JQ.quantized_apply(jl.apply, j_scales)(v, xj),
                  Q.quantized_apply(_forward, t_scales)(tl, xt)),
                 (JQ.quantized_apply_dynamic(jl.apply)(v, xj),
                  Q.quantized_apply_dynamic(_forward)(tl, xt)))
    for want, got in cases:
        want, got = np.asarray(want), port_out(got)
        assert got.shape == want.shape and got.dtype == want.dtype, kind
        np.testing.assert_array_equal(got, want, err_msg=kind)


# (ii): name -> (image size, dense, JAX's count)
COVERAGE = {"resnet8": (32, False, 9), "vgg8": (32, True, 5),
            "MobileNetV2": (32, False, 53), "effiB0": (64, False, 81),
            "vit_tiny_patch16_224": (32, True, 49)}


@pytest.mark.parametrize("name", list(COVERAGE))
def test_quantizable_layers_match_jax(name):
    """The layers, and for resnet8 and the ViT the calibrated scales."""
    size, dense, n = COVERAGE[name]
    jm = j_create_model(name, num_classes=10)
    sample = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
    abstract = jax.eval_shape(lambda s: jm.init(
        jax.random.PRNGKey(0), s, train=False), sample)
    want = JQ.collect_quantizable(jm.apply, abstract, sample, dense=dense,
                                  n_cls=10, train=False)
    tm = create_model(name, 10, image_size=size).eval()
    got = Q.collect_quantizable(_forward, tm, torch.zeros(2, size, size, 3),
                                dense=dense, n_cls=10)
    assert len(got) == len(want) == n
    assert [k for _, k in got] == [k for _, k in want]
    if name in ("resnet8", "vit_tiny_patch16_224"):
        _calibrated_scales_case(name, size, dense)


def _calibrated_scales_case(name, size, dense):
    """Same weights, scales by call order."""
    rs = np.random.RandomState(0)
    jm = j_create_model(name, num_classes=10)
    x = rs.rand(2, size, size, 3).astype(np.float32)
    v = make_init_ordered(jm, (2, size, size, 3))(jax.random.PRNGKey(0))
    tm = create_model(name, 10, image_size=size).eval()
    load_jax_variables(tm, v)
    j_scales = JQ.calibrate(jm.apply, v, [jnp.asarray(x)], dense=dense,
                            n_cls=10, train=False)
    # JAX's dict comes back from jit with sorted keys: call order is
    # collect_quantizable's
    want = [j_scales[k] for k, _ in JQ.collect_quantizable(
        jm.apply, v, jnp.asarray(x), dense=dense, n_cls=10, train=False)]
    got = list(Q.calibrate(_forward, tm, [torch.from_numpy(x)], dense=dense,
                           n_cls=10).values())
    assert len(got) == len(want) and got[0] == want[0], name
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=name)


# ------------------------------------------------------------------ (iii)

B, HW, N_CLS, K, FEAT, NET, DIM = 4, 64, 4, 64, 32, "effiB0", 1280
LOSSES = ("loss", "loss_cls", "loss_div", "loss_kd")
# an int8 activation whose input lies this close to a half-step edge (in
# quantization steps) may round to either side in the two packages
TIE_TOL = 1e-3


def _moma_cfgs(quant):
    from moma_tpu.core.config import Config as JConfig
    from moma_tpu.core.config import DistillConfig as JDistill
    from moma_tpu.core.config import ModelConfig as JModel
    from moma_tpu.core.config import MomaConfig as JMoma

    from moma_tpu_torch.core.config import (Config, DistillConfig,
                                            ModelConfig, MomaConfig)

    jc = JConfig()
    jc.model_t = JModel(name=NET, n_cls=N_CLS)
    jc.distill = JDistill(distill="moma", cls=1.0, div=1.0, beta=1.0)
    jc.moma = JMoma(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=0.99,
                    mem="MoCo", head="mlp", attn="self", teacher_quant=quant)
    tc = Config()
    tc.model_s = ModelConfig(name=NET, n_cls=N_CLS)
    tc.model_t = ModelConfig(name=NET, n_cls=N_CLS)
    tc.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0)
    tc.moma = MomaConfig(feat_dim=FEAT, nce_k=K, nce_t=0.15, alpha=0.99,
                         mem="MoCo", head="mlp", attn="self",
                         teacher_quant=quant)
    return jc, tc


def _check_losses(got, want, keys=LOSSES, rtol=1e-4):
    """The int8 step's losses within rtol of JAX's int8 step's; the flag
    active: loss_div (the KL to the int8 teacher's logits) of the int8 step
    and of the fp step differ by more than 10 times the int8 step's gap to
    JAX; loss_cls, which no teacher forward reaches, the same in both steps
    (1e-5)."""
    for k in keys:
        assert abs(got["int8"][k] - want[k]) <= rtol * abs(want[k]), (
            k, got["int8"][k], want[k])
    gap = abs(got["int8"]["loss_div"] - want["loss_div"])
    assert abs(got["int8"]["loss_div"] - got["none"]["loss_div"]) > max(
        10 * gap, 1e-7), (got, want)
    assert abs(got["int8"]["loss_cls"] - got["none"]["loss_cls"]) <= 1e-5 * (
        abs(got["none"]["loss_cls"]))


def _jax_recording(apply, qs):
    """`apply` (JAX's teacher_apply_fn) with every dynamically quantized
    convolution's int8 activations appended to `qs` in call order: JAX's
    own expression (quantize.py:283, :213-214) on its own input, computed
    by an interceptor that runs before the quantizing one."""
    def record(next_fun, args, kwargs, context):
        if (args and JQ._is_conv_call(context)
                and JQ._supported(context.module, args[0])):
            x = args[0].astype(jnp.float32)
            s = jnp.maximum(jnp.max(jnp.abs(x)), 1e-6) / JQ.QMAX
            q = jnp.clip(jnp.round(x / s), -JQ.QMAX, JQ.QMAX).astype(jnp.int8)
            jax.debug.callback(lambda q: qs.append(np.array(q)), q,
                               ordered=True)
        return next_fun(*args, **kwargs)

    def wrapped(variables, *args, **kwargs):
        with fnn.intercept_methods(record):
            return apply(variables, *args, **kwargs)

    return wrapped


class _Ties:
    """Context: the port's int8_quantize takes JAX's recorded activations
    (NHWC numpy, call order) wherever its input lies within TIE_TOL of a
    half-step edge, and must equal them everywhere else.  One activation
    a float32 rounding off an edge that rounds the other way moves the
    train-mode BatchNorms after it far beyond float rounding: at effiB0's
    fresh init, 3 values of 131072 in the first depthwise layer move the
    pooled features by a third of their scale."""

    def __init__(self, qs):
        self.qs, self.calls, self.flips = qs, 0, 0

    def __enter__(self):
        self._orig = Q.int8_quantize
        Q.int8_quantize = self._quantize
        return self

    def __exit__(self, *exc):
        Q.int8_quantize = self._orig

    def _quantize(self, x, scale):
        q, s = self._orig(x, scale)
        want = torch.from_numpy(self.qs[self.calls]).permute(0, 3, 1, 2)
        self.calls += 1
        r = x.float() / s
        near = ((r - r.floor()) - 0.5).abs() <= TIE_TOL
        off = q != want
        assert not bool((off & ~near).any()), (self.calls, int(off.sum()))
        self.flips += int(off.sum())
        return torch.where(near, want, q), s


def test_moma_step_with_int8_teacher_matches_jax():
    from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
    from moma_tpu.moma.cmo import CMOHeads as JHeads
    from moma_tpu.moma.queue import QueueState as JQueue
    from moma_tpu.train.moma import _teacher_apply
    from moma_tpu.train.moma import make_moma_train_step as j_make_step
    from moma_tpu.train.state import MomaState as JState
    from moma_tpu.train.state import make_sgd as j_make_sgd

    from moma_tpu_torch.core.schedules import lr_schedule
    from moma_tpu_torch.moma.cmo import CMOHeads
    from moma_tpu_torch.moma.queue import QueueState
    from moma_tpu_torch.train.moma import make_moma_train_step
    from moma_tpu_torch.train.state import MomaState, make_sgd

    model = j_create_model(NET, num_classes=N_CLS)
    init = make_init_ordered(model, (2, HW, HW, 3))
    vs, vt = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
    j_qs = []
    jheads = JHeads(head="mlp", attn="self", feat_dim=FEAT, s_dim=DIM,
                    t_dim=DIM)
    cmo = ordered_numpy({"params": heads_init(jheads, 2)[0]})
    rs = np.random.RandomState(3)
    mem = rs.randn(K, FEAT).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    rs = np.random.RandomState(7)
    batch = {"image": rs.randn(B, HW, HW, 3).astype(np.float32),
             "label": rs.randint(0, N_CLS, (B,)).astype(np.int32),
             "shuffle_perm": rs.permutation(B).astype(np.int32)}

    jc, _ = _moma_cfgs("int8")
    tx = j_make_sgd(j_lr_schedule(0.05, 5, 4, cosine=True), 0.9, 5e-4)
    params = {"student": vs["params"], "cmo": cmo["params"]}

    class _T:
        apply = staticmethod(model.apply)

    jstate = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "cmo": {}},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        queue=JQueue(memory={"memory": jnp.asarray(mem)},
                     ptr=jnp.zeros((), jnp.int32)),
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=model.apply,
        teacher_apply_fn=_jax_recording(_teacher_apply(jc, _T), j_qs))
    jstep = quick_compiled(j_make_step(jc, jheads, augment_fn=None,
                                       donate=False,
                                       kl_train_bn_override=True))
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                  jax.random.PRNGKey(9))
    want = {k: float(jm[k]) for k in LOSSES}
    jax.effects_barrier()
    assert len(j_qs) == 2 * COVERAGE[NET][2]   # the KL and key forwards

    got = {}
    for quant in ("int8", "none"):
        _, tc = _moma_cfgs(quant)
        student, teacher = create_model(NET, N_CLS), create_model(NET, N_CLS)
        heads = CMOHeads("mlp", "self", FEAT, s_dim=DIM, t_dim=DIM)
        for mod, v in ((student, vs), (teacher, vt), (heads, cmo)):
            load_jax_variables(mod, v)
        teacher.requires_grad_(False)
        heads.embed_t.requires_grad_(False)
        state = MomaState(
            student=student, teacher=teacher, heads=heads,
            queue=QueueState({"memory": torch.from_numpy(mem.copy())}),
            optimizer=None, schedule=lr_schedule(0.05, 5, 4, cosine=True))
        state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
        step = make_moma_train_step(tc, None, kl_train_bn_override=True)
        with _Ties(j_qs) as ties:
            _, m = step(state, {k: torch.from_numpy(v) for k, v in
                                batch.items()},
                        torch.Generator().manual_seed(9))
        assert ties.calls == (len(j_qs) if quant == "int8" else 0)
        got[quant] = {k: float(m[k]) for k in LOSSES}
        print(f"{quant}: {ties.flips} int8 activations at half-step edges "
              f"on JAX's side; losses {got[quant]}, JAX's {want}")
    _check_losses(got, want)
    # the flag moves loss_div by more than 10 times the tolerance the int8
    # step is held to
    assert abs(got["int8"]["loss_div"] - got["none"]["loss_div"]) > (
        10 * 1e-4 * abs(want["loss_div"])), (got, want)


def test_kd_step_with_int8_teacher_matches_jax():
    from moma_tpu.core.config import Config as JConfig
    from moma_tpu.core.config import DistillConfig as JDistill
    from moma_tpu.core.schedules import lr_schedule as j_lr_schedule
    from moma_tpu.train.distill import Distiller as JDistiller
    from moma_tpu.train.distill import make_distill_train_step as j_make
    from moma_tpu.train.distill import probe_shapes as j_probe
    from moma_tpu.train.state import DistillState as JState
    from moma_tpu.train.state import make_sgd as j_make_sgd
    from moma_tpu.train.student import _teacher_apply_cfg

    from moma_tpu_torch.core.config import Config, DistillConfig
    from moma_tpu_torch.core.schedules import lr_schedule
    from moma_tpu_torch.train.distill import (Distiller,
                                              make_distill_train_step,
                                              probe_shapes)
    from moma_tpu_torch.train.state import DistillState, make_sgd

    Bk, n_cls, size = 8, 10, 32
    jm = j_create_model("resnet8", num_classes=n_cls)
    init = make_init_ordered(jm, (2, size, size, 3))
    vs, vt = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
    rs = np.random.RandomState(0)
    # normalized floats: raw uint8 would saturate the teacher's softmax to
    # a one-hot and hide the int8 teacher's logits from the KL
    batch = {"image": (rs.randint(0, 256, (Bk, size, size, 3)) / 255.0
                       ).astype(np.float32),
             "label": rs.randint(0, n_cls, (Bk,)).astype(np.int32)}

    def cfgs(quant):
        jc = JConfig()
        jc.data.dataset = "synthetic"
        jc.data.batch_size = Bk
        jc.distill = JDistill(distill="kd", cls=1.0, div=1.0, beta=0.0)
        jc.model_s.n_cls = n_cls
        jc.moma.teacher_quant = quant
        tc = Config()
        tc.data.dataset = "synthetic"
        tc.data.batch_size = Bk
        tc.distill = DistillConfig(distill="kd", cls=1.0, div=1.0, beta=0.0)
        tc.model_s.n_cls = n_cls
        tc.moma.teacher_quant = quant
        return jc, tc

    jc, _ = cfgs("int8")
    fs, _ = j_probe(jm, size, Bk)
    jd = JDistiller(jc, fs, fs, n_data=64, batch_size=Bk)
    tx = j_make_sgd(j_lr_schedule(0.05, 2, 2, cosine=True), 0.9, 5e-4)
    params = {"student": vs["params"], "aux": {}}
    jstate = JState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"student": vs["batch_stats"], "aux": {}},
        teacher_params=vt["params"], teacher_batch_stats=vt["batch_stats"],
        opt_state=tx.init(params), extra=jd.init_extra(jax.random.key(4)),
        tx=tx, apply_fn=jm.apply, teacher_apply_fn=_teacher_apply_cfg(jc, jm))
    jstep = quick_jit(j_make(jd, augment_fn=None, donate=False))
    _, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                 jax.random.PRNGKey(7))
    want = {k: float(m[k]) for k in LOSSES}

    got = {}
    for quant in ("int8", "none"):
        _, tc = cfgs(quant)
        student = create_model("resnet8", n_cls)
        teacher = create_model("resnet8", n_cls)
        load_jax_variables(student, vs)
        load_jax_variables(teacher, vt)
        td = Distiller(tc, probe_shapes(student, size, Bk)[0],
                       probe_shapes(teacher, size, Bk)[0], n_data=64,
                       batch_size=Bk)
        state = DistillState(
            student=student, aux=td.init_aux(torch.Generator()),
            teacher=teacher.requires_grad_(False).eval(), optimizer=None,
            extra=None, schedule=lr_schedule(0.05, 2, 2, cosine=True))
        state.optimizer = make_sgd(state.trainable_params(), 0.9, 5e-4)
        _, m = make_distill_train_step(td, None)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(7))
        got[quant] = {k: float(m[k]) for k in LOSSES}
    _check_losses(got, want, ("loss", "loss_cls", "loss_div"))


def test_teacher_quant_refusals_carry_the_jax_messages():
    from moma_tpu.core.config import Config as JConfig

    for quant, fused in (("int8", "on"), ("int4", "off")):
        _refusal_case(quant, fused)
    assert JConfig().moma.teacher_quant == "none"


def _refusal_case(quant, fused):
    from moma_tpu.train.moma import _teacher_apply

    from moma_tpu_torch.train.moma import make_moma_train_step

    jc, tc = _moma_cfgs(quant)
    jc.moma.fused_teacher = tc.moma.fused_teacher = fused

    class _T:
        apply = staticmethod(lambda *a, **k: None)

    with pytest.raises(ValueError) as want:
        _teacher_apply(jc, _T)
    with pytest.raises(ValueError) as got:
        make_moma_train_step(tc, None, kl_train_bn_override=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        Q.teacher_apply_for(_forward, quant, fused == "on")
    assert str(got.value) == str(want.value)
