"""Post-training int8 quantization: calibrated, dynamic and weights-only.

Counterpart of moma_tpu/core/quantize.py, with its names.  Where flax's
`nn.intercept_methods` hooks every `nn.Conv` / `nn.Dense` call, the port
gives the chosen modules of a model another forward for the length of a
call (`intercept`: an instance `forward` over the class's, removed on
exit), keyed by their `named_modules()` name:

  * a flax `nn.Conv` is a `models.common.Conv2d` (the ViT patch embedding
    too); a flax `nn.Dense` is a `models.vit.Dense` or a
    `models.common.Dense` (the VGG / MobileNetV2 classifier).  The class
    decides, not isinstance: `common.Dense` subclasses `TorchLinear`, which
    flax never intercepts (a raw matmul there), and neither is what does
    not go through a Conv2d's forward (EfficientNet's `stem_s2d_conv`, as
    JAX's `_StemConv`; the MoE's expert products).
  * `_supported` as JAX's (:85-94): a conv takes a 4-D input (the port's
    convolutions have SAME or explicit padding and no input dilation), a
    dense an input of 2 or more dims.

The int8 layer (`_quantized_conv`, `_quantized_dense`) is
    q_x = clip(round(x / s_x), -127, 127)      int8, per tensor
    q_w = clip(round(w / s_w[o]), -127, 127)   int8, per output channel
    out = f32(conv(q_x, q_w) in int32) * (s_x * s_w) (+ bias), as the
          layer's dtype (its flax dtype, else the promotion of x and w)
through the hand-written kernels of ops/int8_conv.py on a CUDA tensor.
s_w = max(max|w|, 1e-8) / 127 over all but the output axis, from the f32
weight at every call (the EMA teacher's weights change every step).  A
calibrated s_x is max(amax, 1e-6) / 127 in float64 (:186-191), rounded to
f32 once at use; a dynamic one the f32 quotient of this tensor's absmax
(:283): the two can differ in the last bit.

The modes: `calibrate` + `quantized_apply` (`quantize_for_serving`,
`export_model --int8`), `quantized_apply_dynamic` (`--int8_dynamic` and
the training side's `--teacher_quant int8`, through `teacher_apply_for`;
convolutions only, never dense, as :297), and weights-only
(`quantize_weights`, `weight_only_apply`, `weight_only_for_serving`,
`--int8_weights`): the int8 weight dequantized in f32, cast to the compute
dtype, then the ordinary convolution or matmul (:384-418).

An "apply" here is `forward(model, *args, **kwargs)`, the port's
counterpart of flax's `apply_fn(variables, *args, **kwargs)`.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from moma_tpu_torch.ops.int8_conv import (QMAX, _qmax, int8_conv2d,
                                          int8_quantize)


@functools.lru_cache(maxsize=None)
def _layer_classes():
    from moma_tpu_torch.models import common, vit

    return (common.Conv2d,), (vit.Dense, common.Dense)


def _layer_kind(mod: nn.Module) -> Optional[str]:
    """'conv' / 'dense' for a module that stands for a flax nn.Conv /
    nn.Dense, by its class; else None."""
    convs, denses = _layer_classes()
    t = type(mod)
    if t in convs:
        return "conv"
    if t in denses:
        return "dense"
    return None


def _supported(kind: str, x) -> bool:
    if not isinstance(x, Tensor):
        return False
    return x.ndim == 4 if kind == "conv" else x.ndim >= 2


@contextlib.contextmanager
def intercept(model: nn.Module, interceptor: Callable):
    """Within the context every conv / dense module `m` of `model` named
    `name` runs `interceptor(next_fun, name, kind, m, args, kwargs)` in
    place of its forward (`next_fun`, the forward it had); a call without
    positional arguments goes to next_fun untouched.  On exit each module
    gets back the forward it had."""
    saved = []
    try:
        for name, mod in model.named_modules():
            kind = _layer_kind(mod)
            if kind is None:
                continue

            def call(*args, _nxt=mod.forward, _name=name, _kind=kind,
                     _mod=mod, **kwargs):
                if not args:
                    return _nxt(*args, **kwargs)
                return interceptor(_nxt, _name, _kind, _mod, args, kwargs)

            saved.append((mod, mod.__dict__.get("forward")))
            mod.forward = call
        yield
    finally:
        for mod, prev in reversed(saved):
            if prev is None:
                del mod.forward
            else:
                mod.forward = prev


def _kernel_int8(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-output-channel int8 weight quantization (:194-203) of an
    (out, ...) weight: (q_w int8, s_w f32 (out,))."""
    w = w.detach().float()
    s_w = torch.div(w.abs().amax(dim=tuple(range(1, w.ndim))).clamp_min(1e-8),
                    _qmax(w))
    q_w = torch.round(w / s_w.view(-1, *([1] * (w.ndim - 1)))).clamp(
        -QMAX, QMAX).to(torch.int8)
    return q_w, s_w


def _out_dtype(mod: nn.Module, x: Tensor, kernel_dtype=None) -> torch.dtype:
    """flax's `mod.dtype or promote_types(x.dtype, kernel.dtype)`."""
    dt = getattr(mod, "dtype", None)
    if dt is not None:
        return dt
    return torch.promote_types(
        x.dtype, kernel_dtype if kernel_dtype is not None else mod.weight.dtype)


def _pads(mod: nn.Module, x: Tensor) -> List[int]:
    """(top, bottom, left, right) of a Conv2d on x: TF 'SAME' when its
    padding is None, else its symmetric int padding."""
    from moma_tpu_torch.models.common import tf_same_pads

    if mod.padding is not None:
        return [mod.padding] * 4
    k = mod.kernel_size
    return [*tf_same_pads(x.shape[2], k, mod.stride),
            *tf_same_pads(x.shape[3], k, mod.stride)]


def _scale_tensor(s, x: Tensor) -> Optional[Tensor]:
    """A calibrated scale as the f32 tensor the kernels read, on x's device
    (None: dynamic)."""
    if s is None or isinstance(s, Tensor):
        return s
    return torch.full((), float(s), dtype=torch.float32, device=x.device)


def _quantized_conv(mod: nn.Module, x: Tensor, s_x) -> Tensor:
    """The int8 convolution of a Conv2d (:206-228); s_x a calibrated scale,
    or None for this tensor's own (dynamic, :279-284)."""
    q_w, s_w = _kernel_int8(mod.weight)
    q_x, s = int8_quantize(x, _scale_tensor(s_x, x))
    bias = None if mod.bias is None else mod.bias.detach().float()
    return int8_conv2d(q_x, q_w, s, s_w, bias, [mod.stride] * 2,
                       _pads(mod, x), [1, 1], mod.groups, _out_dtype(mod, x))


def _quantized_dense(mod: nn.Module, x: Tensor, s_x) -> Tensor:
    """The int8 matmul of a dense layer (:231-249): the 1x1 convolution of
    the flattened leading dims."""
    q_w, s_w = _kernel_int8(mod.weight)            # (out, in)
    q_x, s = int8_quantize(x, _scale_tensor(s_x, x))
    D, O = x.shape[-1], q_w.shape[0]
    bias = None if mod.bias is None else mod.bias.detach().float()
    y = int8_conv2d(q_x.reshape(-1, D, 1, 1), q_w[:, :, None, None], s, s_w,
                    bias, [1, 1], [0, 0, 0, 0], [1, 1], 1,
                    _out_dtype(mod, x))
    return y.reshape(*x.shape[:-1], O)


def _logits_dense_key(order: list, dense: bool, n_cls: Optional[int]):
    """The layer the final-logits exclusion rule keeps fp (:139-148): the
    LAST intercepted call is a dense and (when n_cls is given) its width
    is n_cls; every call of that module stays fp."""
    if dense and order:
        last_key, last_kind, last_feat = order[-1]
        if last_kind == "dense" and (n_cls is None or last_feat == n_cls):
            return last_key
    return None


def _recorder(stats: Dict[str, Tensor], order: list, dense: bool):
    """The calibration interceptor (:111-136): running absmax of every
    supported conv (and with `dense` dense) input into `stats`, the calls'
    (name, kind, out_features) into `order`."""

    def icpt(nxt, name, kind, mod, args, kwargs):
        x = args[0]
        if (kind == "conv" or dense) and _supported(kind, x):
            amax = x.detach().float().abs().amax()
            stats[name] = (torch.maximum(stats[name], amax) if name in stats
                           else amax)
            order.append((name, kind, mod.weight.shape[0]
                          if kind == "dense" else None))
        return nxt(*args, **kwargs)

    return icpt


def calibrate(forward: Callable, model: nn.Module, batches: Iterable[Tensor],
              dense: bool = False, n_cls: Optional[int] = None,
              **kwargs) -> Dict[str, float]:
    """Run `forward(model, x, **kwargs)` over `batches`, return {module
    name: activation scale}, absmax / 127 over all batches (per tensor,
    symmetric); dense=True also calibrates the dense layers except a
    final-logits dense (see _logits_dense_key).  The forward runs as the
    model is (put it in eval mode first), without gradients."""
    order: list = []
    amax: Dict[str, float] = {}
    with torch.no_grad():
        for x in batches:
            order.clear()   # one forward's order, as the JAX trace keeps
            stats: Dict[str, Tensor] = {}
            with intercept(model, _recorder(stats, order, dense)):
                forward(model, x, **kwargs)
            if stats:
                vals = torch.stack(list(stats.values())).tolist()
                for k, v in zip(stats, vals):
                    amax[k] = max(amax.get(k, 0.0), float(v))
    excl = _logits_dense_key(order, dense, n_cls)
    amax.pop(excl, None)
    return {k: max(v, 1e-6) / QMAX for k, v in amax.items()}


def _intercepted(forward: Callable, interceptor: Callable) -> Callable:
    """forward(model, ...) run within intercept(model, interceptor)."""

    def wrapped(model, *args, **kwargs):
        with intercept(model, interceptor):
            return forward(model, *args, **kwargs)

    return wrapped


def quantized_apply(forward: Callable, act_scales: Dict[str, float]
                    ) -> Callable:
    """forward with every conv / dense whose name is in `act_scales` run in
    int8 at that activation scale; same signature as forward."""

    def icpt(nxt, name, kind, mod, args, kwargs):
        x = args[0]
        if name in act_scales and _supported(kind, x):
            fn = _quantized_conv if kind == "conv" else _quantized_dense
            return fn(mod, x, act_scales[name])
        return nxt(*args, **kwargs)

    return _intercepted(forward, icpt)


def quantized_apply_dynamic(forward: Callable) -> Callable:
    """forward with EVERY supported conv in int8 at its input's own scale
    (no calibration; per-channel weight scales from the live weights at
    every call, so usable in a training step whose teacher changes).  Dense
    layers stay fp (:297)."""

    def icpt(nxt, name, kind, mod, args, kwargs):
        x = args[0]
        if kind == "conv" and _supported(kind, x):
            return _quantized_conv(mod, x, None)
        return nxt(*args, **kwargs)

    return _intercepted(forward, icpt)


def quantize_for_serving(forward: Callable, model: nn.Module,
                         calib_batches: Sequence[Tensor], dense: bool = False,
                         n_cls: Optional[int] = None, **kwargs):
    """Calibrate, then wrap: (quantized forward, act_scales)."""
    scales = calibrate(forward, model, calib_batches, dense=dense,
                       n_cls=n_cls, **kwargs)
    return quantized_apply(forward, scales), scales


def collect_quantizable(forward: Callable, model: nn.Module, sample: Tensor,
                        dense: bool = False, n_cls: Optional[int] = None,
                        **kwargs) -> List[Tuple[str, str]]:
    """[(module name, kind)] of the quantizable layers of one forward, in
    call order, without the final-logits dense.  Where JAX traces
    (eval_shape), the port runs the forward on `sample` without gradients
    (in the model's mode: eval for serving)."""
    order: list = []
    with torch.no_grad(), intercept(model, _recorder({}, order, dense)):
        forward(model, sample, **kwargs)
    excl = _logits_dense_key(order, dense, n_cls)
    seen, layers = set(), []
    for key, kind, _ in order:
        if key != excl and key not in seen:
            seen.add(key)
            layers.append((key, kind))
    return layers


def quantize_weights(model: nn.Module, layers: Sequence
                     ) -> Dict[str, Tuple[Tensor, Tensor]]:
    """{name: (q_w int8, s_w f32)} of the named layers' weights (:368-381)."""
    return {name: _kernel_int8(model.get_submodule(name).weight)
            for name, _ in layers}


def _fp_conv(mod: nn.Module, x: Tensor, w: Tensor) -> Tensor:
    """A Conv2d's convolution of x with weight w, no bias."""
    p = _pads(mod, x)
    if p[0] == p[1] and p[2] == p[3]:
        return F.conv2d(x, w, None, mod.stride, (p[0], p[2]), 1, mod.groups)
    return F.conv2d(F.pad(x, (p[2], p[3], p[0], p[1])), w, None, mod.stride,
                    0, 1, mod.groups)


def _weight_only_call(mod: nn.Module, x: Tensor, kind: str, q: Tensor,
                      s: Tensor, kernel_dtype=None) -> Tensor:
    """A conv / dense with its int8 weight dequantized in f32, then cast
    to the compute dtype (:384-418; casting the scale first would bias
    every weight of a channel alike); the bias is added after, in the
    compute dtype."""
    cdt = x.dtype if x.is_floating_point() else torch.float32
    w = (q.float() * s.view(-1, *([1] * (q.ndim - 1)))).to(cdt)
    xc = x.to(cdt)
    if kind == "conv":
        y = _fp_conv(mod, xc, w)
        if mod.bias is not None:
            y = y + mod.bias.to(cdt).view(1, -1, 1, 1)
    else:
        y = F.linear(xc, w)
        if mod.bias is not None:
            y = y + mod.bias.to(cdt)
    return y.to(_out_dtype(mod, x, kernel_dtype))


def weight_only_apply(forward: Callable,
                      qw: Dict[str, Tuple[Tensor, Tensor]]) -> Callable:
    """forward with every layer in `qw` run from its int8 weight
    (activations and sums untouched)."""

    def icpt(nxt, name, kind, mod, args, kwargs):
        x = args[0]
        if name in qw and _supported(kind, x):
            return _weight_only_call(mod, x, kind, *qw[name])
        return nxt(*args, **kwargs)

    return _intercepted(forward, icpt)


class WeightOnlyLayer(nn.Module):
    """A conv or dense layer that owns its int8 weight `q` and per-output
    scales `s` as buffers, and its bias, but no float weight: the stand-in
    a weights-only module copy holds (the serving artifact stores the int8
    kernels only)."""

    def __init__(self, mod: nn.Module, kind: str, q: Tensor, s: Tensor):
        super().__init__()
        self.kind = kind
        self.kernel_dtype = mod.weight.dtype
        self.dtype = getattr(mod, "dtype", None)
        if kind == "conv":
            self.stride, self.padding = mod.stride, mod.padding
            self.groups, self.kernel_size = mod.groups, mod.kernel_size
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("bias", None if mod.bias is None
                             else mod.bias.detach().clone())

    def forward(self, x: Tensor) -> Tensor:
        return _weight_only_call(self, x, self.kind, self.q, self.s,
                                 self.kernel_dtype)


def weight_only_for_serving(forward: Callable, model: nn.Module,
                            sample: Tensor, dense: bool = True,
                            n_cls: Optional[int] = None, **kwargs):
    """Weights-only int8 in one call: enumerate the layers, quantize their
    weights, and return (a copy of `model` whose quantized layers are
    WeightOnlyLayers, the number of them).  `forward(copy, x)` is the
    weights-only forward; the copy holds no float weight of those layers."""
    layers = collect_quantizable(forward, model, sample, dense=dense,
                                 n_cls=n_cls, **kwargs)
    qw = quantize_weights(model, layers)
    qmodel = copy.deepcopy(model)
    for (name, kind), (q, s) in zip(layers, qw.values()):
        parent, _, child = name.rpartition(".")
        holder = qmodel.get_submodule(parent)
        setattr(holder, child, WeightOnlyLayer(holder.get_submodule(child),
                                               kind, q, s))
    return qmodel, len(qw)


class Quantized(nn.Module):
    """`model` run through a quantized apply: forward(*args) =
    apply(model, *args).  The serving export takes it as its model."""

    def __init__(self, model: nn.Module, apply: Callable):
        super().__init__()
        self.model = model
        self.quantized_forward = apply

    def forward(self, *args, **kwargs):
        return self.quantized_forward(self.model, *args, **kwargs)


def teacher_apply_for(teacher_apply: Callable, teacher_quant: str,
                      fused_conflict: bool = False) -> Callable:
    """The training steps' teacher forward, honoring --teacher_quant: 'int8'
    runs every (gradient-free) teacher forward with dynamic-int8 convs.
    `fused_conflict`: the fused teacher forward is on, which bypasses the
    convolutions' interception (:464-483)."""
    if teacher_quant == "none":
        return teacher_apply
    if teacher_quant != "int8":
        raise ValueError(f"unknown teacher_quant {teacher_quant!r}")
    if fused_conflict:
        raise ValueError("teacher_quant bypassed by fused_teacher "
                         "(the Pallas path does not intercept convs); "
                         "enable only one")
    return quantized_apply_dynamic(teacher_apply)
