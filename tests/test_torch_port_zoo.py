"""The backbone zoo: moma_tpu_torch.models against moma_tpu.models on the
CPU.

- The registry: the port's `available_models()` is moma_tpu's, the two
  Mixture-of-Experts ViTs included (their shapes are checked in the
  registry's test, with the map of moma_tpu_torch.interop.vit_name_map,
  so that the collected count stays put).
- Every registered name (and the CIFAR ResNet's Bottleneck variant): the
  port module, built on the meta device, has the parameter and
  BN-statistic shapes and count of `jax.eval_shape(model.init, ...)`, and
  its tensors align with the JAX tree stream by stream (conv / bn / linear
  in call order, moma_tpu_torch.models.torch_import) — nothing is
  compiled.
- One name per family (resnet8, wrn_16_2, resnet8x4, vgg8, MobileNetV2,
  ShuffleV1, ShuffleV2 at 32^2; ResNet18, ResNet50, resnext50_32x4d,
  MobileNetV2_Imagenet, ShuffleV2_Imagenet at 64^2), batch 2, float32:
  the port's own initial weights with seeded BN parameters, running
  statistics and biases, carried to JAX (moma_tpu_torch.interop); every
  feature and the logits of an eval-mode forward within 1e-4 of each
  tensor's scale (torch_port_helpers.assert_close_scaled); every feature,
  the logits and the updated BN running statistics of a train-mode
  forward within 1e-4 of scale too, or, where float32 itself is coarser,
  within 8 times the port's own float32 error on that tensor (its
  distance to the same forward in float64).  Train-mode BatchNorm over
  the 8 values a channel of a batch-2 2x2 map holds amplifies rounding:
  the port's float32 error reaches 3e-4 of scale at ResNet50's last stage,
  JAX's (against the same float64 run) 1e-3, 1-6 times the port's on
  every tensor.  Every BatchNorm input of the port's train forward is
  channels_last, so FusedBatchNorm copies none.
- The mean cross-entropy's parameter gradients of a train-mode forward
  for resnet8 and ResNet18: within 1e-3 of each tensor's scale, floored
  at 1e-3 of the group's largest (they chain through every BN backward,
  as tests/test_torch_port_effnet.py holds effiB0's).  A ReLU input
  within float32 rounding of 0 takes opposite sides in the two packages
  and moves every gradient before it by percents, so the test asserts
  that no ReLU input of its batch lies within 5e-6 of the kink, five
  times the measured gap between the two packages' forwards.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import moma_tpu.models as JMODELS
from moma_tpu.models.resnet_cifar import ResNetCifar as JResNetCifar
from moma_tpu_torch import models as TMODELS
from moma_tpu_torch.interop import jax_variables
from moma_tpu_torch.models.resnet_cifar import ResNetCifar
from moma_tpu_torch.models.torch_import import convert_state_dict
from moma_tpu_torch.ops.fused_bn import FusedBatchNorm

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (ReluInputs, assert_close_scaled, copied,
                                group_floor, jax_template, quick_jit,
                                walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_CLS, B = 10, 2
MOE = {"vit_tiny_moe_patch16_224", "vit_small_moe_patch16_224"}
FAMILIES = [("resnet8", 32), ("wrn_16_2", 32), ("resnet8x4", 32),
            ("vgg8", 32), ("MobileNetV2", 32), ("ShuffleV1", 32),
            ("ShuffleV2", 32), ("ResNet18", 64), ("ResNet50", 64),
            ("resnext50_32x4d", 64), ("MobileNetV2_Imagenet", 64),
            ("ShuffleV2_Imagenet", 64)]


def test_registry_is_jax_without_the_moe_vits():
    """The registry equals JAX's: the MoE ViTs are ported ([5b-teachers]
    (a)); like the ViTs they need `image_size`, and their parameter shapes
    are JAX's."""
    assert TMODELS.available_models() == sorted(JMODELS.available_models())
    assert MOE <= set(TMODELS.available_models())
    for name in sorted(MOE):
        with pytest.raises(ValueError, match="needs image_size"):
            TMODELS.create_model(name, N_CLS)
        _check_shapes(name)
    with pytest.raises(KeyError):
        TMODELS.create_model("resnet9", N_CLS)


def _shapes_case(name):
    """(JAX module, port module on the meta device, init input size)."""
    size = 224 if name.startswith(("vit", "deit")) else 32
    with torch.device("meta"):
        if name == "bottleneck":
            return (JResNetCifar(11, (16, 16, 32, 64), "bottleneck", N_CLS),
                    ResNetCifar(11, (16, 16, 32, 64), "bottleneck", N_CLS),
                    size)
        return (JMODELS.create_model(name, N_CLS),
                TMODELS.create_model(name, N_CLS, image_size=size), size)


@pytest.mark.parametrize(
    "name", sorted(set(JMODELS.available_models()) - MOE) + ["bottleneck"])
def test_parameter_shapes_match_jax(name):
    _check_shapes(name)


def _check_shapes(name):
    jm, tm, size = _shapes_case(name)
    template = jax_template(jm, (1, size, size, 3))
    if name.startswith(("vit", "deit")):
        # ViTs cross by their explicit name map (interop.vit_name_map)
        got = jax_variables(tm.to_empty(device="cpu"), template)
    else:
        # zero-size stand-ins for the port's tensors (no memory): the
        # converter checks every shape as it aligns the streams
        got = convert_state_dict(
            {k: np.broadcast_to(np.zeros((), np.float32), v.shape)
             for k, v in tm.state_dict().items()}, template)
    counts = {"/params": 0, "/batch_stats": 0}
    for path, g, w in walk_pairs(got, template):
        assert np.shape(g) == np.shape(w), path
        counts["/" + path.split("/")[1]] += int(np.prod(np.shape(w)))
    assert counts["/params"] == sum(p.numel() for p in tm.parameters())
    assert counts["/batch_stats"] == sum(
        b.numel() for n, b in tm.named_buffers()
        if n.endswith(("running_mean", "running_var")))


def _seeded(model, seed):
    """The port model with seeded BN scales, biases and running
    statistics and seeded biases, so that neither mode sees an identity
    BN or a zero bias."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.ndim == 1 and name.endswith("weight"):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
    return model


def _pair(name, size, seed=2):
    jm = JMODELS.create_model(name, N_CLS)
    tm = _seeded(TMODELS.create_model(
        name, N_CLS, generator=torch.Generator().manual_seed(0)), 1)
    # own copies of the weights, in the template's (call) order
    v = copied(jax_variables(tm, jax_template(jm, (1, size, size, 3))))
    x = np.random.RandomState(seed).randn(B, size, size, 3).astype(
        np.float32)
    return jm, v, tm, x


def _scaled_err(got, want):
    """assert_close_scaled's measure: max |got - want| / (|want| +
    max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (np.abs(want) + np.abs(want).max())
                  + 1e-300).max())


def _float64_train_forward(tm, x):
    """A float64 copy of the port model's train-mode forward (the BN
    plain versions keep float64): (feats, logits, the copy)."""
    m64 = copy.deepcopy(tm).double().train()
    with torch.no_grad():
        feats, logits = m64(torch.from_numpy(x).double())
    assert feats[0].dtype == torch.float64
    return feats, logits, m64


@pytest.mark.parametrize("name,size", FAMILIES,
                         ids=[n for n, _ in FAMILIES])
def test_forward_matches_jax_in_both_modes(name, size):
    jm, v, tm, x = _pair(name, size)

    def both(v, x):
        (ft, lt), upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        fe, le = jm.apply(v, x, train=False)
        return ft, lt, upd["batch_stats"], fe, le

    jft, jlt, jbs, jfe, jle = jax.device_get(quick_jit(both)(v, x))
    f64, l64, m64 = _float64_train_forward(tm, x)

    layouts = []
    for mod in tm.modules():
        if isinstance(mod, FusedBatchNorm):
            mod.register_forward_pre_hook(lambda m, a: layouts.append(
                a[0].ndim == 2 or a[0].is_contiguous(
                    memory_format=torch.channels_last)))
    tm = tm.to(memory_format=torch.channels_last)
    with torch.no_grad():
        tm.eval()
        tfe, tle = tm(torch.from_numpy(x))
        tm.train()
        tft, tlt = tm(torch.from_numpy(x))
    assert layouts and all(layouts), "a BatchNorm input is not channels_last"
    assert len(tft) == len(jft) == len(tfe) == len(f64)
    for i, (a, b) in enumerate(zip(tfe, jfe)):
        assert_close_scaled(a.numpy(), b, 1e-4, f"eval feat {i}")
    assert_close_scaled(tle.numpy(), jle, 1e-4, "eval logits")

    def train_rtol(got, f64):
        return max(1e-4, 8 * _scaled_err(got, f64))

    for i, (a, b, c) in enumerate(zip(tft, jft, f64)):
        assert_close_scaled(a.numpy(), b, train_rtol(a.numpy(), c.numpy()),
                            f"train feat {i}")
    assert tlt.dtype == tle.dtype == torch.float32
    assert_close_scaled(tlt.numpy(), jlt, train_rtol(tlt.numpy(),
                                                     l64.numpy()),
                        "train logits")
    stats = jax_variables(tm, v)["batch_stats"]
    stats64 = jax_variables(m64, v)["batch_stats"]
    for (path, g, w), (_, _, c) in zip(walk_pairs(stats, jbs, "stats"),
                                       walk_pairs(stats64, jbs)):
        assert_close_scaled(g, w, train_rtol(g, c), path)


@pytest.mark.parametrize("name,size", [("resnet8", 32), ("ResNet18", 64)])
def test_cross_entropy_gradients_match_jax(name, size):
    jm, v, tm, x = _pair(name, size, seed=8)
    labels = np.random.RandomState(3).randint(0, N_CLS, (B,))

    def loss(params):
        (_, logits), _ = jm.apply({**v, "params": params}, x, train=True,
                                  mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, labels[:, None], 1).mean()

    jl, jg = jax.device_get(quick_jit(jax.value_and_grad(loss))(v["params"]))

    tm.train()
    with ReluInputs() as kinks:
        _, logits = tm(torch.from_numpy(x))
    assert kinks.low > 5e-6, kinks.low
    tl = F.cross_entropy(logits, torch.from_numpy(labels).long())
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tm.named_parameters()}
    state = {k: (grads[k] if k in grads else t).detach().numpy()
             for k, t in tm.state_dict().items()}
    got = convert_state_dict(state, v)["params"]
    floor = group_floor(jg)
    for path, g, w in walk_pairs(got, jg, "grad"):
        assert_close_scaled(g, w, 1e-3, path, floor)
