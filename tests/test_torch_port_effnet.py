"""moma_tpu_torch EfficientNet-B0 on the CPU against moma_tpu's.

effiB0 at 64^2, batch 4, float32; the JAX variables from `init` are
carried into the port by moma_tpu_torch.interop.  Compared: the six
feature maps (NHWC), the logits, every parameter gradient of a fixed
scalar loss, and the BN running statistics after a train-mode forward;
plus the eval-mode (running statistics) forward.  Tolerance: relative
error with a floor at each tensor's scale, itself floored at 1e-3 of the
largest value of its group (torch_port_helpers.assert_close_scaled) —
1e-4 for features, logits and statistics, 1e-3 for gradients, which
chain through 49 BatchNorm backward passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moma_tpu.models.efficientnet import efficientnet_b0
from moma_tpu.models.torch_import import convert_state_dict
from moma_tpu_torch.interop import jax_variables, load_jax_variables
from moma_tpu_torch.models.efficientnet import EfficientNet

from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_port_helpers import (assert_close_scaled, group_floor,
                                make_init_ordered, quick_jit, walk_pairs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HW, N_CLS = 4, 64, 4


@pytest.fixture(scope="module")
def pair():
    jm = efficientnet_b0(num_classes=N_CLS)
    v = make_init_ordered(jm, (2, HW, HW, 3))(jax.random.PRNGKey(0))
    # non-trivial running statistics so the eval forward tests them
    rs = np.random.RandomState(1)

    def perturb(node):
        if "mean" in node:
            node["mean"] = (0.1 * rs.randn(*node["mean"].shape)).astype(
                np.float32)
            node["var"] = (0.5 + rs.rand(*node["var"].shape)).astype(
                np.float32)
        else:
            for child in node.values():
                perturb(child)

    perturb(v["batch_stats"])
    tm = EfficientNet("b0", num_classes=N_CLS)
    load_jax_variables(tm, v)
    x = np.random.RandomState(2).randn(B, HW, HW, 3).astype(np.float32)
    w = np.random.RandomState(3).randn(B, N_CLS).astype(np.float32)
    return jm, v, tm, x, w


def test_feature_contract(pair):
    _, _, tm, x, _ = pair
    tm.eval()
    with torch.no_grad():
        feats, logits = tm(torch.from_numpy(x))
    assert [tuple(f.shape) for f in feats] == [
        (B, 32, 32, 16), (B, 16, 16, 24), (B, 8, 8, 40), (B, 4, 4, 112),
        (B, 2, 2, 1280), (B, 1280)]
    assert tuple(logits.shape) == (B, N_CLS)
    assert tm.feat_dim == 1280


def test_eval_forward_matches_jax(pair):
    jm, v, tm, x, _ = pair
    jf, jl = quick_jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        tf, tl = tm(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert_close_scaled(a.numpy(), np.asarray(b), 1e-4, f"feat {i}")
    assert_close_scaled(tl.numpy(), np.asarray(jl), 1e-4, "logits")


def test_train_forward_backward_stats_match_jax(pair):
    jm, v, tm, x, w = pair

    def loss(params, x):
        (feats, logits), mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return (jnp.sum(logits * w) + jnp.sum(feats[-1]) * 1e-2,
                (feats, logits, mut["batch_stats"]))

    (_, (jf, jl, jbs)), jg = quick_jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"], jnp.asarray(x))

    load_jax_variables(tm, v)  # fresh running statistics
    tm.train()
    tm.zero_grad(set_to_none=True)
    tf, tl = tm(torch.from_numpy(x))
    ((tl * torch.from_numpy(w)).sum() + tf[-1].sum() * 1e-2).backward()

    for i, (a, b) in enumerate(zip(tf, jf)):
        assert_close_scaled(a.detach().numpy(), np.asarray(b), 1e-4,
                            f"feat {i}")
    assert_close_scaled(tl.detach().numpy(), np.asarray(jl), 1e-4, "logits")

    got = jax_variables(tm, v)
    jbs = jax.device_get(jbs)
    floor = group_floor(jbs)
    for path, a, b in walk_pairs(got["batch_stats"], jbs, "bs"):
        assert_close_scaled(a, b, 1e-4, path, floor)

    # parameter gradients, mapped to the flax layout by the same converter
    grad_sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in tm.named_parameters()}
    sd = {k: grad_sd.get(k, t).detach().numpy()
          for k, t in tm.state_dict().items()}
    got_g = convert_state_dict(sd, v)["params"]
    jg = jax.device_get(jg)
    floor = group_floor(jg)
    for path, a, b in walk_pairs(got_g, jg, "grad"):
        assert_close_scaled(a, b, 1e-3, path, floor)
