"""Shared helpers for the moma_tpu_torch parity tests (tests/test_torch_port_*).

Weights cross between the packages through moma_tpu.models.torch_import,
which aligns the two parameter trees in call order; that needs the flax
variables in the insertion order `init` creates them.  `jax.jit(init)`
returns them with sorted keys, so `make_init_ordered` records the order while
tracing and rebuilds it, at the cost of one jit compile instead of a
slow eager init.

`make_init_ordered` and `quick_jit` compile with the CPU backend's LLVM
optimisation off (QUICK_COMPILE): the same XLA program, compiled in a
fraction of the time (effiB0's init: 6.5 s -> 1.3 s), its values within
float32 rounding of the optimised build's; for references computed once or
twice.  (A train step that runs several times gains nothing from it: 5.5 s
-> 4.6 s to compile, 0.64 s -> 1.45 s a run.)
"""

from __future__ import annotations

from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch


def ordered_numpy(tree):
    """Order-preserving deep copy of a nested dict into numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: ordered_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _skeleton(tree):
    if isinstance(tree, Mapping):
        return [(k, _skeleton(v)) for k, v in tree.items()]
    return None


def _rebuild(skel, values):
    if skel is None:
        return np.asarray(values)
    return {k: _rebuild(s, values[k]) for k, s in skel}


QUICK_COMPILE = {"xla_backend_optimization_level": 0}


def quick_compiled(jitted):
    """`jitted` (a jax.jit function) compiled on its first call with
    QUICK_COMPILE, for calls with the first call's shapes and static
    arguments."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options=QUICK_COMPILE))
        return compiled[0](*args)

    return call


def quick_jit(fn):
    """jax.jit(fn) compiled with QUICK_COMPILE on its first call: for a
    reference computed once, where compile time is most of the cost."""
    return quick_compiled(jax.jit(fn))


_INITS = {}


def make_init_ordered(model, sample_shape, dtype=np.float32):
    """Returns init(key) -> flax variables as insertion-ordered numpy
    dicts, jit-compiled once per process for `model` (flax modules compare
    by their fields) at `sample_shape`: the parity files share effiB0's."""
    key = (model, tuple(sample_shape), np.dtype(dtype).name)
    if key not in _INITS:
        _INITS[key] = _make_init_ordered(model, sample_shape, dtype)
    return _INITS[key]


def _make_init_ordered(model, sample_shape, dtype):
    order = {}
    sample = np.zeros(sample_shape, dtype)

    def f(key):
        v = model.init(key, sample, train=False)
        order["skel"] = _skeleton(v)
        return v

    jf = quick_compiled(jax.jit(f))

    def init(key):
        v = jf(key)
        return _rebuild(order["skel"], jax.device_get(v))

    return init


def jax_template(model, sample_shape, dtype=np.float32):
    """Zeros shaped like `model.init`'s variables, insertion-ordered, from
    an abstract trace (jax.eval_shape: nothing is compiled or run).  With
    moma_tpu_torch.interop.jax_variables it gives a JAX tree holding a port
    module's own initial weights, at a fraction of a compiled init's cost
    (effiB1: 2.9 s against 7.9 s)."""
    order = {}
    sample = np.zeros(sample_shape, dtype)

    def f(key):
        v = model.init(key, sample, train=False)
        order["skel"] = _skeleton(v)
        return v

    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    return _rebuild(order["skel"], jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))


def assert_close_scaled(got, want, rtol, what="", floor=0.0):
    """|got - want| <= rtol * (|want| + max(max|want|, floor)): relative
    error with a floor at the tensor's own scale, so entries near zero are
    held to the tolerance of the tensor rather than to their own tiny
    size.  `floor` covers tensors whose true value is zero (e.g. a BN bias
    feeding the next train-mode BN gets a zero gradient), where both sides
    hold only float noise: pass a small fraction of the enclosing group's
    scale (group_floor)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max() if want.size else 0.0, floor)
    err = np.abs(got - want)
    lim = rtol * (np.abs(want) + scale) + 1e-30
    worst = float((err / lim).max()) if want.size else 0.0
    assert worst <= 1.0, (
        f"{what}: max |diff| {err.max():.3e} exceeds rtol {rtol} "
        f"(scale {scale:.3e}, worst ratio {worst:.2f})")


def group_floor(tree, frac=1e-3):
    """frac * the largest magnitude over every leaf of a nested dict."""
    if isinstance(tree, Mapping):
        return max((group_floor(v, frac) for v in tree.values()), default=0.0)
    a = np.asarray(tree)
    return frac * float(np.abs(a).max()) if a.size else 0.0


def walk_pairs(got, want, prefix=""):
    """Yield (path, got_leaf, want_leaf) over the keys of `want`."""
    if isinstance(want, Mapping):
        for k in want:
            yield from walk_pairs(got[k], want[k], f"{prefix}/{k}")
    else:
        yield prefix, got, want


@pytest.fixture
def one_torch_thread():
    """Run a test on one PyTorch intra-op thread.  The suite runs in several
    worker processes at once; at these sizes one thread is about as fast as
    all of them (the CPU CLI run of test_torch_port_cli: 24 s on one thread,
    20 s on eight) and does not oversubscribe the cores, where spinning
    OpenMP threads slow every worker down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
