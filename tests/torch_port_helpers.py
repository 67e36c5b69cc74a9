"""Shared helpers for the moma_tpu_torch parity tests (tests/test_torch_port_*).

Weights cross between the packages through moma_tpu.models.torch_import,
which aligns the two parameter trees in call order; that needs the flax
variables in the insertion order `init` creates them.  `jax.jit(init)`
returns them with sorted keys, so `make_init_ordered` records the order while
tracing and rebuilds it, at the cost of one jit compile instead of a
slow eager init.

Under pytest-xdist the workers of one run share `make_init_ordered`'s
results: the first worker to need an init computes it and leaves it,
pickled, in a directory of the run under the temporary directory, with
the inits of COMMON_INIT_KEYS from the program it compiled; the others
load them (an effiB0 init compiles in 5-10 s, and every worker used to
compile its own).

`make_init_ordered` and `quick_jit` compile with the CPU backend's LLVM
optimisation off and LLVM's expensive passes skipped (QUICK_COMPILE): the
same XLA program, compiled in a fraction of the time (effiB0's init: 6.5 s
-> 1.3 s), its values within float32 rounding of the optimised build's;
for references computed once or twice.  An effiB0 MoMA train step at 64^2
(MoCoAtt 'all'): 9.8 s to compile and 1.0 s a run optimised, 6.8 s and
2.1 s quick (7.9 s and 2.7 s with the optimisation off alone), so a step
run up to 3 times gains from it too.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


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


QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


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
# the PRNGKeys of the inits in the parity files (student 0, teacher 1,
# a pretrained target 2, cross-arch's EMA copy 4)
COMMON_INIT_KEYS = (0, 1, 2, 4)
# one directory for the workers of one pytest-xdist run, else none
_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID")
if _RUN is not None:
    # the workers of a run share the XLA programs they compile (the same
    # reference steps and eager operations recur across files and
    # workers); the directory is the run's own, so every entry is read on
    # the machine that wrote it, which moma_tpu/core/cache.py requires of
    # a CPU cache
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), f"moma_port_inits_{_RUN}", "xla"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def make_init_ordered(model, sample_shape, dtype=np.float32):
    """Returns init(key) -> flax variables as insertion-ordered numpy
    dicts, jit-compiled once per process for `model` (flax modules compare
    by their fields) at `sample_shape`: the parity files share effiB0's.
    Under pytest-xdist the run's workers share the results (module
    docstring)."""
    key = (model, tuple(sample_shape), np.dtype(dtype).name)
    if key not in _INITS:
        _INITS[key] = _make_init_ordered(model, sample_shape, dtype)
    init = _INITS[key]
    if _RUN is None:
        return init

    def path_of(rng):
        name = hashlib.sha256(repr((repr(model), key[1:], np.asarray(
            jax.random.key_data(rng) if jax.dtypes.issubdtype(
                rng.dtype, jax.dtypes.prng_key) else rng).tobytes(),
            jax.__version__)).encode()).hexdigest()[:32]
        root = os.path.join(tempfile.gettempdir(),
                            f"moma_port_inits_{_RUN}")
        os.makedirs(root, exist_ok=True)
        return os.path.join(root, name + ".pkl")

    def store(path, v):
        with open(path + ".tmp", "wb") as f:
            pickle.dump(v, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)

    def shared(rng):
        from filelock import FileLock, Timeout

        path = path_of(rng)
        with FileLock(path + ".lock"):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
            v = init(rng)
            store(path, v)
        # the program is compiled here now: leave the keys the files use
        # most for the other workers, which would each compile it again
        # (a key another worker is computing is skipped, never waited for)
        for k in COMMON_INIT_KEYS:
            sib = path_of(jax.random.PRNGKey(k))
            if sib == path or os.path.exists(sib):
                continue
            try:
                with FileLock(sib + ".lock", timeout=0):
                    if not os.path.exists(sib):
                        store(sib, init(jax.random.PRNGKey(k)))
            except Timeout:
                pass
        return v

    return shared


_HEADS = {}


def heads_init(heads, key: int):
    """heads.init(jax.random.PRNGKey(key)) of a JAX CMOHeads or
    CMOEmaTecHeads as insertion-ordered numpy (params, batch_stats), once a
    process and once for the workers of a pytest-xdist run (run_once): an
    eager init takes 0.2-3 s, its first operations compiling, and several
    files ask for the same heads."""
    name = "heads_" + hashlib.sha256(repr((
        type(heads).__name__, sorted(vars(heads).items()), key,
        jax.__version__)).encode()).hexdigest()[:32]
    if name not in _HEADS:
        _HEADS[name] = run_once(name, lambda: tuple(
            ordered_numpy(t) for t in heads.init(jax.random.PRNGKey(key))))
    return _HEADS[name]


def run_once(name: str, fn):
    """fn(), computed once for the workers of one pytest-xdist run: the
    first worker to need it computes it and leaves it (torch.save) in the
    run's directory under the temporary directory, the others load it.
    Without xdist, fn().  For a module fixture whose cost would otherwise
    repeat on every worker its tests land on."""
    if _RUN is None:
        return fn()
    from filelock import FileLock

    root = os.path.join(tempfile.gettempdir(), f"moma_port_inits_{_RUN}")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name + ".pt")
    with FileLock(path + ".lock"):
        if os.path.exists(path):
            return torch.load(path, weights_only=False)
        value = fn()
        torch.save(value, path + ".tmp")
        os.replace(path + ".tmp", path)
        return value


def run_once_in_thread(name: str, fn):
    """A future of run_once(name, fn), computed in a thread: for a spawn
    of ranks, which a module fixture starts so that its tests compute
    their JAX references before they wait for the ranks."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run_once, name, fn)
    pool.shutdown(wait=False)
    return future


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


_TEMPLATES = {}


def jax_template(model, sample_shape, dtype=np.float32):
    """Zeros shaped like `model.init`'s variables, insertion-ordered, from
    an abstract trace (jax.eval_shape: nothing is compiled or run).  With
    moma_tpu_torch.interop.jax_variables it gives a JAX tree holding a port
    module's own initial weights, at a fraction of a compiled init's cost
    (effiB1: 2.9 s against 7.9 s).  The trace runs once a process and once
    for the workers of a pytest-xdist run (run_once keeps its shapes);
    every call returns new writable zeros."""
    name = "template_" + hashlib.sha256(repr((
        type(model).__name__, repr(model), tuple(sample_shape),
        np.dtype(dtype).name, jax.__version__)).encode()).hexdigest()[:32]

    def shapes():
        sample = np.zeros(sample_shape, dtype)
        return _shape_skeleton(tree_template(
            lambda key: model.init(key, sample, train=False),
            jax.random.PRNGKey(0)))

    if name not in _TEMPLATES:
        _TEMPLATES[name] = run_once(name, shapes)
    return _zeros_like_skeleton(_TEMPLATES[name])


def _shape_skeleton(tree):
    if isinstance(tree, Mapping):
        return [(k, _shape_skeleton(v)) for k, v in tree.items()]
    a = np.asarray(tree)
    return (tuple(a.shape), a.dtype)


def _zeros_like_skeleton(skel):
    if isinstance(skel, tuple):
        return np.zeros(skel[0], skel[1])
    return {k: _zeros_like_skeleton(v) for k, v in skel}


def copied(tree):
    """An order-preserving deep copy of a nested dict of arrays (tree_map
    would sort the keys the converter aligns by)."""
    if isinstance(tree, Mapping):
        return {k: copied(v) for k, v in tree.items()}
    return np.array(tree)


class ReluInputs(TorchFunctionMode):
    """Records the smallest |input| of any relu run inside: a ReLU input
    within float rounding of 0 can take opposite sides in two packages,
    which moves every gradient before it by far more than rounding."""

    def __init__(self):
        super().__init__()
        self.low = float("inf")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (F.relu, torch.relu):
            self.low = min(self.low, float(args[0].detach().abs().min()))
        return func(*args, **(kwargs or {}))


def route_margin(model: torch.nn.Module, run):
    """(run(), the smallest gap over every token that an MoE layer
    (moma_tpu_torch.models.vit_moe.MoEMLP) of `model` routes while `run`
    runs between its k-th and (k+1)-th router probability).  A token
    within rounding of a tie could route differently in the two packages,
    or on the card: parity tests assert a margin, as ReluInputs does for
    ReLU inputs."""
    from moma_tpu_torch.models.vit_moe import MoEMLP

    gaps = []

    def hook(moe, args):
        x = args[0].reshape(-1, args[0].shape[-1]).float()
        p = torch.softmax(x @ moe.router.float(), -1).sort(
            -1, descending=True)[0]
        if p.shape[-1] > moe.top_k:
            gaps.append(float((p[:, moe.top_k - 1] - p[:, moe.top_k]).min()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, MoEMLP)]
    try:
        out = run()
    finally:
        for h in handles:
            h.remove()
    return out, min(gaps, default=float("inf"))


def tree_template(fn, *args):
    """Zeros shaped like fn(*args)'s output (nested dicts, or a tuple of
    them), insertion-ordered, from an abstract trace.  The leaves are
    read-only broadcast views of one zero, which hold no memory."""
    order = {}

    def f(*a):
        out = fn(*a)
        order["skel"] = [_skeleton(o) for o in
                         (out if isinstance(out, tuple) else (out,))]
        return out

    shapes = jax.eval_shape(f, *args)
    zeros = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), shapes)
    outs = tuple(_rebuild(s, z) for s, z in zip(
        order["skel"], zeros if isinstance(zeros, tuple) else (zeros,)))
    return outs if isinstance(shapes, tuple) else outs[0]


def assert_close_scaled(got, want, rtol, what="", floor=0.0):
    """|got - want| <= rtol * (|want| + max(max|want|, floor)): relative
    error with a floor at the tensor's own scale, so entries near zero are
    held to the tolerance of the tensor rather than to their own tiny
    size.  `floor` covers tensors whose true value is zero (e.g. a BN bias
    feeding the next train-mode BN gets a zero gradient), where both sides
    hold only float noise: pass a small fraction of the enclosing group's
    scale (group_floor)."""
    # in the inputs' own float precision (float32 at least): the limit's
    # rounding is then 1e-7 of itself, and a 255M-element comparison does
    # not first copy both sides to float64; two temporaries, updated in
    # place (the same values as rtol * (|want| + scale) + 1e-30)
    dt = np.result_type(np.asarray(got).dtype, np.asarray(want).dtype,
                        np.float32)
    got = np.asarray(got, dt)
    want = np.asarray(want, dt)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    got, want = got.reshape(-1), want.reshape(-1)
    lim = np.abs(want)
    scale = max(lim.max() if want.size else 0.0, floor)
    lim = lim.astype(np.result_type(lim, scale), copy=False)
    err = np.subtract(got, want)
    np.abs(err, out=err)
    lim += scale
    lim *= rtol
    lim += 1e-30
    worst = float(np.divide(err, lim, out=lim).max()) if want.size else 0.0
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
