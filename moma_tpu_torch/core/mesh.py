"""The (data, model) grid of ranks: the process group, this process's
place in it, and the collectives of the training steps.

Counterpart of moma_tpu/core/mesh.py (`init_distributed` :29-66,
`create_mesh` :67-85, `local_batch_size` :101-108) and of the two
collective sets of moma_tpu/train/moma.py (`_Replicated`, `_DataAxis`
:99-135).  JAX sees every device of a host through one mesh; here, as in
the reference's DDP trainers, there is one process per GPU under
`python -m torch.distributed.run --nproc_per_node N`:

  * `init_distributed` reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR.  Without them it does nothing: one process, no group.
    With them it pins the process to cuda:LOCAL_RANK (and raises when that
    card does not exist, rather than sharing one silently) and starts the
    group: NCCL for a CUDA device, gloo for the CPU, or the backend named.
  * `create_mesh(model_parallel)` lays the group's ranks out as JAX's
    ('data', 'model') grid, the model axis innermost: global rank r is
    data index r // MP, model index r % MP.  The data and model subgroups
    come from `dist.new_group`, called in the same order on every rank.
    Without it (or with model_parallel 1) the data axis is the whole
    group, as before.
  * `data_axis()` is `_Replicated` for one data index (one process, or
    the model ranks of a single data row) and `_DataAxis` over the data
    group otherwise: `gather` is all_gather + cat and carries no gradient
    (every tensor the JAX step gathers is gradient-free: images, keys, key
    logits, the keys entering the queue), `gather_grad` carries one (the
    global-batch attention of `--bn global`), `pmean_` averages tensors in
    place through one flat all_reduce, `local_slice` is this rank's rows.
  * `model_axis()` gives the model group's collectives: `all_gather`
    along dim 0 or 1 (with a gradient along dim 1: the sharded logits),
    `psum_` / `pmean_` in place, `index` / `size`, and `ppermute`, the
    ring hop to model rank (m + shift) % MP from (m - shift) % MP.  A
    gloo group's hops of CUDA tensors go through pinned host buffers
    (decided once, by the group's backend); NCCL's stay on the device.
  * `world_axis()` spans every rank: the stop agreement, the rank-0
    writes and their barrier.
  * Every collective adds its bytes to `comm_counts()` under its own name
    (the model axis's as `model_all_gather`, `model_all_reduce`,
    `model_reduce_scatter`, `model_broadcast`, `ppermute`; the MoE
    routing counts' as `moe_all_gather`).  gloo takes
    CUDA tensors in all of them but the ring hop's send / recv (checked
    with PyTorch 2.11 on an H100).
  * `spawn_ranks` runs a function on N local processes (the `spawn`
    start method), each in a group it starts itself at tcp://localhost:
    <free port>, with a hard timeout: the multi-rank tests, and ranks
    sharing one card (gloo: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
import traceback
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_COMM: Counter = Counter()


def comm_counts() -> Dict[str, int]:
    """{'all_gather', 'all_reduce': calls, '..._bytes': bytes sent in} of
    the collectives run since the last reset."""
    return dict(_COMM)


def reset_comm_counts() -> None:
    _COMM.clear()


def _count(kind: str, nbytes: int) -> None:
    _COMM[kind] += 1
    _COMM[kind + "_bytes"] += int(nbytes)


def env_world() -> int:
    """The world size: the group's once started, else torchrun's
    WORLD_SIZE (1 without it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Start the process group when torchrun's variables are set and no
    group runs yet; True when this call started it (the caller then ends
    it with `shutdown`).  A CUDA `device` pins the process to
    cuda:LOCAL_RANK before the group starts and raises when the host has
    no such card."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n:
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local} needs cuda:{local}, but "
                f"this host has {n} CUDA device(s); one process per GPU "
                "(two ranks on one card only through spawn_ranks and gloo)")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return True


def shutdown() -> None:
    """Leave the group (a no-op without one) and forget the grid."""
    _GRID.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch: int, world: int) -> int:
    if global_batch % world != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {world}")
    return global_batch // world


def rank_rows(rows, rank: int, world: int, grad_accum: int = 1):
    """Rank `rank`'s rows of a global batch (an array or tensor).  Without
    accumulation, the rank's contiguous B/world rows.  With
    `grad_accum` M, the rank's B/(M*world) rows of each of the batch's M
    contiguous chunks, so microbatch i on every rank is a share of global
    chunk i, the one-process step's microbatch i (JAX's accumulation
    splits the global batch so)."""
    b = local_batch_size(len(rows), world)
    if b % grad_accum != 0:
        raise ValueError(f"batch size {b} not divisible by "
                         f"grad_accum={grad_accum}")
    if grad_accum == 1:
        return rows[rank * b:(rank + 1) * b]
    return rows.reshape(grad_accum, world, -1,
                        *rows.shape[1:])[:, rank].reshape(b,
                                                          *rows.shape[1:])


# ---------------------------------------------------------------- axes

class _Replicated:
    """Identity collectives: one process sees the whole batch."""

    world, rank, group = 1, 0, None

    def gather(self, x: torch.Tensor, kind: str = "all_gather"
               ) -> torch.Tensor:
        return x

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmean_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        pass

    def local_slice(self, full: torch.Tensor, local_n: int) -> torch.Tensor:
        return full

    def any(self, flag: bool, device) -> bool:
        return bool(flag)

    def barrier(self) -> None:
        pass


def _all_gather(x: torch.Tensor, world: int, group, dim: int = 0,
                kind: str = "all_gather") -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    _count(kind, x.numel() * x.element_size())
    return torch.cat(parts, dim)


def all_reduce_sum_(t: torch.Tensor, group=None,
                    kind: str = "all_reduce") -> torch.Tensor:
    """In-place SUM all_reduce of one contiguous tensor, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count(kind, t.numel() * t.element_size())
    return t


class _GatherGrad(torch.autograd.Function):
    """all_gather + cat along `dim` whose backward sums every rank's
    gradient of the gathered tensor and keeps this rank's block (a
    reduce-scatter, here one all_reduce of the gathered gradient): the
    transpose of JAX's tiled all_gather."""

    @staticmethod
    def forward(ctx, x, world, rank, group, dim, kind):
        ctx.rank, ctx.group, ctx.dim, ctx.kind = rank, group, dim, kind
        ctx.n = x.shape[dim]
        return _all_gather(x, world, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        kind = ctx.kind.replace("all_gather", "all_reduce")
        g = all_reduce_sum_(g.contiguous(), ctx.group, kind)
        n = ctx.n
        return (g.narrow(ctx.dim, ctx.rank * n, n), None, None, None, None,
                None)


class _DataAxis:
    """Collectives over the process group (one rank per device): the body
    of a step sees its LOCAL batch, as one of the reference's DDP ranks."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def gather(self, x: torch.Tensor, kind: str = "all_gather"
               ) -> torch.Tensor:
        """all_gather + cat over the ranks (rank order), no gradient,
        counted under `kind`."""
        with torch.no_grad():
            return _all_gather(x.detach(), self.world, self.group, 0, kind)

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """all_gather + cat whose gradient flows back to every rank's
        rows."""
        return _GatherGrad.apply(x, self.world, self.rank, self.group, 0,
                                 "all_gather")

    def _flat_reduce_(self, tensors, scale: Optional[float]) -> None:
        tensors = list(tensors)
        if not tensors:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                all_reduce_sum_(flat, self.group)
                if scale is not None:
                    flat.mul_(scale)
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

    def pmean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average the tensors over the ranks, in place, through one
        all_reduce a dtype (DDP's gradient bucket)."""
        self._flat_reduce_(tensors, 1.0 / self.world)

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum the tensors over the ranks, in place."""
        self._flat_reduce_(tensors, None)

    def local_slice(self, full: torch.Tensor, local_n: int) -> torch.Tensor:
        return full[self.rank * local_n:(self.rank + 1) * local_n]

    def any(self, flag: bool, device) -> bool:
        """True on every rank when any rank's flag is set (an all_reduce
        MAX, read back on the host)."""
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        _count("all_reduce", t.element_size())
        return bool(t.item() > 0)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


_REPLICATED = _Replicated()


class _ModelAxis:
    """The collectives of one data row's model ranks: the split negative
    bank (moma/queue.py) and the ring attention over it
    (ops/ring_attention.py).  `size` 1 (no grid) makes every collective
    the identity."""

    def __init__(self, group=None, index: int = 0, size: int = 1,
                 ranks: Sequence[int] = (0,)):
        self.group, self.index, self.size = group, index, size
        self.ranks = list(ranks)   # global ranks, in model order
        # gloo sends and receives host memory (given a CUDA tensor, it
        # reads the device address as a host one and the process aborts):
        # its hops of CUDA tensors copy through pinned buffers; NCCL's stay
        # on the device
        self.stage_hops = (size > 1
                           and dist.get_backend(group) == "gloo")

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """all_gather + cat along `dim` over the model ranks, no gradient."""
        if self.size == 1:
            return x
        with torch.no_grad():
            return _all_gather(x.detach(), self.size, self.group, dim,
                               "model_all_gather")

    def all_gather_grad(self, x: torch.Tensor,
                        dim: int = 1) -> torch.Tensor:
        """all_gather + cat along `dim` whose backward hands this rank the
        sum of every rank's gradient of its block (JAX's tiled all_gather
        and its psum-scatter transpose)."""
        if self.size == 1:
            return x
        return _GatherGrad.apply(x, self.size, self.index, self.group, dim,
                                 "model_all_gather")

    def _flat_reduce_(self, tensors, scale: Optional[float]) -> None:
        tensors = [t for t in tensors if t is not None]
        if self.size == 1 or not tensors:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                all_reduce_sum_(flat, self.group, "model_all_reduce")
                if scale is not None:
                    flat.mul_(scale)
                for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(part.view_as(t))

    def psum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum the tensors over the model ranks, in place (one all_reduce
        a dtype)."""
        self._flat_reduce_(tensors, None)

    def pmean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average the tensors over the model ranks, in place."""
        self._flat_reduce_(tensors, 1.0 / self.size)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum one contiguous tensor over the model ranks, in place (the
        tensor-parallel teacher's reductions)."""
        if self.size == 1:
            return t
        return all_reduce_sum_(t, self.group, "model_all_reduce")

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the model ranks of `t`, of which this rank keeps
        chunk `index` of MP along `dim` (the sequence-parallel teacher's
        reductions into its token shard)."""
        if self.size == 1:
            return t
        parts = [c.contiguous() for c in t.chunk(self.size, dim)]
        out = torch.empty_like(parts[self.index])
        dist.reduce_scatter(out, parts, group=self.group)
        _count("model_reduce_scatter", t.numel() * t.element_size())
        return out

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Model rank `src`'s tensor on every model rank, in place (the
        pipeline teacher's finished tokens)."""
        if self.size == 1:
            return t
        t = t.contiguous()
        dist.broadcast(t, self.ranks[src], group=self.group)
        _count("model_broadcast", t.numel() * t.element_size())
        return t

    def shard_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows [m*n/MP, (m+1)*n/MP) of a tensor every model
        rank holds whole, a copy of its own (the whole one can go)."""
        if self.size == 1:
            return full
        n = full.shape[0] // self.size
        return full[self.index * n:(self.index + 1) * n].clone()

    def ppermute(self, tensors: Sequence[torch.Tensor],
                 shift: int = 1) -> List[torch.Tensor]:
        """The ring hop: send the tensors to model rank (m + shift) % MP
        and return those of rank (m - shift) % MP (JAX's lax.ppermute with
        the permutation i -> i + shift), one batch of sends and receives."""
        tensors = [t.contiguous() for t in tensors]
        if self.size == 1:
            return tensors
        dst = self.ranks[(self.index + shift) % self.size]
        src = self.ranks[(self.index - shift) % self.size]
        stage = self.stage_hops and tensors[0].is_cuda
        if stage:
            send = [t.to("cpu", non_blocking=False) for t in tensors]
            recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
        else:
            send = tensors
            recv = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, dst, self.group) for t in send]
               + [dist.P2POp(dist.irecv, t, src, self.group) for t in recv])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        _count("ppermute", sum(t.numel() * t.element_size()
                               for t in tensors))
        if stage:
            dev = tensors[0].device
            recv = [t.to(dev, non_blocking=True) for t in recv]
        return recv


_NO_MODEL_AXIS = _ModelAxis()
# the grid of create_mesh: {'mp', 'data': axis, 'model': axis}
_GRID: Dict[str, object] = {}


def create_mesh(model_parallel: int = 1) -> None:
    """Lay the running group out as a (data, model) grid of model_parallel
    ranks a data row, the model axis innermost (mesh.py:67-85): global
    rank r is data index r // MP and model index r % MP.  Every rank calls
    `dist.new_group` for every row and column, in the same order.  Raises
    JAX's ValueError when the world size does not divide."""
    _GRID.clear()
    world = env_world()
    if world % model_parallel != 0:
        raise ValueError(f"device count {world} not divisible by "
                         f"model_parallel={model_parallel}")
    if model_parallel == 1:
        return
    rank = dist.get_rank()
    n_data = world // model_parallel
    d, m = divmod(rank, model_parallel)
    model_groups = [dist.new_group(list(range(i * model_parallel,
                                              (i + 1) * model_parallel)))
                    for i in range(n_data)]
    data_groups = [dist.new_group(list(range(j, world, model_parallel)))
                   for j in range(model_parallel)]
    _GRID["mp"] = model_parallel
    _GRID["data"] = (_DataAxis(data_groups[m]) if n_data > 1
                     else _REPLICATED)
    _GRID["model"] = _ModelAxis(
        model_groups[d], m, model_parallel,
        range(d * model_parallel, (d + 1) * model_parallel))
    if rank == 0:
        hop = ("through pinned host buffers (gloo)"
               if _GRID["model"].stage_hops else "on the device")
        print(f"[mesh] (data {n_data} x model {model_parallel}) grid; "
              f"ring hops of CUDA tensors {hop}", flush=True)


def data_axis():
    """The collectives of this process's data row: over the grid's data
    group when create_mesh made one, else `_DataAxis` over the default
    group when one is running (one rank of it too: its collectives are
    real ones, exact copies), else `_Replicated`."""
    if "data" in _GRID:
        return _GRID["data"]
    if dist.is_available() and dist.is_initialized():
        return _DataAxis()
    return _REPLICATED


def model_axis():
    """The model ranks of this process's data row (create_mesh), or the
    identity axis of size 1."""
    return _GRID.get("model", _NO_MODEL_AXIS)


def world_axis():
    """Every rank of the group (or `_Replicated` without one): the stop
    agreement, the rank-0 writes and their barrier."""
    if dist.is_available() and dist.is_initialized():
        return _DataAxis()
    return _REPLICATED


def is_main() -> bool:
    """Global rank 0, or the only process: the one that writes files."""
    return world_axis().rank == 0


def rank_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """Data rank (or microbatch) i's augmentation stream of a step: a
    generator seeded from the step's (seed, epoch, step) and i, the
    counterpart of fold_in(k_aug, axis_index('data'))
    (train/moma.py:297-302), so the model ranks of a data row draw alike.
    The step's own generator is untouched, so the draws shared by every
    rank (the Shuffle-BN permutation) stay one draw."""
    mixed = (generator.initial_seed() ^ ((i + 1) * 0x9E3779B97F4A7C15))
    return torch.Generator().manual_seed(mixed % 2 ** 63)


# ------------------------------------------------------------- spawning

def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, out_dir, args,
               timeout_s) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            shutdown()
        torch.save({"ok": True, "result": result}, path)
    except BaseException:  # the parent raises with this text
        torch.save({"ok": False, "error": traceback.format_exc()}, path)
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """[fn(rank, world, *args) for each rank], each run in its own process
    (the `spawn` start method) inside a process group of `world` ranks on
    this host.  `fn` must be importable by module name and its results
    loadable by torch.load.  A rank that fails, or a run that outlasts
    `timeout_s`, kills every rank and raises with the failing rank's
    traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="moma_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, port, backend, out_dir, args,
                                   timeout_s), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        outs = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            outs.append(torch.load(path, weights_only=False)
                        if os.path.exists(path) else None)
        errors = [f"rank {r}:\n{o['error']}" for r, o in enumerate(outs)
                  if o is not None and not o["ok"]]
        if errors:
            raise RuntimeError("spawn_ranks: " + "\n".join(errors))
        if hung:
            raise TimeoutError(f"spawn_ranks: rank(s) {hung} still running "
                               f"after {timeout_s} s (killed)")
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0 or outs[r] is None]
        if bad:
            raise RuntimeError(f"spawn_ranks: rank(s) exited with {bad}")
        return [o["result"] for o in outs]

