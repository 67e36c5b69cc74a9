"""Data-parallel runtime: the process group, this process's rank, and the
collectives of the training steps.

Counterpart of moma_tpu/core/mesh.py (`init_distributed` :29-66,
`local_batch_size` :101-108) and of the two
collective sets of moma_tpu/train/moma.py (`_Replicated`, `_DataAxis`
:99-135).  JAX sees every device of a host through one mesh; here, as in
the reference's DDP trainers, there is one process per GPU under
`python -m torch.distributed.run --nproc_per_node N`, and the data axis is
the process group:

  * `init_distributed` reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR.  Without them it does nothing: one process, no group.
    With them it pins the process to cuda:LOCAL_RANK (and raises when that
    card does not exist, rather than sharing one silently) and starts the
    group: NCCL for a CUDA device, gloo for the CPU, or the backend named.
  * `data_axis()` is `_Replicated` in one process without a group (the
    identity collectives) and `_DataAxis` in a group: `gather` is
    all_gather + cat and carries no gradient (every tensor the JAX step
    gathers is gradient-free: images, keys, key logits, the keys entering
    the queue), `gather_grad` carries one (the global-batch attention of
    `--bn global`), `pmean_` averages tensors in place through one flat
    all_reduce, `local_slice` is this rank's rows.  Every collective adds
    its bytes to `comm_counts()`.
  * `spawn_ranks` runs a function on N local processes (the `spawn` start
    method), each in a group it starts itself at tcp://localhost:<free
    port>, with a hard timeout: the 2-rank tests, and two ranks sharing
    one card (gloo: NCCL refuses two ranks on one device).

`--model_parallel > 1` (the model axis, ROADMAP Queue 1 item [5b]) stays
refused by config.check_slice.
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
    """Leave the group (a no-op without one)."""
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

    def gather(self, x: torch.Tensor) -> torch.Tensor:
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


def _all_gather(x: torch.Tensor, world: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", x.numel() * x.element_size())
    return torch.cat(parts, 0)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM all_reduce of one contiguous tensor, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", t.numel() * t.element_size())
    return t


class _GatherGrad(torch.autograd.Function):
    """all_gather + cat whose backward sums every rank's gradient of the
    gathered rows and keeps this rank's (a reduce-scatter, here one
    all_reduce of the (world*n, ...) gradient)."""

    @staticmethod
    def forward(ctx, x, world, rank, group):
        ctx.world, ctx.rank, ctx.group, ctx.n = world, rank, group, x.shape[0]
        return _all_gather(x, world, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum_(g.contiguous(), ctx.group)
        n = ctx.n
        return g[ctx.rank * n:(ctx.rank + 1) * n], None, None, None


class _DataAxis:
    """Collectives over the process group (one rank per device): the body
    of a step sees its LOCAL batch, as one of the reference's DDP ranks."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """all_gather + cat over the ranks (rank order), no gradient."""
        with torch.no_grad():
            return _all_gather(x.detach(), self.world, self.group)

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """all_gather + cat whose gradient flows back to every rank's
        rows."""
        return _GatherGrad.apply(x, self.world, self.rank, self.group)

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


def data_axis():
    """The collectives of this process: `_DataAxis` over the default group
    when one is running (one rank of it too: its collectives are real
    ones, exact copies), else `_Replicated`."""
    if dist.is_available() and dist.is_initialized():
        return _DataAxis()
    return _REPLICATED


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return data_axis().rank == 0


def rank_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """Rank (or microbatch) i's augmentation stream of a step: a generator
    seeded from the step's (seed, epoch, step) and i, the counterpart of
    fold_in(k_aug, axis_index) (train/moma.py:297-302).  The step's own
    generator is untouched, so the draws shared by every rank (the
    Shuffle-BN permutation) stay one draw."""
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

