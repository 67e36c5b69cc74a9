"""Rank bodies of the port's model-axis tests (tests/test_torch_port_model_
axis.py on the CPU, its card case in tests/test_torch_port_cuda.py), run
by moma_tpu_torch.core.mesh.spawn_ranks in spawned gloo processes.  This
module imports torch and moma_tpu_torch only: a spawned rank re-imports
it, and JAX would cost every rank seconds.

`model_axis_cases` runs every case of the test file in one spawn of 4
ranks: the ring attention on a (1 x 4) and a (2 x 2) grid, the split-bank
steps and the whole MoMA step on the (2 x 2) grid, then, regrouped into
two 2-rank worlds, a run_moma --resume round trip on a (1 x 2) grid
(ranks 0 and 1) beside the 2-rank `--bn global --grad_accum 2` step
(ranks 2 and 3).  The accumulated step over a split bank ([5b-accum])
runs on the (2 x 2) grid and, after the 2-rank step, on a (1 x 2) one
(ranks 2 and 3).  Every
result comes back with its tensors on the CPU, keyed by the case.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_dist_workers as DW


class TokenRows(TorchDispatchMode):
    """Records the largest non-last dimension of every tensor an operator
    returns: a tensor that holds the bank's rows has K of them there (the
    last dimension of a (B, K) logit block holds no bank row)."""

    def __init__(self):
        super().__init__()
        self.most = 0
        self.where = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.dim() >= 2:
                rows = max(t.shape[:-1])
                if rows > self.most:
                    self.most, self.where = rows, f"{func} {tuple(t.shape)}"
        return out


def _regroup(rank: int, world: int, n: int) -> int:
    """Leave the world of every rank and start worlds of n ranks each,
    ranks [g*n, (g+1)*n) in world g at its own port (rank 0's choices,
    sent to all first); returns this rank's world g."""
    import datetime

    import torch.distributed as dist

    from moma_tpu_torch.core.mesh import free_port, shutdown

    ports = torch.tensor([free_port() if rank == 0 else 0
                          for _ in range(world // n)])
    dist.broadcast(ports, 0)
    shutdown()
    g = rank // n
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{int(ports[g])}",
        rank=rank % n, world_size=n,
        timeout=datetime.timedelta(seconds=240))
    return g


# ------------------------------------------------------------------ ring

def ring_case(inp: dict, nb: int, dtype=torch.float32, device="cpu"):
    """The ring attention over [x_rep (nb rows); this rank's rows of the
    bank tokens], its outputs and the gradients of JAX's test loss
    sum(out_rep * w_rep) + sum(gather(_grad_div(out_loc)) * w_loc)."""
    from moma_tpu_torch.core.mesh import model_axis
    from moma_tpu_torch.moma.queue import _grad_div
    from moma_tpu_torch.ops.ring_attention import ring_batch_token_attention
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    mx = model_axis()
    x = inp["x_all"].to(device, dtype)
    x_rep = x[:inp["NB"]][:nb].clone().requires_grad_(True)
    x_loc = mx.shard_rows(x[inp["NB"]:]).clone().requires_grad_(True)
    kern = [t.to(device).clone().requires_grad_(True) for t in inp["kern"]]
    w_rep = inp["w_rep"][:nb].to(device, dtype)
    w_loc = inp["w_loc"].to(device, dtype)
    reset_launch_counts()
    with TokenRows() as rows:
        out_rep, out_loc = ring_batch_token_attention(
            x_rep, x_loc, *kern, inp["H"], mx)
    gathered = mx.all_gather_grad(_grad_div(out_loc, mx), 0)
    loss = (out_rep * w_rep).float().sum() + (gathered * w_loc).float().sum()
    # the cotangents of the ring's outputs first, then the ring's backward
    # alone under the watch (the test's gather holds every row, the ring
    # does not)
    g_rep, g_loc = torch.autograd.grad(loss, [out_rep, out_loc],
                                       retain_graph=True)
    with rows:
        torch.autograd.backward([out_rep, out_loc], [g_rep, g_loc])
    grads = [x_rep.grad, x_loc.grad] + [t.grad for t in kern]
    return {"out_rep": out_rep.detach().float().cpu(),
            "out_loc": out_loc.detach().float().cpu(),
            "grads": [g.float().cpu() for g in grads],
            "rows": rows.most, "launches": launch_counts()}


def ring_on_grid(rank: int, world: int, inp: dict, mp: int, nb: int,
                 dtype=torch.float32, device="cpu"):
    """ring_case on a grid of `mp` model ranks (tests/test_torch_port_cuda's
    card case: two gloo ranks sharing the card)."""
    from moma_tpu_torch.core.mesh import create_mesh

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    create_mesh(mp)
    return ring_case(inp, nb, dtype, device)


# ---------------------------------------------------------- split bank

def _bank_state(inp, names=("memory",)):
    from moma_tpu_torch.core.mesh import model_axis
    from moma_tpu_torch.moma.queue import QueueState

    mx = model_axis()
    return QueueState({n: mx.shard_rows(inp["bank"][n]).clone()
                       for n in names}, ptr=inp["ptr"])


def _heads(inp, mode):
    from moma_tpu_torch.moma.cmo import CMOHeads

    heads = CMOHeads("mlp", mode, inp["D"], s_dim=inp["D"], t_dim=inp["D"])
    heads.load_state_dict(inp["att_weights"][mode])
    return heads


def bank_case(inp: dict, fn: str, mode=None, ring=True):
    """One split-bank step (moma/queue.py) on this rank's bank rows: its
    logit sets, dq (and dq_t) of sum(logits * w), this rank's new rows and
    the pointer; the largest token axis of any tensor made on the way."""
    from moma_tpu_torch.core.mesh import model_axis
    from moma_tpu_torch.moma import queue as Q

    mx = model_axis()
    T = inp["T"]
    q = inp["q"].clone().requires_grad_(True)
    q_t = inp["q_t"].clone().requires_grad_(True)
    k, k_t = inp["k"], inp["k_t"]
    all_k, all_k_t = inp["all_k"], inp["all_k_t"]
    with TokenRows() as rows:
        if fn == "moco":
            logits, new = Q.step_moco_sharded(_bank_state(inp), q, k, all_k,
                                              T, mx)
            logits = [logits]
        elif fn in ("st", "sstt", "sstt_noqt"):
            state = _bank_state(inp, ("memory_s", "memory_t"))
            if fn == "st":
                *logits, new = Q.step_moco_st_sharded(
                    state, q, k, k_t, all_k, all_k_t, T, mx)
            else:
                *logits, new = Q.step_moco_sstt_sharded(
                    state, q, k, q_t if fn == "sstt" else None, k_t, all_k,
                    all_k_t, T, mx)
        else:
            heads = _heads(inp, mode)
            logits, new = Q.step_moco_att_sharded(
                _bank_state(inp), q, k, all_k, T, mode, heads.attn_fns(), mx,
                ring_fns=heads.ring_attn_fns(mx) if ring else None)
            logits = [logits]
        loss = sum((lg * w[:, :lg.shape[1]]).sum()
                   for lg, w in zip(logits, inp["w"]))
        loss.backward()
    # a query no logit reads has a zero gradient, as jax.grad gives it
    return {"logits": [lg.detach() for lg in logits], "dq": q.grad,
            "dq_t": torch.zeros_like(q_t) if q_t.grad is None else q_t.grad,
            "bank": {k: v for k, v in new.memory.items()},
            "ptr": new.ptr, "rows": rows.most}


# ------------------------------------------------------------ the step

def moma_step(inp: dict, rank: int, case: dict):
    """One MoMA step of `case` (bn, mem, attn) on this data row's rows of
    the batch, the bank split over the model ranks."""
    from moma_tpu_torch.core.mesh import data_axis, model_axis
    from moma_tpu_torch.train.moma import make_moma_train_step

    mem, attn, bn = case["mem"], case["attn"], case["bn"]
    w = dict(inp["weights"]["mlp"])
    w["heads"] = inp["step_heads"][attn]
    state = DW.moma_state({**inp, "weights": {"mlp": w}}, "mlp", mem=mem,
                          attn=attn)
    mx = model_axis()
    state.queue.memory = {k: mx.shard_rows(v).clone()
                          for k, v in state.queue.memory.items()}
    cfg = DW.moma_config(bn, "mlp", inp, mem=mem, attn=attn)
    cfg.run.model_parallel = mx.size
    step = make_moma_train_step(cfg, None)
    ax = data_axis()
    state, metrics = step(state, DW.rank_batch(inp, ax.rank, ax.world,
                                               inp["perm"]),
                          torch.Generator().manual_seed(7))
    return DW.moma_result(state, metrics)


# ----------------------------------------------------- run_moma resume

def _cut_sets(monkeypatch_target):
    from moma_tpu_torch.data.pipeline import ArrayDataset

    full = monkeypatch_target.build_datasets

    def cut(cfg, synthetic):
        return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (8, 4, 4)))
    monkeypatch_target.build_datasets = cut


def run_moma_resume(argv: list, root: str) -> dict:
    """run_moma straight for 2 epochs, then 1 epoch and --resume to 2; the
    gathered full states and the losses of both."""
    import json
    import os

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train import moma as moma_train

    _cut_sets(moma_train)

    def run(sub, epochs, *extra):
        cfg = parse_student_args(argv + ["--save_dir", os.path.join(root,
                                                                   sub),
                                         "--epochs", str(epochs), *extra])
        state, result = moma_train.run_moma(cfg, synthetic=True)
        with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
            losses = [(r["step"], r["loss"]) for r in map(json.loads, f)]
        return moma_train.full_state(state), losses, result["run_dir"]

    argv = argv + ["--model_parallel", "2"]
    straight, l_straight, _ = run("straight", 2)
    run("resumed", 1)
    resumed, l_resumed, run_dir = run("resumed", 2, "--resume")
    from moma_tpu_torch.core.mesh import model_axis

    return {"straight": straight, "resumed": resumed,
            "losses": (l_straight, l_resumed), "run_dir": run_dir,
            "model_index": model_axis().index}


# ------------------------------------------------------- grad accum

def accum_step(inp: dict, rank: int, world: int):
    """The --bn global --grad_accum 2 step on this rank's share of each
    microbatch (mesh.rank_rows, the Loader's split)."""
    from moma_tpu_torch.core.mesh import rank_rows
    from moma_tpu_torch.train.moma import make_moma_train_step

    state = DW.moma_state(inp, "mlp")
    cfg = DW.moma_config("global", "mlp", inp, grad_accum=2)
    batch = {"image": rank_rows(inp["images"], rank, world, 2),
             "label": rank_rows(inp["labels"], rank, world, 2),
             "shuffle_perm": inp["perm"]}
    state, metrics = make_moma_train_step(cfg, None)(
        state, batch, torch.Generator().manual_seed(7))
    return DW.moma_result(state, metrics)


def accum_mp_step(inp: dict, case: dict):
    """The --bn global --grad_accum 2 step of `case` (mem, attn) on this
    grid: each data row's share of each microbatch (mesh.rank_rows), the
    bank split over the model ranks ([5b-accum])."""
    from moma_tpu_torch.core.mesh import data_axis, model_axis, rank_rows
    from moma_tpu_torch.train.moma import make_moma_train_step

    mem, attn = case["mem"], case["attn"]
    w = dict(inp["weights"]["mlp"])
    w["heads"] = inp["step_heads"][attn]
    state = DW.moma_state({**inp, "weights": {"mlp": w}}, "mlp", mem=mem,
                          attn=attn)
    mx, ax = model_axis(), data_axis()
    state.queue.memory = {k: mx.shard_rows(v).clone()
                          for k, v in state.queue.memory.items()}
    cfg = DW.moma_config("global", "mlp", inp, grad_accum=2, mem=mem,
                         attn=attn)
    cfg.run.model_parallel = mx.size
    batch = {"image": rank_rows(inp["images"], ax.rank, ax.world, 2),
             "label": rank_rows(inp["labels"], ax.rank, ax.world, 2),
             "shuffle_perm": inp["perm"]}
    state, metrics = make_moma_train_step(cfg, None)(
        state, batch, torch.Generator().manual_seed(7))
    return DW.moma_result(state, metrics)


# --------------------------------------------------------------- main

def model_axis_cases(rank: int, world: int, path: str) -> dict:
    from moma_tpu_torch.core.mesh import create_mesh, data_axis, model_axis

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    out = {"ring": {}, "bank": {}, "step": {}}
    for mp in (4, 2):
        create_mesh(mp)
        for nb in (inp["ring"]["NB"], 0):
            out["ring"][(mp, nb)] = ring_case(inp["ring"], nb)
    # the (2 x 2) grid stays for the bank and the step
    out["grid"] = (data_axis().rank, data_axis().world, model_axis().index,
                   model_axis().size)
    for name, (fn, mode, ring) in inp["bank_cases"].items():
        out["bank"][name] = bank_case(inp["bank_in"], fn, mode, ring)
    for name, case in inp["step_cases"].items():
        out["step"][name] = moma_step(inp["step_in"], rank, case)
    out["accum_mp"] = {
        name: accum_mp_step(inp["step_in"], case)
        for name, (grid, case) in inp["accum_mp_cases"].items()
        if grid == (2, 2)}
    if _regroup(rank, world, 2) == 0:
        out["resume"] = run_moma_resume(inp["resume_argv"], inp["root"])
    else:
        create_mesh(1)
        out["accum"] = accum_step(inp["step_in"], rank % 2, 2)
        create_mesh(2)
        out["accum_mp"].update(
            (name, accum_mp_step(inp["step_in"], case))
            for name, (grid, case) in inp["accum_mp_cases"].items()
            if grid == (1, 2))
    return out
