"""Rank bodies of tests/test_torch_port_teacher_parallel.py (and of its card
cases in tests/test_torch_port_cuda.py), run by
moma_tpu_torch.core.mesh.spawn_ranks in spawned gloo processes.  This
module imports torch and moma_tpu_torch only: a spawned rank re-imports
it, and JAX would cost every rank seconds.

`teacher_parallel_cases` runs every case of the test file in one spawn of
4 ranks: the tensor-parallel (TP), sequence-parallel (SP), pipeline (PP)
ViT and expert-parallel (EP) MoE ViT forwards on a (1 x 4) grid, then on
the (2 x 2) grid the same at --model_parallel 2, the MoE forward routed
over the 2 data ranks (`moe_scope_cases`) and the cross-arch MoMA step
with a TP+SP teacher; then, regrouped into two 2-rank worlds on (1 x 2)
grids, the step with a TP teacher and a run_moma --resume pair (ranks 0
and 1) beside the steps with a PP and an EP teacher (ranks 2 and 3).
Every result comes back with its tensors on the CPU, keyed by the case.
"""

from __future__ import annotations

import torch

import torch_dist_workers as DW
from torch_model_axis_workers import _cut_sets, _regroup


def _dense(inp: dict, kind: str, device="cpu", dtype=None):
    from moma_tpu_torch.models.vit import VisionTransformer

    vit = VisionTransformer(**inp["vits"][kind], num_classes=inp["n_cls"],
                            image_size=inp["HW"], dtype=dtype)
    vit.load_state_dict(inp["vit_weights"][kind])
    return vit.to(device)


def place(dense, route: str, n_micro: int = 0):
    """This rank's share of `dense` on the grid's model axis: 'tp', 'sp'
    or 'pp' (n_micro microbatches, 0: the stage count)."""
    from moma_tpu_torch.core.mesh import data_axis, model_axis
    from moma_tpu_torch.models.vit_pp import PPVisionTransformer
    from moma_tpu_torch.models.vit_tp import TPVisionTransformer

    if route == "pp":
        return PPVisionTransformer(dense, model_axis(), n_micro,
                                   data_axis().world)
    return TPVisionTransformer(dense, model_axis(), route == "sp")


def forward_case(inp: dict, route: str, n_micro: int = 0, device="cpu",
                 dtype=None):
    """One forward of this rank's share of the test's ViT ('pp' the deep
    one) on the images: its ((grid, cls), logits), the collectives of the
    forward (core/mesh.comm_counts), the parameters this rank holds and
    the dense model's, and the gathered dense state dict."""
    from moma_tpu_torch.core.mesh import comm_counts, reset_comm_counts

    dense = _dense(inp, "pp" if route == "pp" else "tp", device, dtype)
    n_dense = sum(p.numel() for p in dense.parameters())
    n_dense_blocks = sum(p.numel() for p in dense.blocks.parameters())
    x = inp["x"].to(device)
    with torch.no_grad():
        model = place(dense, route, n_micro)
        del dense
        reset_comm_counts()
        (grid, cls), logits = model(x)
        comm = comm_counts()
        back = model.dense_state_dict()
    return {"grid": grid.float().cpu(), "cls": cls.cpu(),
            "logits": logits.cpu(), "comm": comm,
            "params": sum(p.numel() for p in model.parameters()),
            "block_params": sum(p.numel()
                                for p in model.blocks.parameters()),
            "dense_params": n_dense, "dense_block_params": n_dense_blocks,
            "back": {k: v.cpu() for k, v in back.items()}}


def _dense_moe(inp: dict, device="cpu", dtype=None):
    from moma_tpu_torch.models.vit_moe import MoEVisionTransformer

    moe = MoEVisionTransformer(**inp["moe"], num_classes=inp["n_cls"],
                               image_size=inp["HW"], dtype=dtype)
    moe.load_state_dict(inp["moe_weights"])
    return moe.to(device)


def _outputs(model, x) -> dict:
    (grid, cls), logits = model(x)
    return {"grid": grid.float().cpu(), "cls": cls.cpu(),
            "logits": logits.cpu()}


def moe_forward_case(inp: dict, device="cpu", dtype=None) -> dict:
    """The dense MoE ViT's forward on the images in this process, then
    this model rank's expert-parallel share's (EPMoEVisionTransformer):
    both outputs, the share's collectives, the experts and expert bytes
    it holds of each MoE block, and its gathered dense state dict."""
    from moma_tpu_torch.core.mesh import (comm_counts, model_axis,
                                          reset_comm_counts)
    from moma_tpu_torch.models.vit_moe import EPMoEVisionTransformer

    dense = _dense_moe(inp, device, dtype)
    x = inp["x"].to(device)
    with torch.no_grad():
        one = _outputs(dense, x)
        model = EPMoEVisionTransformer(dense, model_axis())
        reset_comm_counts()
        out = _outputs(model, x)
        comm = comm_counts()
        back = model.dense_state_dict()
    return {**out, "one_rank": one, "comm": comm,
            "experts": [m.w1.shape[0] for m in model.moe_layers()],
            "expert_bytes": model.expert_bytes(),
            "back": {k: v.cpu() for k, v in back.items()}}


def moe_scope_cases(inp: dict) -> dict:
    """The MoE forward with the batch split over the data ranks (each
    rank's rows by mesh.rank_rows): routed together
    (routing_scope(data_axis()), --bn global), at 1 and 2 accumulation
    microbatches, and with the model ranks' experts split too; and routed
    per rank (--bn local | sync).  Each case: this rank's outputs, in
    microbatch order, and the forwards' collectives."""
    from moma_tpu_torch.core.mesh import (comm_counts, data_axis, model_axis,
                                          rank_rows, reset_comm_counts)
    from moma_tpu_torch.models.vit_moe import (EPMoEVisionTransformer,
                                               routing_scope)

    ax = data_axis()
    out = {}
    for case, M, scoped, ep in (("global", 1, True, False),
                                ("global_accum2", 2, True, False),
                                ("global_ep", 1, True, True),
                                ("local", 1, False, False)):
        model = _dense_moe(inp)
        if ep:
            model = EPMoEVisionTransformer(model, model_axis())
        rows = rank_rows(inp["x"], ax.rank, ax.world, M)
        reset_comm_counts()
        with torch.no_grad(), routing_scope(ax if scoped else None):
            res = [_outputs(model, r) for r in rows.chunk(M)]
        out[case] = {k: torch.cat([r[k] for r in res]) for k in res[0]}
        out[case]["comm"] = comm_counts()
    return out


def card_forwards(rank: int, world: int, inp: dict) -> dict:
    """tests/test_torch_port_cuda.py's card case: forward_case for every
    route of inp['forward_cases'] on the card, float32 with TF32 off, on
    a (1 x world) grid."""
    from moma_tpu_torch.core.mesh import create_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    create_mesh(world)
    return {(route, n_micro): forward_case(inp, route, n_micro, "cuda")
            for route, n_micro in inp["forward_cases"]}


def cross_step(inp: dict, route: str, n_micro: int = 0):
    """One cross-arch MoMA step (--bn global) with the teacher on this
    grid's model axis by `route`, the bank split over it, on this data
    row's rows; the state after it, the teacher gathered whole."""
    from moma_tpu_torch.core.mesh import data_axis, model_axis
    from moma_tpu_torch.train.moma import (make_moma_train_step,
                                           parallel_teacher,
                                           teacher_state_dict)

    mx, ax = model_axis(), data_axis()
    state, cfg = DW.cross_state(inp)
    if route == "ep":
        state.teacher = _dense_moe(inp).requires_grad_(False)
        cfg.model_t.name = "vit_tiny_moe_patch16_224"
    cfg.run.model_parallel = mx.size
    cfg.run.teacher_parallel = {"pp": "pipeline", "ep": "expert"}.get(
        route, "tensor")
    cfg.run.sequence_parallel = route == "sp"
    cfg.run.pp_microbatch = n_micro
    state.teacher = parallel_teacher(cfg, state.teacher)
    state.queue.memory = {k: mx.shard_rows(v)
                          for k, v in state.queue.memory.items()}
    step = make_moma_train_step(cfg, None, cross_arch=True)
    state, metrics = step(state, DW.rank_batch(inp, ax.rank, ax.world,
                                               inp["perm"]),
                          torch.Generator().manual_seed(7))
    out = DW.moma_result(state, metrics)
    out["teacher"] = {k: v.cpu() for k, v in
                      teacher_state_dict(state.teacher).items()}
    out["queue"] = {k: mx.all_gather(v, 0) for k, v in out["queue"].items()}
    return out


def run_moma_tp(argv: list, root: str) -> dict:
    """run_moma at --model_parallel 2 with the tensor-parallel teacher:
    straight for 2 epochs, and for 1 epoch into `root`/resumed (the test
    resumes it at --model_parallel 1); the straight run's step losses and
    the run directories."""
    import json
    import os

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train import moma as moma_train

    _cut_sets(moma_train)

    def run(sub, epochs):
        cfg = parse_student_args(argv + [
            "--save_dir", os.path.join(root, sub), "--epochs", str(epochs),
            "--model_parallel", "2"])
        _, result = moma_train.run_moma(cfg, synthetic=True)
        with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
            losses = [(r["step"], r["loss"]) for r in map(json.loads, f)]
        return losses, result["run_dir"]

    straight, _ = run("straight", 2)
    _, run_dir = run("resumed", 1)
    return {"straight": straight, "run_dir": run_dir}


def teacher_parallel_cases(rank: int, world: int, path: str) -> dict:
    from moma_tpu_torch.core.mesh import create_mesh, data_axis, model_axis

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    out = {"forward": {}, "cross": {}}
    for mp in (4, 2):
        create_mesh(mp)
        for route, n_micro in inp["forward_cases"]:
            out["forward"][(mp, route, n_micro)] = forward_case(
                inp, route, n_micro)
        out["forward"][(mp, "ep", 0)] = moe_forward_case(inp)
    out["moe_scope"] = moe_scope_cases(inp)
    # the (2 x 2) grid
    out["grid"] = (data_axis().rank, data_axis().world, model_axis().index,
                   model_axis().size)
    out["cross"]["sp"] = cross_step(inp, "sp")
    g = _regroup(rank, world, 2)
    create_mesh(2)
    if g == 0:
        out["cross"]["tp"] = cross_step(inp, "tp")
        out["resume"] = run_moma_tp(inp["resume_argv"], inp["root"])
    else:
        out["cross"]["pp"] = cross_step(inp, "pp")
        out["cross"]["ep"] = cross_step(inp, "ep")
    return out
