"""Rank bodies of the port's multi-process tests (tests/test_torch_port_
dist.py on the CPU, two cases of tests/test_torch_port_cuda.py on the
card), run by moma_tpu_torch.core.mesh.spawn_ranks in spawned gloo
processes, and the helpers the tests share with them.  This module imports
torch and moma_tpu_torch only: a spawned rank re-imports it, and JAX would
cost every rank seconds.

Every body takes (rank, world, ...) and returns what the test compares,
its tensors on the CPU; `inp` is the dict of inputs the test wrote
(test_torch_port_dist._inputs).
"""

from __future__ import annotations

import os
import signal

import torch

MOMA_KEYS = ("loss", "loss_cls", "loss_div", "loss_kd", "acc1", "acc5")


def _cpu_sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def noise_augment(images, generator):
    """An augmentation that depends on its generator's stream, so a step
    whose ranks (or microbatches) draw from the wrong stream differs."""
    noise = torch.randn(images.shape, generator=generator)
    return images.float() + 0.05 * noise.to(images.device)


def moma_config(bn: str, head: str, inp: dict, grad_accum: int = 1,
                mem: str = "MoCo", attn: str = "self"):
    from moma_tpu_torch.core.config import (Config, DistillConfig,
                                            ModelConfig, MomaConfig)

    cfg = Config()
    cfg.data.batch_size = inp["B"]
    cfg.model_s = ModelConfig(name=inp["model"], n_cls=inp["n_cls"])
    cfg.model_t = ModelConfig(name=inp["model"], n_cls=inp["n_cls"])
    cfg.distill = DistillConfig(distill="moma", cls=1.0, div=1.0, beta=1.0,
                                kd_T=4.0)
    cfg.moma = MomaConfig(feat_dim=inp["feat"], nce_k=inp["K"], nce_t=0.15,
                          alpha=inp["alpha"], mem=mem, head=head,
                          attn=attn, shuffle_bn=True,
                          kl_teacher_bn=inp.get("kl_teacher_bn", "eval"))
    cfg.run.bn = bn
    cfg.run.grad_accum = grad_accum
    cfg.run.half_precision = False
    return cfg


def moma_state(inp: dict, head: str, mem: str = "MoCo", device="cpu",
               attn: str = "self"):
    """A MomaState holding the test's weights (inp['weights'][head]; heads
    of the attention set of `attn`), the test's queue, plain SGD at lr
    inp['lr'] (no momentum, no decay)."""
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.moma.cmo import CMOHeads
    from moma_tpu_torch.moma.queue import QueueState
    from moma_tpu_torch.train.state import MomaState, make_sgd

    w = inp["weights"][head]
    student = create_model(inp["model"], inp["n_cls"])
    teacher = create_model(inp["model"], inp["n_cls"])
    heads = CMOHeads(head, attn, inp["feat"], s_dim=inp["s_dim"],
                     t_dim=inp["s_dim"])
    student.load_state_dict(w["student"])
    teacher.load_state_dict(w["teacher"])
    heads.load_state_dict(w["heads"])
    fmt = torch.channels_last
    student = student.to(device, memory_format=fmt)
    teacher = teacher.to(device, memory_format=fmt).requires_grad_(False)
    heads = heads.to(device)
    heads.embed_t.requires_grad_(False)
    banks = (("memory_s", "memory_t") if mem in ("MoCoST", "MoCoSSTT")
             else ("memory",))
    queue = QueueState({n: inp["memory"].clone().to(device) for n in banks})
    lr = inp["lr"]
    state = MomaState(student=student, teacher=teacher, heads=heads,
                      queue=queue, optimizer=None, schedule=lambda s: lr)
    state.optimizer = make_sgd(state.trainable_params(), momentum=0.0,
                               weight_decay=0.0)
    return state


def cross_state(inp: dict, grad_accum: int = 1):
    """(MomaState, config) of a cross-arch (EmaTec) MoMA step: the test's
    student, a small ViT teacher (inp['cross']['vit'], weights
    inp['cross']['teacher']), CMO heads with the EMA key head, the EMA copy
    starting at the student's weights, the test's queue; plain SGD at
    inp['lr'], --bn global."""
    import copy

    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.models.vit import VisionTransformer
    from moma_tpu_torch.moma.cmo import CMOHeads
    from moma_tpu_torch.moma.queue import QueueState
    from moma_tpu_torch.train.state import MomaState, make_sgd

    w = inp["cross"]
    student = create_model(inp["model"], inp["n_cls"])
    student.load_state_dict(inp["weights"]["mlp"]["student"])
    teacher = VisionTransformer(**w["vit"], num_classes=inp["n_cls"],
                                image_size=inp["HW"])
    teacher.load_state_dict(w["teacher"])
    heads = CMOHeads("mlp", "self", inp["feat"], s_dim=inp["s_dim"],
                     t_dim=w["vit"]["dim"], include_ema=True)
    heads.load_state_dict(w["heads"])
    student = student.to(memory_format=torch.channels_last)
    ema = copy.deepcopy(student)
    for m in (teacher, ema, heads.embed_t, heads.embed_ema):
        m.requires_grad_(False)
    lr = inp["lr"]
    state = MomaState(student=student, teacher=teacher, heads=heads,
                      ema=ema, queue=QueueState({"memory":
                                                 inp["memory"].clone()}),
                      optimizer=None, schedule=lambda s: lr)
    state.optimizer = make_sgd(state.trainable_params(), momentum=0.0,
                               weight_decay=0.0)
    cfg = moma_config("global", "mlp", inp, grad_accum=grad_accum)
    cfg.model_t.name = "vit_tiny_patch16_224"
    return state, cfg


def moma_result(state, metrics) -> dict:
    out = {"metrics": {k: float(metrics[k]) for k in MOMA_KEYS},
           "queue_ptr": int(metrics["queue_ptr"]),
           "student": _cpu_sd(state.student),
           "teacher": _cpu_sd(state.teacher),
           "heads": _cpu_sd(state.heads),
           "queue": {k: v.detach().cpu().clone()
                     for k, v in state.queue.memory.items()}}
    if state.ema is not None:
        out["ema"] = _cpu_sd(state.ema)
    return out


def cross_step(rank: int, world: int, inp: dict) -> dict:
    """One cross-arch MoMA step (--bn global) on this rank's rows."""
    from moma_tpu_torch.train.moma import make_moma_train_step

    state, cfg = cross_state(inp)
    step = make_moma_train_step(cfg, None, cross_arch=True)
    state, metrics = step(state, rank_batch(inp, rank, world,
                                            inp["modes"]["global"][2]),
                          torch.Generator().manual_seed(7))
    return moma_result(state, metrics)


def rank_batch(inp: dict, rank: int, world: int, perm, device="cpu"):
    b = inp["B"] // world
    rows = slice(rank * b, (rank + 1) * b)
    return {"image": inp["images"][rows].to(device),
            "label": inp["labels"][rows].to(device),
            "shuffle_perm": perm.to(device)}


def moma_modes(rank: int, world: int, path: str) -> dict:
    """One MoMA step per entry of inp['modes'] (name -> (bn, head, perm,
    augment)), each from the test's initial state, on this rank's rows."""
    from moma_tpu_torch.train.moma import make_moma_train_step

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    out = {}
    for name, (bn, head, perm, augment) in inp["modes"].items():
        state = moma_state(inp, head)
        step = make_moma_train_step(moma_config(bn, head, inp),
                                    noise_augment if augment else None)
        state, metrics = step(state, rank_batch(inp, rank, world, perm),
                              torch.Generator().manual_seed(7))
        out[name] = moma_result(state, metrics)
    if "cross" in inp:
        out["cross"] = cross_step(rank, world, inp)
    out["sync_bn"] = sync_bn(rank, world, inp["bn_x"], inp["bn_w"])
    out["vanilla"] = vanilla(rank, world, inp)
    out["vanilla_accum"] = vanilla(rank, world, inp, grad_accum=2)
    return out


def sync_bn(rank: int, world: int, x: torch.Tensor, w: torch.Tensor,
            device: str = "cpu"):
    """This rank's rows of x through a FusedBatchNorm in train mode under
    sync statistics on `device`; the loss sum(y * w) over the rank's rows.
    On a CUDA device the kernels' launch counts come back too."""
    from moma_tpu_torch.core.mesh import data_axis
    from moma_tpu_torch.ops.fused_bn import FusedBatchNorm, sync_stats
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    reset_launch_counts()
    b = x.shape[0] // world
    xr = x[rank * b:(rank + 1) * b].to(device).requires_grad_(True)
    w = w.to(device)
    bn = FusedBatchNorm(x.shape[1]).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    with sync_stats(data_axis()):
        y = bn(xr)
        (y * w[rank * b:(rank + 1) * b]).sum().backward()
    out = {"y": y.detach(), "dx": xr.grad.detach(),
           "dscale": bn.weight.grad.detach(), "dbias": bn.bias.grad.detach(),
           "running_mean": bn.running_mean.clone(),
           "running_var": bn.running_var.clone()}
    return {**{k: v.cpu() for k, v in out.items()},
            "launches": launch_counts()}


def built_moma_step(rank: int, world: int, argv: list, augment: bool):
    """One MoMA step of the run `argv` (train_student's flags) from
    build_state's seeded weights on this rank's rows of a seeded batch of
    --batch_size images (its Shuffle-BN permutation fixed); returns the
    metrics and the state's tensors on the CPU."""
    import numpy as np

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.moma import build_state, make_moma_train_step
    from moma_tpu_torch.train.teacher import augment_fns

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_student_args(argv)
    dev = torch.device(cfg.run.device)
    state = build_state(cfg, dev, 4, seed=0)
    step = make_moma_train_step(cfg, augment_fns(cfg)[0] if augment else None,
                                kl_train_bn_override=True)
    B, S = cfg.data.batch_size, cfg.data.image_size
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (B, S, S, 3), dtype=np.uint8),
             "label": rs.randint(0, cfg.model_s.n_cls, (B,)).astype(np.int32),
             "shuffle_perm": rs.permutation(B)}
    b = B // world
    rows = {k: (v if k == "shuffle_perm" else v[rank * b:(rank + 1) * b])
            for k, v in batch.items()}
    state, m = step(state, to_device(rows, dev),
                    torch.Generator().manual_seed(5))
    return ({k: float(v) for k, v in m.items()},
            {"student": _cpu_sd(state.student),
             "teacher": _cpu_sd(state.teacher),
             "heads": _cpu_sd(state.heads),
             "queue": {k: v.cpu() for k, v in state.queue.memory.items()}})


def vanilla_state(inp: dict):
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.train.state import TrainState, make_sgd

    model = create_model(inp["model"], inp["n_cls"])
    model.load_state_dict(inp["weights"]["mlp"]["student"])
    model = model.to(memory_format=torch.channels_last)
    lr = inp["lr"]
    return TrainState(model=model, optimizer=make_sgd(
        model.parameters(), momentum=0.9, weight_decay=5e-4),
        schedule=lambda s: lr)


def vanilla(rank: int, world: int, inp: dict, grad_accum: int = 1) -> dict:
    """One vanilla step of `grad_accum` microbatches on this rank's rows
    (the Loader's split; sync statistics, averaged gradients)."""
    from moma_tpu_torch.core.mesh import rank_rows
    from moma_tpu_torch.train.steps import make_vanilla_train_step

    state = vanilla_state(inp)
    state, m = make_vanilla_train_step(None, grad_accum)(
        state, {k: rank_rows(inp[v], rank, world, grad_accum)
                for k, v in (("image", "images"), ("label", "labels"))},
        torch.Generator().manual_seed(1))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "model": _cpu_sd(state.model)}


def preempted_teacher(rank: int, world: int, path: str) -> dict:
    """run_teacher on synthetic data; rank 1 sends itself SIGTERM after its
    third step.  Returns the run's result flags and step count."""
    from moma_tpu_torch.core.config import parse_teacher_args
    from moma_tpu_torch.train import teacher as T

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    make = T.make_vanilla_train_step

    def make_signalling(*a, **k):
        step = make(*a, **k)
        calls = [0]

        def wrapped(state, batch, generator):
            out = step(state, batch, generator)
            calls[0] += 1
            if rank == 1 and calls[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    T.make_vanilla_train_step = make_signalling
    cfg = parse_teacher_args(inp["argv"])
    state, result = T.run_teacher(cfg, synthetic=True)
    return {"preempted": bool(result.get("preempted")), "step": state.step,
            "steps": result["train"]["steps"] if result["train"] else None,
            "model": _cpu_sd(state.model), "run_dir": result["run_dir"]}
