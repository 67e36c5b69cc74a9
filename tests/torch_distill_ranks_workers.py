"""Rank bodies of tests/test_torch_port_distill_ranks.py: the comparison
distillers' step on gloo ranks spawned by
moma_tpu_torch.core.mesh.spawn_ranks, each rank against the one-process
step on the global batch in the same process.  This module imports torch
and moma_tpu_torch only (a spawned rank re-imports it).

Every case builds its state from seeds (`distill_state`), so the ranks,
the one-process step and the test's JAX references hold the same weights
without shipping them; `inp` is the dict of inputs the test wrote
(test_torch_port_distill_ranks._inputs).
"""

from __future__ import annotations

import contextlib
import hashlib
import os

import torch

METRIC_KEYS = ("loss", "loss_cls", "loss_div", "loss_kd", "acc1", "acc5")
# the student's, the teacher's and the aux modules' seeds
SEEDS = (0, 1, 2)


def distill_config(inp: dict, method: str, grad_accum: int = 1):
    from moma_tpu_torch.core.config import (Config, DistillConfig,
                                            ModelConfig, MomaConfig)

    cfg = Config()
    cfg.data.batch_size = inp["B"]
    cfg.data.image_size = inp["HW"]
    cfg.model_s = ModelConfig(name="effiB0", n_cls=inp["n_cls"])
    cfg.model_t = ModelConfig(name="effiB0", n_cls=inp["n_cls"])
    cfg.distill = DistillConfig(distill=method, cls=1.0, div=1.0, beta=1.0)
    cfg.moma = MomaConfig(feat_dim=inp["feat"], nce_k=inp["nce_k"],
                          nce_t=0.07, nce_m=0.5)
    cfg.run.grad_accum = grad_accum
    cfg.run.half_precision = False
    return cfg


def distill_models(inp: dict):
    """(student, teacher) effiB0 from the seeds, in train / eval layout."""
    from moma_tpu_torch.models import create_model

    return tuple(create_model("effiB0", inp["n_cls"],
                              generator=torch.Generator().manual_seed(s))
                 for s in SEEDS[:2])


def distill_state(inp: dict, method: str, grad_accum: int = 1):
    """(DistillState, Distiller) of `method` from the seeds: effiB0 student
    and teacher, the method's aux modules, for crd the test's banks; plain
    SGD at inp['lr'] (no momentum, no decay)."""
    from moma_tpu_torch.losses.crd import CRDMemory
    from moma_tpu_torch.train.distill import Distiller, probe_shapes
    from moma_tpu_torch.train.state import DistillState, make_sgd

    cfg = distill_config(inp, method, grad_accum)
    student, teacher = distill_models(inp)
    shapes = probe_shapes(student, inp["HW"], inp["B"])[0]
    td = Distiller(cfg, shapes, shapes, n_data=inp["n_data"],
                   batch_size=inp["B"])
    aux = td.init_aux(torch.Generator().manual_seed(SEEDS[2]))
    fmt = torch.channels_last
    extra = None
    if method == "crd":
        v1, v2 = (b.clone() for b in inp["banks"])
        extra = CRDMemory(v1, v2, torch.tensor(-1.0), torch.tensor(-1.0))
    lr = inp["lr"]
    state = DistillState(
        student=student.to(memory_format=fmt), aux=aux.to(memory_format=fmt),
        teacher=teacher.to(memory_format=fmt).requires_grad_(False),
        optimizer=None, extra=extra, schedule=lambda s: lr)
    state.teacher.eval()
    state.optimizer = make_sgd(state.trainable_params(), momentum=0.0,
                               weight_decay=0.0)
    return state, td


def state_tensors(state) -> dict:
    """{'student': sd, 'aux': sd, 'extra': banks or {}}: the state's own
    CPU tensors (no copies: semckd's aux modules hold 255M parameters)."""
    out = {"student": {k: v.detach()
                       for k, v in state.student.state_dict().items()},
           "aux": {k: v.detach() for k, v in state.aux.state_dict().items()},
           "extra": {}}
    if state.extra is not None:
        out["extra"] = {k: v.detach()
                        for k, v in state.extra.state_dict().items()}
    return out


def digest(tensors: dict) -> str:
    """A hash of every tensor's bytes, in key order."""
    h = hashlib.sha256()
    for part in sorted(tensors):
        for k in sorted(tensors[part]):
            h.update(k.encode())
            h.update(tensors[part][k].contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def scaled_errors(got: dict, want: dict, floor_frac: float = 1e-3) -> dict:
    """{part/key: max |g - w| / (|w| + max(max|w|, floor))} for every
    float tensor of `want` (torch_port_helpers.assert_close_scaled's
    measure, the floor `floor_frac` of the part's largest magnitude), in
    the tensors' own float32; the count of differing entries for integer
    ones."""
    out = {}
    for part, tensors in want.items():
        floor = floor_frac * max((float(v.abs().max()) for v in
                                  tensors.values()
                                  if v.is_floating_point() and v.numel()),
                                 default=0.0)
        for k, w in tensors.items():
            g = got[part][k]
            if not w.is_floating_point():
                out[f"{part}/{k}"] = float((g != w).sum())
                continue
            if not w.numel():
                out[f"{part}/{k}"] = 0.0
                continue
            scale = max(float(w.abs().max()), floor)
            diff = (g - w).abs()
            out[f"{part}/{k}"] = float((diff / (w.abs() + scale)).max()
                                       if scale > 0 else diff.max())
    return out


@contextlib.contextmanager
def one_process():
    """The data axis of a single process inside a running group: the
    one-process step, in a rank."""
    from moma_tpu_torch.core import mesh

    mesh._GRID["data"] = mesh._REPLICATED
    try:
        yield
    finally:
        mesh._GRID.pop("data", None)


def run_step(inp: dict, method: str, grad_accum: int, batch: dict):
    from moma_tpu_torch.train.distill import make_distill_train_step

    state, td = distill_state(inp, method, grad_accum)
    step = make_distill_train_step(td, None, grad_accum)
    state, m = step(state, batch, torch.Generator().manual_seed(9))
    state.optimizer.zero_grad(set_to_none=True)
    return ({k: float(m[k]) for k in METRIC_KEYS}, state_tensors(state))


def check_case(inp: dict, name: str, method: str, ga: int,
               tensors: dict) -> dict:
    """The one-process step of a case on the global batch against a rank's
    state `tensors`: its metrics, the scaled errors (and for the cases of
    inp['noise_cases'] the one-process step's own float noise floor), and
    for the cases of inp['full'] the rank's whole state in a file."""
    res = {}
    with one_process():
        ref_m, ref_t = run_step(inp, method, ga, inp["batch"])
        if method in inp["noise_cases"]:
            # the one-process step's response to a 1e-7 relative change of
            # its input
            nudged = dict(inp["batch"])
            nudged["image"] = nudged["image"] * (1 + 1e-7)
            res["noise"] = max(scaled_errors(
                run_step(inp, method, ga, nudged)[1], ref_t,
                inp["floor_frac"]).values())
    res["ref_metrics"] = ref_m
    res["errors"] = scaled_errors(tensors, ref_t, inp["floor_frac"])
    if name in inp["full"]:
        # a file of its own: a test loads only the state it needs
        res["state_path"] = os.path.join(inp["root"], f"state_{name}.pt")
        torch.save(tensors, res["state_path"])
    return res


def publish(root: str, name: str, rank: int, value) -> None:
    """Leave `value` for the test as <root>/<name>.<rank>.pt, whole or not
    at all (written aside, then renamed)."""
    path = os.path.join(root, f"{name}.{rank}.pt")
    torch.save(value, path + ".tmp")
    os.replace(path + ".tmp", path)


def step_cases(rank: int, world: int, path: str) -> None:
    """For each case (name, method, grad_accum) of inp['cases'], in order:
    one step on this rank's rows (mesh.rank_rows), its metrics and state
    digest; case i is then checked against the one-process step on rank
    i % world, with that rank's state (the ranks' states are equal bit
    for bit, which the digests show), while the other rank waits in the
    next case's first collective.  The cases 'augment' and 'run' are (v)
    one augmented kd step on the same rows on every rank and (vi) the
    run_student runs.  Each rank publishes a case's results as soon as it
    has them, so a test waits for its own case only."""
    from moma_tpu_torch.core.mesh import rank_rows

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    for i, (name, method, ga) in enumerate(inp["cases"]):
        if name == "augment":
            res = augmented_step(rank, inp)
        elif name == "run":
            res = student_runs(rank, inp)
        else:
            local = {k: rank_rows(v, rank, world, ga)
                     for k, v in inp["batch"].items()}
            metrics, tensors = run_step(inp, method, ga, local)
            res = {"metrics": metrics, "digest": digest(tensors)}
            if i % world == rank:
                res.update(check_case(inp, name, method, ga, tensors))
            del tensors
        publish(inp["root"], name, rank, res)


def augmented_step(rank: int, inp: dict) -> dict:
    """One kd step with the histo RandAugment stack on the same uint8 rows
    on every rank; the augmented images the step made and the generator
    seed it made them from."""
    from moma_tpu_torch.data.histo_augment import make_histo_augment
    from moma_tpu_torch.train.distill import make_distill_train_step

    cfg = distill_config(inp, "kd")
    cfg.data.dataset = "prostate_hv"
    aug = make_histo_augment(cfg)
    seen = {}

    def recording(images, generator):
        seen["seed"] = generator.initial_seed()
        seen["image"] = aug(images, generator)
        return seen["image"]

    state, td = distill_state(inp, "kd")
    step = make_distill_train_step(td, recording)
    rows = inp["aug_rows"]
    step(state, {"image": rows, "label": inp["batch"]["label"][:len(rows)]},
         torch.Generator().manual_seed(inp["aug_seed"]))
    return {"seed": seen["seed"], "image": seen["image"].detach().clone(),
            "rank": rank}


def _cut_sets(T):
    """The synthetic sets cut to 16 train (4 steps an epoch at batch 4), 4
    val and 4 test images."""
    from moma_tpu_torch.data.pipeline import ArrayDataset

    full = T.build_datasets

    def cut(cfg, synthetic):
        return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                     for ds, n in zip(full(cfg, synthetic), (16, 4, 4)))

    T.build_datasets = cut


def student_runs(rank: int, inp: dict) -> dict:
    """run_student --distill crd on the ranks: 2 epochs straight; then 2
    epochs where rank 1 sends itself SIGTERM after its second step (the
    ranks agree on it one step boundary later, core/preempt.AgreedStop),
    and --resume.  Each batch's CRD draw is seeded from its indices, so a
    restart draws what the straight run drew.  Returns each run's step
    losses (scalars.jsonl, rank 0's), its final state and flags."""
    import json
    import signal

    import numpy as np

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train import distill as D
    from moma_tpu_torch.train import student as S
    from moma_tpu_torch.train import teacher as T

    _cut_sets(T)

    class PerBatch(S.InstanceSampler):
        def sample(self, idx):
            self.rng = np.random.RandomState(int(idx @ np.arange(
                1, len(idx) + 1)))
            return super().sample(idx)

    S.InstanceSampler = PerBatch
    make = D.make_distill_train_step

    def signalling(*a, **k):
        step = make(*a, **k)
        calls = [0]

        def wrapped(state, batch, generator):
            out = step(state, batch, generator)
            calls[0] += 1
            if rank == 1 and calls[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    def run(save, *extra, preempt=False):
        S.make_distill_train_step = signalling if preempt else make
        cfg = parse_student_args(inp["run_argv"] + [
            "--save_dir", os.path.join(inp["root"], save), *extra])
        state, result = S.run_student(cfg, synthetic=True)
        with open(os.path.join(result["run_dir"], "scalars.jsonl")) as f:
            losses = [(x["step"], x["loss"]) for x in map(json.loads, f)]
        return {"state": S.distill_full_state(state), "losses": losses,
                "preempted": bool(result.get("preempted")),
                "steps": result["train"]["steps"], "epochs": [
                    e["epoch"] for e in result["epochs"]],
                "run_dir": result["run_dir"]}

    straight = run("straight")
    preempted = run("resumed", preempt=True)
    resumed = run("resumed", "--resume")
    return {"straight": straight, "preempted": preempted,
            "resumed": resumed}
