"""Typed configuration tree + the CLI bridges.

Counterpart of moma_tpu/core/config.py: the same dataclasses, field names
and defaults (without the TPU-only `scoped_vmem_kib` and `donate`; with an
explicit `RunConfig.device`), `Config.run_name` (the run directory's
name), `parse_student_args` for the flags of scripts/run_moma.sh and
scripts/run_comparison.sh, and `parse_teacher_args` for those of
scripts/run_vanilla.sh, each plus --fp32, --synthetic and --device.

The port runs these slices of moma_tpu so far: supervised training of any
backbone of the port's registry; MoMA distillation with a same-arch
teacher or (cross-arch EmaTec mode) any other backbone, every memory
variant (MoCo, MoCoAtt, MoCoST, MoCoSSTT), attention mode and projection
head; the 17 comparison distillers (`DISTILLERS`), on one process; each
with the run around the step (checkpoints, --resume, pretrained weights,
the resized crop, folds, the optimizer's options) and --grad_accum; the
supervised and MoMA runs also data-parallel over a process group
(core/mesh.py), MoMA with --bn global|local|sync and, same-arch, with
--model_parallel (the negative bank split over the model ranks).
`check_slice` and `check_model_axis` reject every other choice with
NotImplementedError rather than training something else than asked.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

DATASET_NUM_CLASSES = {
    "cifar100": 100,
    "imagenet": 1000,
    "prostate_hv": 4,
    "prostate_ubc": 4,
    "colon_tp": 4,
    "crc_tp": 4,
    "gastric": 8,
    "panda_512": 4,
    "kather19": 9,
    "kather19_nonorm": 9,
    "kather16": 9,
    "aggc2022": 6,
}


# the comparison distillers of train/distill.py (moma_tpu/train/distill.py)
DISTILLERS = ("kd", "hint", "attention", "similarity", "vid", "nst", "rkd",
              "pkt", "kdsvd", "correlation", "crd", "semckd", "srrl",
              "simkd", "ab", "fsp", "ft")

# the choices of --mem / --head / --attn the port trains (moma/cmo.py holds
# the module sets of the attention modes)
MEMS = ("MoCo", "MoCoST", "MoCoSSTT", "MoCoAtt")
HEADS = ("None", "linear", "mlp", "mlp_byol")
ATTN_MODES = ("all", "self_mix", "qk", "dual", "dual2", "self_qk",
              "self_nomix", "self_qkv2", "selfv2", "self", "self_viz", "none")


@dataclass
class DataConfig:
    dataset: str = "cifar100"
    data_dir: str = "./data"
    batch_size: int = 64
    eval_batch_size: int = 0  # 0 => same as batch_size
    num_workers: int = 8
    image_size: int = 32
    image_resize: bool = False
    crop: float = 0.2
    aug_train: str = "RA"  # 'RA' | 'NULL'
    ra_config: str = "rand-n2-m10-mstd0.5"
    use_cmc: bool = False
    percent: float = 1.0
    fold_idx: int = -1
    n_folds: int = 5

    @property
    def n_cls(self) -> int:
        return DATASET_NUM_CLASSES[self.dataset]


@dataclass
class ModelConfig:
    name: str = "resnet20"
    n_cls: int = 100
    pretrain: Optional[str] = None
    strict: bool = True
    dropout: float = 0.0


@dataclass
class OptimConfig:
    learning_rate: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    cosine: bool = False
    lr_decay_rate: float = 0.1
    lr_decay_epochs: Tuple[int, ...] = (150, 180, 210)
    grad_clip: float = 0.0
    trust_ratio: float = 0.0
    warmup_epochs: float = 0.0


@dataclass
class DistillConfig:
    distill: str = "kd"
    kd_T: float = 4.0
    cls: float = 1.0  # -c
    div: float = 1.0  # -d
    beta: float = 0.0  # -b
    factor: int = 2
    soft: float = 1.0
    hint_layer: int = 1


@dataclass
class MomaConfig:
    feat_dim: int = 512
    nce_k: int = 16384
    nce_t: float = 0.07  # forced to 0.15 when distill == 'moma'
    nce_m: float = 0.5
    alpha: float = 0.999
    mem: str = "MoCo"
    head: str = "mlp"
    attn: str = "self"
    mode: str = "exact"
    shuffle_bn: bool = True
    # 'exact': eval-BN teacher KL forward on each epoch's first batch,
    # train-BN after (the reference's per-epoch model_t.eval() reset)
    kl_teacher_bn: str = "exact"
    fast_teacher: bool = False
    fused_teacher: str = "off"
    teacher_quant: str = "none"


@dataclass
class RunConfig:
    epochs: int = 240
    seed: int = 12345
    print_freq: int = 100
    save_dir: str = "./save"
    trial: str = "0"
    skip_test: bool = False
    preflight_eval: bool = False
    resume: bool = False
    half_precision: bool = True  # bf16 compute (flax dtype= semantics)
    bn: str = "global"
    model_parallel: int = 1
    sequence_parallel: bool = False
    teacher_parallel: str = "tensor"
    pp_microbatch: int = 0
    grad_accum: int = 1
    remat: bool = False
    profile_dir: str = ""
    device: str = "cuda"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model_s: ModelConfig = field(default_factory=ModelConfig)
    model_t: Optional[ModelConfig] = None
    optim: OptimConfig = field(default_factory=OptimConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    moma: MomaConfig = field(default_factory=MomaConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def finalize(self) -> "Config":
        """Cross-field derivations (config.py:247-271)."""
        if self.distill.distill == "cmo":
            self.distill.distill = "moma"
        n_cls = DATASET_NUM_CLASSES.get(self.data.dataset, self.model_s.n_cls)
        self.model_s.n_cls = n_cls
        if self.model_t is not None:
            self.model_t.n_cls = n_cls
        if self.distill.distill == "moma":
            self.moma.nce_t = 0.15
        if self.data.eval_batch_size == 0:
            self.data.eval_batch_size = self.data.batch_size
        if self.data.fold_idx >= 0:
            if self.data.n_folds < 2:
                raise ValueError(
                    f"--n_folds must be >= 2 (got {self.data.n_folds})")
            if self.data.fold_idx >= self.data.n_folds:
                raise ValueError(
                    f"--fold_idx {self.data.fold_idx} out of range for "
                    f"--n_folds {self.data.n_folds}")
        return self

    @property
    def run_name(self) -> str:
        """The run directory's name under --save_dir (config.py:273-288)."""
        d = self.distill
        parts = [
            d.distill,
            self.data.dataset,
            self.model_s.name,
            f"bs{self.data.batch_size}",
            f"lr{self.optim.learning_rate}",
            f"c{d.cls}_d{d.div}_b{d.beta}",
            f"trial{self.run.trial}",
        ]
        if self.data.fold_idx >= 0:
            parts.insert(-1, f"fold{self.data.fold_idx}of{self.data.n_folds}")
        if self.model_t is not None:
            parts.insert(1, f"T-{self.model_t.name}")
        return "_".join(parts)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def check_slice(cfg: Config, supervised: bool = False) -> None:
    """Raise NotImplementedError for any choice outside the ported slice;
    `supervised`: a teacher run's config (no teacher, no distiller)."""
    m, method = cfg.moma, cfg.distill.distill
    bad = []
    if not supervised:
        if method not in ("moma",) + DISTILLERS:
            bad.append(f"--distill {method} (known: moma, {DISTILLERS})")
        if m.mem not in MEMS:
            bad.append(f"--mem {m.mem} (known: {MEMS})")
        if m.head not in HEADS:
            bad.append(f"--head {m.head} (known: {HEADS})")
        if m.attn not in ATTN_MODES:
            bad.append(f"--attn {m.attn} (known: {ATTN_MODES})")
        if cfg.model_t is None:
            bad.append("distillation without a teacher")
    if bad:
        raise NotImplementedError(
            "not ported to moma_tpu_torch yet (see ROADMAP.md): "
            + "; ".join(bad))


def check_model_axis(cfg: Config, cross_arch: bool, teacher=None,
                     n_data: int = 1) -> None:
    """The JAX package's refusals around --model_parallel in a MoMA run
    (train/moma.py:1273-1431), its messages as ValueError in its order.
    With the teacher module (`teacher`, on a grid of `n_data` data rows)
    also the checks of the teacher's route at --model_parallel > 1: the
    pipeline (models/vit_pp.check_pp_teacher, on the accumulation
    microbatch), the tensor-parallel ViT (models/vit_tp.check_tp_teacher),
    the expert-parallel MoE ViT (models/vit_moe.check_ep_teacher) or a
    teacher kept whole on every model rank."""
    r = cfg.run
    if r.pp_microbatch and r.teacher_parallel != "pipeline":
        raise ValueError(
            "--pp_microbatch only applies with --teacher_parallel pipeline")
    mp = r.model_parallel
    if mp <= 1:
        # in both arches, after the --pp_microbatch check (moma.py:1426-1431)
        if r.sequence_parallel:
            raise ValueError(
                "--sequence_parallel requires --model_parallel > 1")
        if r.teacher_parallel != "tensor":
            raise ValueError(
                f"--teacher_parallel {r.teacher_parallel} requires "
                "--model_parallel > 1")
        return
    if r.bn != "global" and cross_arch:
        raise ValueError(
            "bn='local'/'sync' with --model_parallel does not compose "
            "with the cross-arch TP/PP/EP teachers: those shard via "
            "GSPMD NamedSharding annotations, which cannot appear "
            "inside a shard_map body (per-device code).  Use "
            "bn='global' for cross-arch model-parallel runs.")
    if r.sequence_parallel and not cross_arch:
        raise ValueError(
            "--sequence_parallel applies to the tensor-parallel ViT "
            "teacher (cross-arch/EmaTec mode only)")
    if r.teacher_parallel != "tensor" and not cross_arch:
        raise ValueError(
            f"--teacher_parallel {r.teacher_parallel} applies to the "
            "ViT KL-teacher (cross-arch/EmaTec mode only)")
    if cfg.moma.nce_k % mp != 0:
        raise ValueError(f"nce_k={cfg.moma.nce_k} not divisible by "
                         f"model_parallel={mp}")
    if not cross_arch:
        return
    quant = cfg.moma.teacher_quant
    if r.teacher_parallel == "expert":
        if r.sequence_parallel:
            raise ValueError(
                "--sequence_parallel applies to the TENSOR-parallel"
                " teacher; --teacher_parallel expert shards the MoE"
                " expert axis instead")
        if teacher is not None:
            from moma_tpu_torch.models.vit_moe import check_ep_teacher

            check_ep_teacher(teacher, mp, quant)
        return
    if teacher is None:
        return
    from moma_tpu_torch.models.vit_pp import check_pp_teacher, is_pp_model
    from moma_tpu_torch.models.vit_tp import check_tp_teacher, is_tp_model

    if r.teacher_parallel == "pipeline":
        if r.sequence_parallel:
            raise ValueError(
                "--sequence_parallel applies to the TENSOR-parallel"
                " teacher; --teacher_parallel pipeline stages whole"
                " blocks (nothing to token-shard between them)")
        if not is_pp_model(teacher):
            raise ValueError(
                "--teacher_parallel pipeline requires a ViT family "
                f"teacher, got {type(teacher).__name__}")
        # under --grad_accum the teacher forward runs per accumulation
        # microbatch: that is the batch the pipeline splits
        check_pp_teacher(teacher, mp, n_data, r.pp_microbatch or mp,
                         batch_size=cfg.data.batch_size
                         // max(1, r.grad_accum), teacher_quant=quant)
    elif is_tp_model(teacher):
        check_tp_teacher(teacher, mp, quant)
    elif r.sequence_parallel:
        raise ValueError(
            "--sequence_parallel requires a tensor-parallel ViT "
            f"teacher, got {type(teacher).__name__}")


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    """The flags both training CLIs take (config.py:295-418), without
    those the port would accept and ignore (--scoped_vmem_kib, --sync_bn:
    argparse refuses them), plus --fp32 and --device.  --synthetic is
    taken by the CLIs, as in moma_tpu."""
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8,
                   help="gather threads of the native prefetcher that "
                        "assembles a packed dataset's training batches")
    p.add_argument("--epochs", type=int, default=240)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--lr_decay_epochs", type=str, default="150,180,210")
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--warmup_epochs", type=float, default=0.0)
    p.add_argument("--trust_ratio", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--aug_train", type=str, default="RA",
                   choices=["NULL", "RA"])
    p.add_argument("--ra_config", type=str, default="rand-n2-m10-mstd0.5")
    p.add_argument("--use_cmc", action="store_true")
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--crop", type=float, default=0.2,
                   help="lower area bound of the random resized crop "
                        "(--image_resize)")
    p.add_argument("--image_resize", action="store_true")
    p.add_argument("--fold_idx", type=int, default=-1,
                   help="stratified k-fold CV: validation fold index over "
                        "the train+val pool (histo datasets; -1 = the "
                        "dataset's native splits)")
    p.add_argument("--n_folds", type=int, default=5)
    p.add_argument("--trial", type=str, default="0",
                   help="run label, part of the run directory's name")
    p.add_argument("--save_dir", type=str, default="./save",
                   help="root of the run directories")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--skip_validation", action="store_true",
                   help="run a pre-flight eval of the loaded model / "
                        "teacher on the test split before training (the "
                        "reference's inverted store_false flag: passing it "
                        "RUNS the validation)")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; an error if absent) "
                        "or cpu")
    p.add_argument("--bn", type=str, default="global",
                   choices=["global", "local", "sync"],
                   help="BN across the ranks of a torch.distributed run "
                        "(--distill moma): 'global' the global batch's "
                        "statistics, 'local' each rank's own with a "
                        "Shuffle-BN over the global batch, 'sync' local "
                        "with synced statistics")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="--distill moma: split the negative bank over MP "
                        "ranks of each data row (a (data N/MP x model MP) "
                        "grid of the N ranks)")
    p.add_argument("--sequence_parallel", action="store_true")
    p.add_argument("--teacher_parallel", type=str, default="tensor",
                   choices=["tensor", "pipeline", "expert"])
    p.add_argument("--pp_microbatch", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into M microbatches, one SGD "
                        "step on their averaged gradients (a microbatch "
                        "is a virtual rank)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue from <run dir>/ckpt/latest.pt")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch")
    p.add_argument("--n_cls", type=int, default=0)


def _cfg_from_common(a) -> Config:
    cfg = Config()
    cfg.data = DataConfig(
        dataset=a.dataset, data_dir=a.data_dir, batch_size=a.batch_size,
        num_workers=a.num_workers, image_size=a.image_size,
        image_resize=a.image_resize, crop=a.crop,
        aug_train=a.aug_train, ra_config=a.ra_config, use_cmc=a.use_cmc,
        fold_idx=a.fold_idx, n_folds=a.n_folds)
    cfg.optim = OptimConfig(
        learning_rate=a.learning_rate, momentum=a.momentum,
        weight_decay=a.weight_decay, cosine=a.cosine,
        lr_decay_rate=a.lr_decay_rate,
        lr_decay_epochs=tuple(int(x) for x in a.lr_decay_epochs.split(",")),
        grad_clip=a.grad_clip, trust_ratio=a.trust_ratio,
        warmup_epochs=a.warmup_epochs)
    cfg.run = RunConfig(
        epochs=a.epochs, seed=a.seed, print_freq=a.print_freq,
        save_dir=a.save_dir, trial=a.trial, skip_test=a.skip_test,
        preflight_eval=a.skip_validation, half_precision=not a.fp32,
        bn=a.bn, model_parallel=a.model_parallel,
        sequence_parallel=a.sequence_parallel,
        teacher_parallel=a.teacher_parallel, pp_microbatch=a.pp_microbatch,
        grad_accum=a.grad_accum,
        remat=a.remat, resume=a.resume, profile_dir=a.profile_dir,
        device=a.device)
    return cfg


def teacher_parser() -> argparse.ArgumentParser:
    """The flags of scripts/run_vanilla.sh's train_teacher
    (config.py:471-482)."""
    p = argparse.ArgumentParser("moma_tpu_torch train_teacher")
    _add_common_flags(p)
    p.add_argument("--model", type=str, default="resnet20")
    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--not_strict", action="store_true")
    p.add_argument("--pre_strict", action="store_false", dest="pre_strict",
                   help="reference alias of strict pretrained loading "
                        "(passing it disables strict)")
    return p


def parse_teacher_args(argv=None) -> Config:
    """CLI -> Config (config.py:485-496); raises for choices outside the
    ported slice (check_slice)."""
    a = teacher_parser().parse_args(argv)
    cfg = _cfg_from_common(a)
    cfg.model_s = ModelConfig(name=a.model, pretrain=a.pretrain,
                              strict=(not a.not_strict) and a.pre_strict)
    cfg = cfg.finalize()
    if a.n_cls:
        cfg.model_s.n_cls = a.n_cls
    check_slice(cfg, supervised=True)
    return cfg


def student_parser() -> argparse.ArgumentParser:
    """The flags scripts/run_moma.sh and scripts/run_comparison.sh pass to
    train_student (config.py:499-558), plus the switches check_slice
    rejects (so a reference command line fails loudly, not silently)."""
    p = argparse.ArgumentParser("moma_tpu_torch train_student")
    _add_common_flags(p)
    p.add_argument("--model_s", type=str, default="resnet8x4")
    p.add_argument("--model_t", type=str, default="resnet32x4")
    p.add_argument("--path_t", type=str, default=None)
    p.add_argument("--std_pre", type=str, default=None)
    p.add_argument("--std_strict", action="store_false", dest="std_strict")
    p.add_argument("--tec_pre", type=str, default=None)
    p.add_argument("--tec_strict", action="store_false", dest="tec_strict")
    p.add_argument("--distill", type=str, default="kd")
    p.add_argument("--kd_T", type=float, default=4.0)
    p.add_argument("-c", "--cls", type=float, default=1.0)
    p.add_argument("-d", "--div", type=float, default=1.0)
    p.add_argument("-b", "--beta", type=float, default=0.0)
    p.add_argument("-f", "--factor", type=int, default=2)
    p.add_argument("-s", "--soft", type=float, default=1.0)
    p.add_argument("--hint_layer", type=int, default=1,
                   choices=[0, 1, 2, 3, 4])
    p.add_argument("--feat_dim", type=int, default=512)
    p.add_argument("--mode", type=str, default="exact",
                   choices=["exact", "relax"])
    p.add_argument("--nce_k", type=int, default=16384)
    p.add_argument("--nce_t", type=float, default=0.07)
    p.add_argument("--nce_m", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.999)
    p.add_argument("--mem", type=str, default="MoCo",
                   choices=list(MEMS))
    p.add_argument("--head", type=str, default="None",
                   choices=list(HEADS))
    p.add_argument("--attn", type=str, default="self")
    p.add_argument("--no_shuffle_bn", action="store_true")
    p.add_argument("--kl_teacher_bn", type=str, default="exact",
                   choices=["train", "eval", "exact"])
    p.add_argument("--fast_teacher", action="store_true")
    p.add_argument("--fused_teacher", type=str, default="off",
                   choices=["off", "on"])
    p.add_argument("--teacher_quant", type=str, default="none",
                   choices=["none", "int8"])
    return p


def parse_student_args(argv=None) -> Config:
    """CLI -> Config (config.py:562-586); raises for choices outside the
    ported slice (check_slice)."""
    a = student_parser().parse_args(argv)
    cfg = _cfg_from_common(a)
    cfg.model_s = ModelConfig(name=a.model_s, pretrain=a.std_pre,
                              strict=a.std_strict)
    cfg.model_t = ModelConfig(name=a.model_t, pretrain=a.path_t or a.tec_pre,
                              strict=a.tec_strict)
    cfg.distill = DistillConfig(distill=a.distill, kd_T=a.kd_T, cls=a.cls,
                                div=a.div, beta=a.beta, factor=a.factor,
                                soft=a.soft, hint_layer=a.hint_layer)
    cfg.moma = MomaConfig(
        feat_dim=a.feat_dim, nce_k=a.nce_k, nce_t=a.nce_t, nce_m=a.nce_m,
        alpha=a.alpha, mem=a.mem, head=a.head, attn=a.attn, mode=a.mode,
        shuffle_bn=not a.no_shuffle_bn, kl_teacher_bn=a.kl_teacher_bn,
        fast_teacher=a.fast_teacher, fused_teacher=a.fused_teacher,
        teacher_quant=a.teacher_quant)
    cfg = cfg.finalize()
    if a.n_cls:
        cfg.model_s.n_cls = a.n_cls
        cfg.model_t.n_cls = a.n_cls
    check_slice(cfg)
    return cfg
