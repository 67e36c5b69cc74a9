"""Typed configuration tree + the student CLI bridge.

Counterpart of moma_tpu/core/config.py: the same dataclasses, field names
and defaults (without the TPU-only `scoped_vmem_kib` and `donate`; with an
explicit `RunConfig.device`), `Config.run_name` (the run directory's
name), and `parse_student_args` for the flags of scripts/run_moma.sh plus
--fp32, --synthetic and --device.

The port runs these slices of moma_tpu so far: MoMA distillation with
global-batch BN on one device, a same-arch teacher or (cross-arch EmaTec
mode) any other backbone of the port's registry, every memory variant
(MoCo, MoCoAtt, MoCoST, MoCoSSTT), attention mode and projection head,
with the run around the step (checkpoints, --resume, pretrained weights,
the resized crop, folds, the optimizer's options).  `check_slice` rejects
every other choice with NotImplementedError rather than training something
else than asked.
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


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for any choice outside the ported slice."""
    from moma_tpu_torch.models import available_models

    m, r = cfg.moma, cfg.run
    bad = []
    if cfg.distill.distill != "moma":
        bad.append(f"--distill {cfg.distill.distill} (KD zoo, Queue 1 item 4)")
    if m.mem not in MEMS:
        bad.append(f"--mem {m.mem} (known: {MEMS})")
    if m.head not in HEADS:
        bad.append(f"--head {m.head} (known: {HEADS})")
    if m.attn not in ATTN_MODES:
        bad.append(f"--attn {m.attn} (known: {ATTN_MODES})")
    if cfg.model_t is None:
        bad.append("MoMA without a teacher")
    for mc in (cfg.model_s, cfg.model_t):
        if mc is not None and mc.name not in available_models():
            bad.append(f"model {mc.name} (the model zoo, Queue 1 item 3)")
    if r.bn != "global":
        bad.append(f"--bn {r.bn} (multi-GPU, Queue 1 item 5)")
    if r.grad_accum > 1:
        bad.append("--grad_accum > 1 (Queue 1 item 5)")
    if r.model_parallel > 1 or r.sequence_parallel or r.pp_microbatch:
        bad.append("--model_parallel / --sequence_parallel / "
                   "--pp_microbatch (Queue 1 items 5-6)")
    if m.teacher_quant != "none":
        bad.append("--teacher_quant (Queue 1 item 6)")
    if r.remat:
        bad.append("--remat (BN running statistics under recompute need "
                   "their own design)")
    if bad:
        raise NotImplementedError(
            "not ported to moma_tpu_torch yet (see ROADMAP.md): "
            + "; ".join(bad))


def student_parser() -> argparse.ArgumentParser:
    """The flags scripts/run_moma.sh passes to train_student, plus the
    port's --fp32 / --device and the switches check_slice rejects (so a
    reference command line fails loudly, not silently).  Flags of
    moma_tpu that the port would accept and ignore (--num_workers,
    --nce_m) are left out, so argparse refuses them.  --synthetic is taken
    by the CLI (cli/train_student.py), as in moma_tpu."""
    p = argparse.ArgumentParser("moma_tpu_torch train_student")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
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
                   help="root of the run directories "
                        "(<save_dir>/moma_<run name>)")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--skip_validation", action="store_true",
                   help="run a pre-flight eval of the teacher on the test "
                        "split before training (the reference's inverted "
                        "store_false flag: passing it RUNS the validation)")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; an error if absent) "
                        "or cpu")
    p.add_argument("--bn", type=str, default="global",
                   choices=["global", "local", "sync"])
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue from <run dir>/ckpt/latest.pt")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch")
    p.add_argument("--n_cls", type=int, default=0)
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
    p.add_argument("--feat_dim", type=int, default=512)
    p.add_argument("--nce_k", type=int, default=16384)
    p.add_argument("--nce_t", type=float, default=0.07)
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
    cfg = Config()
    cfg.data = DataConfig(
        dataset=a.dataset, data_dir=a.data_dir, batch_size=a.batch_size,
        image_size=a.image_size, image_resize=a.image_resize, crop=a.crop,
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
        bn=a.bn, model_parallel=a.model_parallel, grad_accum=a.grad_accum,
        remat=a.remat, resume=a.resume, profile_dir=a.profile_dir,
        device=a.device)
    cfg.model_s = ModelConfig(name=a.model_s, pretrain=a.std_pre,
                              strict=a.std_strict)
    cfg.model_t = ModelConfig(name=a.model_t, pretrain=a.path_t or a.tec_pre,
                              strict=a.tec_strict)
    cfg.distill = DistillConfig(distill=a.distill, kd_T=a.kd_T, cls=a.cls,
                                div=a.div, beta=a.beta)
    cfg.moma = MomaConfig(
        feat_dim=a.feat_dim, nce_k=a.nce_k, nce_t=a.nce_t, alpha=a.alpha,
        mem=a.mem, head=a.head, attn=a.attn,
        shuffle_bn=not a.no_shuffle_bn, kl_teacher_bn=a.kl_teacher_bn,
        fast_teacher=a.fast_teacher, fused_teacher=a.fused_teacher,
        teacher_quant=a.teacher_quant)
    cfg = cfg.finalize()
    if a.n_cls:
        cfg.model_s.n_cls = a.n_cls
        cfg.model_t.n_cls = a.n_cls
    check_slice(cfg)
    return cfg
