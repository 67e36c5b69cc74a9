"""Stateless KD losses over NHWC feature maps.

Counterpart of moma_tpu/losses/functional.py, function by function and
with its names: the CE / KD pair and `l2_normalize` the MoMA step uses,
and the loss zoo of the comparison distillers (train/distill.py).  Feature
maps are NHWC, as the port's backbones return them (moma_tpu_torch.models:
permuted views of channels_last tensors), so every reshape and reduction
below is the JAX function's.  Each loss computes in float32 whatever its
inputs' dtype; `.detach()` stands where the JAX function stops gradients.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------- CE / KD

def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean softmax cross-entropy (f32) over the valid rows (:21)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is not None:
        m = mask.to(nll.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def kd_kl(logits_s: Tensor, logits_t: Tensor, T: float = 4.0) -> Tensor:
    """Hinton KD: T^2-scaled KL(p_t || p_s), batch-mean (:31)."""
    logp_s = F.log_softmax(logits_s.float() / T, dim=-1)
    logp_t = F.log_softmax(logits_t.float() / T, dim=-1)
    p_t = torch.exp(logp_t)
    kl = (p_t * (logp_t - logp_s)).sum(-1)
    return kl.mean() * (T ** 2)


# ------------------------------------------------------------ spatial utils

def adaptive_avg_pool_nhwc(x: Tensor, out_h: int,
                           out_w: Optional[int] = None) -> Tensor:
    """F.adaptive_avg_pool2d on NHWC (:46): output i averages rows
    [floor(i*H/out), ceil((i+1)*H/out))."""
    if out_w is None:
        out_w = out_h
    B, H, W, C = x.shape
    if H == out_h and W == out_w:
        return x
    if H % out_h == 0 and W % out_w == 0:
        return x.reshape(B, out_h, H // out_h, out_w, W // out_w, C).mean(
            (2, 4))
    rows = [(i * H // out_h, -(-((i + 1) * H) // out_h)) for i in range(out_h)]
    cols = [(j * W // out_w, -(-((j + 1) * W) // out_w)) for j in range(out_w)]
    out = []
    for r0, r1 in rows:
        strip = x[:, r0:r1].mean(1)
        out.append(torch.stack([strip[:, c0:c1].mean(1) for c0, c1 in cols],
                               1))
    return torch.stack(out, 1)


def _match_spatial(f_s: Tensor, f_t: Tensor):
    """Pool the larger map down to the smaller (:78)."""
    s_H, t_H = f_s.shape[1], f_t.shape[1]
    if s_H > t_H:
        f_s = adaptive_avg_pool_nhwc(f_s, t_H, f_t.shape[2])
    elif s_H < t_H:
        f_t = adaptive_avg_pool_nhwc(f_t, s_H, f_s.shape[2])
    return f_s, f_t


def l2_normalize(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """x / max(||x||, eps) (torch F.normalize semantics; :88)."""
    n = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


# ------------------------------------------------------------------ losses

def hint_mse(f_s: Tensor, f_t: Tensor) -> Tensor:
    """FitNet hint loss: plain MSE (:96)."""
    return ((f_s.float() - f_t.float()) ** 2).mean()


def _at_map(f: Tensor, p: int = 2) -> Tensor:
    """L2-normalized flat channel-mean of f^p (:105)."""
    a = (f.float() ** p).mean(-1)
    return l2_normalize(a.reshape(a.shape[0], -1), dim=-1)


def attention_transfer(g_s: Sequence[Tensor], g_t: Sequence[Tensor],
                       p: int = 2) -> Tensor:
    """AT loss summed over the layer pairs (:116)."""
    total = 0.0
    for f_s, f_t in zip(g_s, g_t):
        f_s, f_t = _match_spatial(f_s, f_t)
        total = total + ((_at_map(f_s, p) - _at_map(f_t, p)) ** 2).mean()
    return total


def similarity_preserving(g_s: Sequence[Tensor],
                          g_t: Sequence[Tensor]) -> Tensor:
    """SP loss: row-normalized Gram matrices, squared difference summed
    over b^2 (:127)."""
    total = 0.0
    for f_s, f_t in zip(g_s, g_t):
        b = f_s.shape[0]
        fs = f_s.float().reshape(b, -1)
        ft = f_t.float().reshape(b, -1)
        Gs = l2_normalize(fs @ fs.T, dim=1)
        Gt = l2_normalize(ft @ ft.T, dim=1)
        total = total + ((Gt - Gs) ** 2).sum() / (b * b)
    return total


def nst_loss(g_s: Sequence[Tensor], g_t: Sequence[Tensor]) -> Tensor:
    """NST poly-kernel MMD, channels L2-normalized over HW (:141)."""
    total = 0.0
    for f_s, f_t in zip(g_s, g_t):
        f_s, f_t = _match_spatial(f_s, f_t)
        B = f_s.shape[0]
        fs = f_s.float().permute(0, 3, 1, 2).reshape(B, f_s.shape[-1], -1)
        ft = f_t.float().permute(0, 3, 1, 2).reshape(B, f_t.shape[-1], -1)
        fs = l2_normalize(fs, dim=2)
        ft = l2_normalize(ft, dim=2)
        G_ss = torch.einsum("bik,bjk->bij", fs, fs)
        G_st = torch.einsum("bik,bjk->bij", fs, ft)
        total = total + (G_ss ** 2).mean() - 2 * (G_st ** 2).mean()
    return total


def _pdist(e: Tensor, eps: float = 1e-12) -> Tensor:
    """Pairwise distances, squares clamped, diagonal zero (:166)."""
    sq = (e * e).sum(1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2 * (e @ e.T), min=eps)
    d = torch.sqrt(d2)
    return d * (1.0 - torch.eye(e.shape[0], dtype=d.dtype, device=d.device))


def _smooth_l1(x: Tensor, y: Tensor) -> Tensor:
    diff = (x - y).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean()


def rkd_loss(f_s: Tensor, f_t: Tensor, w_d: float = 25.0,
             w_a: float = 50.0) -> Tensor:
    """Relational KD: distance and angle terms (:181)."""
    B = f_s.shape[0]
    s = f_s.float().reshape(B, -1)
    t = f_t.float().reshape(B, -1)

    def normed(d):
        return d / (d.sum() / torch.clamp((d > 0).sum(), min=1))

    loss_d = _smooth_l1(normed(_pdist(s)), normed(_pdist(t).detach()))

    def angles(e):
        diff = e[None, :, :] - e[:, None, :]
        # the i == j rows are zero: rsqrt(0 + 1e-24) keeps the gradient
        # finite, as the JAX function does
        nd = diff * torch.rsqrt((diff * diff).sum(2, keepdim=True) + 1e-24)
        return torch.einsum("ijd,ikd->ijk", nd, nd).reshape(-1)

    loss_a = _smooth_l1(angles(s), angles(t).detach())
    return w_d * loss_d + w_a * loss_a


def pkt_loss(f_s: Tensor, f_t: Tensor, eps: float = 1e-7) -> Tensor:
    """Probabilistic knowledge transfer (:206)."""
    B = f_s.shape[0]
    s = f_s.float().reshape(B, -1)
    t = f_t.float().reshape(B, -1)
    s = torch.nan_to_num(s / (torch.linalg.vector_norm(s, dim=1,
                                                       keepdim=True) + eps))
    t = torch.nan_to_num(t / (torch.linalg.vector_norm(t, dim=1,
                                                       keepdim=True) + eps))
    sim_s = (s @ s.T + 1.0) / 2.0
    sim_t = (t @ t.T + 1.0) / 2.0
    sim_s = sim_s / sim_s.sum(1, keepdim=True)
    sim_t = sim_t / sim_t.sum(1, keepdim=True)
    return (sim_t * torch.log((sim_t + eps) / (sim_s + eps))).mean()


def cc_loss(e_s: Tensor, e_t: Tensor) -> Tensor:
    """Correlation congruence: consecutive-row product of |e_s - e_t|
    (:222)."""
    delta = (e_s.float() - e_t.float()).abs()
    return (delta[:-1] * delta[1:]).sum(1).mean()


def fsp_loss(g_s: Sequence[Tensor], g_t: Sequence[Tensor]) -> Tensor:
    """FSP-matrix distillation over consecutive map pairs (:229)."""

    def fsp_mats(g):
        mats = []
        for bot, top in zip(g[:-1], g[1:]):
            bot, top = _match_spatial(bot, top)
            B = bot.shape[0]
            bo = bot.float().reshape(B, -1, bot.shape[-1])
            to = top.float().reshape(B, -1, top.shape[-1])
            mats.append(torch.einsum("bhi,bhj->bij", to, bo) / bo.shape[1])
        return mats

    total = 0.0
    for s, t in zip(fsp_mats(g_s), fsp_mats(g_t)):
        total = total + ((s - t) ** 2).mean()
    return total


def ft_loss(factor_s: Tensor, factor_t: Tensor, p2: int = 1) -> Tensor:
    """Factor transfer over factor maps (:248)."""
    d = factor_s - factor_t
    if p2 == 1:
        return d.abs().mean()
    return (d ** p2).mean()


def ft_factor(f: Tensor, p1: int = 2) -> Tensor:
    """FT factor: the attention map of f^p1 (:257)."""
    return _at_map(f, p1)


def ab_loss(g_s: Sequence[Tensor], g_t: Sequence[Tensor],
            margin: float = 1.0) -> Tensor:
    """Activation-boundary loss, weighted over the layers (:262)."""
    n = len(g_s)
    total = 0.0
    bsz = g_s[0].shape[0]
    for i, (s, t) in enumerate(zip(g_s, g_t)):
        s, t = s.float(), t.float()
        l = ((s + margin) ** 2 * ((s > -margin) & (t <= 0)).float()
             + (s - margin) ** 2 * ((s <= margin) & (t > 0)).float())
        w = 2.0 ** (i - n + 1)
        total = total + w * l.abs().sum() / bsz / 1000.0 * 3.0
    return total


def canonical_signs(v: Tensor) -> Tensor:
    """The columns of v (..., C, r) flipped so that each one's entry of
    largest magnitude is positive."""
    pick = v.abs().argmax(-2, keepdim=True)
    sign = torch.sign(v.gather(-2, pick))
    return v * torch.where(sign == 0, torch.ones_like(sign), sign)


def kdsvd_loss(g_s: Sequence[Tensor], g_t: Sequence[Tensor],
               k: int = 1) -> Tensor:
    """SVD-subspace RBF distillation (:278): the right-singular vectors of
    each (B, HW, C) map, k for the teacher and k + 3 for the student, the
    student's sign-aligned to the teacher's by the largest |cos|, both
    scaled by the teacher's singular values, consecutive layers compared
    through an RBF gram.

    A singular vector's sign is arbitrary, and the teacher's is not
    aligned: the loss depends on it.  LAPACK, cuSOLVER and the JAX
    package's SVD each pick their own, so here each right-singular vector
    is flipped to make its largest-magnitude entry positive
    (`canonical_signs`), the same on every device."""

    def svd_vs(feat, n):
        B, H, W, C = feat.shape
        x = feat.float().reshape(B, H * W, C)
        _, s, vh = torch.linalg.svd(x, full_matrices=False)
        v = canonical_signs(vh.transpose(-2, -1))
        s, v = torch.nan_to_num(s), torch.nan_to_num(v)
        if n > 0:
            s = l2_normalize(s[:, :n], dim=1)
            v = l2_normalize(v[:, :, :n], dim=1)
        return s, v

    def align(a, b):
        cos = torch.einsum("bij,bik->bjk", a, b)
        max_abs = cos.abs().amax(1, keepdim=True)
        mask = torch.where(cos.abs() == max_abs, torch.sign(cos),
                           torch.zeros_like(cos))
        return torch.einsum("bij,bjk->bik", a, mask)

    losses = []
    v_sb = v_tb = None
    for i, (f_s, f_t) in enumerate(zip(g_s, g_t)):
        s_t, v_t = svd_vs(f_t, k)
        _, v_s = svd_vs(f_s, k + 3)
        v_s = align(v_s, v_t)
        v_t = v_t * s_t[:, None, :]
        v_s = v_s * s_t[:, None, :]
        if i > 0:
            s_rbf = torch.exp(-((v_s[:, :, None, :] - v_sb[:, None, :, :]) ** 2)
                              / 8)
            t_rbf = torch.exp(-((v_t[:, :, None, :] - v_tb[:, None, :, :]) ** 2)
                              / 8)
            l2 = (s_rbf - t_rbf.detach()) ** 2
            l2 = torch.where(torch.isfinite(l2), l2, torch.zeros_like(l2))
            losses.append(l2.sum())
        v_sb, v_tb = v_s, v_t
    bsz = g_s[0].shape[0]
    return sum(l / bsz for l in losses)


def vid_loss(pred_mean: Tensor, target: Tensor, log_scale: Tensor,
             eps: float = 1e-5) -> Tensor:
    """VID negative log-probability; pred_var = softplus(log_scale) + eps
    per channel, broadcast on the last axis (:328)."""
    pred_var = (torch.log1p(torch.exp(log_scale)) + eps).reshape(1, 1, 1, -1)
    neg_log_prob = 0.5 * ((pred_mean - target) ** 2 / pred_var
                          + torch.log(pred_var))
    return neg_log_prob.mean()


def semckd_loss(s_value, f_target, weight: Tensor) -> Tensor:
    """SemCKD attention-weighted pairwise MSE (:342); s_value / f_target
    are [num_stu][num_tea] lists of NHWC maps, weight (B, S, T)."""
    bsz, num_stu, num_tea = weight.shape
    rows = []
    for i in range(num_stu):
        cols = [((s_value[i][j].float() - f_target[i][j].float()) ** 2)
                .reshape(bsz, -1).mean(-1) for j in range(num_tea)]
        rows.append(torch.stack(cols, -1))
    ind_loss = torch.stack(rows, 1)
    return (weight * ind_loss).sum() / (1.0 * bsz * num_stu)
