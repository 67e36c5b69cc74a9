"""Ring attention for the CMO batch-token attention over a negative bank
split across the model ranks.

Counterpart of moma_tpu/ops/ring_attention.py (`ring_batch_token_attention`
:138-278).  The MoCoAtt queue-consuming modes attend over [q; k; queue]; with
the bank split by rows over the model axis (core/mesh.model_axis) this
attends without any rank holding the whole bank, raw or transformed:

  tokens   [x_rep: Nb rows every model rank holds] + [x_loc: this rank's
           Ksh bank rows]
  queries  the local tokens (Nb + Ksh)
  keys     every token: x_rep's and this rank's rows at home, counted
           once, then the other ranks' (Ksh, d) key / value shards, one
           ring hop (model_axis.ppermute) at a time

Each piece of attention is one call of the flash wrappers of
ops/flash_attention.py: `flash_fwd` on the forward, `flash_dq` and
`flash_dkv` on the backward.  On a CUDA tensor they launch the hand-written
kernels (csrc/flash_attention.cu), on a CPU tensor their plain versions;
there is no other switch.  The schedule is JAX's:

  forward   hop 0: the local queries against [k_rep; k_loc]; then MP-1
            hops, each the visiting shard.  The hops' normalized outputs
            merge by online softmax in float32 (o * l rescaled to the new
            row max), so the final (o, m, l) are those of one pass over
            every key.
  backward  the query-side block (qs, dO, final m, l, delta and the
            travelling dq) goes round the ring while the key shards stay
            home: at each hop `flash_dkv` adds into the home shard's
            dk / dv and `flash_dq` into the travelling dq; a last hop brings
            dq home.  Hop 0 also takes the replicated keys (JAX's pass 1).
            The replicated query rows sit in every rank's block, so their
            deposits into a key shard would count MP times: their dO and
            delta are scaled by 1/MP for the dk / dv products only (JAX's
            row_scale), which scales p * dO and ds alike.

Gradient convention (the sharded step's, queue.sharded_queue_logits_t):
the cotangent of out_rep arrives full and alike on every model rank, that
of out_loc as the true per-shard one.  The contributions that flow
through the shard rows vary by rank, so they are psummed over the model
axis here (:189-278): dW_qkv, dW_proj, the biases and the replicated
block's dk / dv, in one flat all_reduce a dtype.  The ring order differs
by rank, so the ranks' results agree only up to float reassociation; the
MoMA step pmeans the ring modes' gradients over the model axis.

As in ops/flash_attention.py the query is scaled in the input dtype
before `flash_fwd` (qs = q * hd^-0.5) and dq = dqs * scale after
`flash_dq`; delta = rowsum(dO * o) is float32 from the merged output.  The
projections are plain matrix products in the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from moma_tpu_torch.ops.flash_attention import flash_dkv, flash_dq, flash_fwd


def _heads(t: torch.Tensor, n: int, H: int, hd: int) -> torch.Tensor:
    """(n, 3C) -> (3, H, n, hd)."""
    return t.reshape(n, 3, H, hd).permute(1, 2, 0, 3)


def _merge_heads(dq, dk, dv, n: int, C: int) -> torch.Tensor:
    """(H, n, hd) x 3 -> (n, 3C), the layout of the qkv product."""
    return torch.stack([dq, dk, dv]).permute(2, 0, 1, 3).reshape(n, 3 * C)


def _down_weighted(do, delta, nb: int, mp: int):
    """dO and delta with the first nb (replicated) query rows scaled by
    1/mp: the dk / dv products' row weight."""
    if nb == 0 or mp == 1:
        return do, delta
    do_s, delta_s = do.clone(), delta.clone()
    do_s[:, :nb] *= 1.0 / mp
    delta_s[:, :nb] *= 1.0 / mp
    return do_s, delta_s


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_rep, x_loc, qkv_kernel, qkv_bias, proj_kernel,
                proj_bias, num_heads, axis):
        mp = axis.size
        nb, C = x_rep.shape
        ksh = x_loc.shape[0]
        H, hd = num_heads, C // num_heads
        dt = x_loc.dtype
        w_qkv = qkv_kernel.to(dt)

        def project(x):
            qkv = x @ w_qkv
            if qkv_bias is not None:
                qkv = qkv + qkv_bias.to(dt)
            return _heads(qkv, x.shape[0], H, hd)

        q_rep, k_rep, v_rep = project(x_rep.to(dt))
        q_loc, k_loc, v_loc = project(x_loc)
        qs = (torch.cat([q_rep, q_loc], 1) * hd ** -0.5).contiguous()
        kv_loc = torch.stack([k_loc, v_loc]).contiguous()  # (2, H, Ksh, hd)
        kv_home = torch.stack([torch.cat([k_rep, k_loc], 1),
                               torch.cat([v_rep, v_loc], 1)]).contiguous()
        o, m, l = flash_fwd(qs, kv_home[0], kv_home[1])
        o32 = o.float()
        del kv_home
        vis = kv_loc
        for _ in range(1, mp):
            vis = axis.ppermute([vis])[0]
            o_h, m_h, l_h = flash_fwd(qs, vis[0], vis[1])
            m_new = torch.maximum(m, m_h)
            a = torch.exp(m - m_new) * l
            b = torch.exp(m_h - m_new) * l_h
            l = a + b
            o32 = (o32 * a + o_h.float() * b) / l
            m = m_new
        del vis
        y = o32.to(dt).permute(1, 0, 2).reshape(nb + ksh, C)
        out = y @ proj_kernel.to(dt) + proj_bias.to(dt)
        ctx.save_for_backward(x_rep, x_loc, qkv_kernel, proj_kernel, qs,
                              kv_loc, torch.stack([k_rep, v_rep]), o32, m,
                              l, y)
        ctx.axis, ctx.H = axis, H
        ctx.dtypes = (None if qkv_bias is None else qkv_bias.dtype,
                      proj_bias.dtype)
        return out[:nb], out[nb:]

    @staticmethod
    def backward(ctx, g_rep, g_loc):
        (x_rep, x_loc, qkv_kernel, proj_kernel, qs, kv_loc, kv_rep, o32, m,
         l, y) = ctx.saved_tensors
        axis, H = ctx.axis, ctx.H
        mp = axis.size
        nb, C = x_rep.shape
        ksh = x_loc.shape[0]
        hd = C // H
        scale = hd ** -0.5
        dt = x_loc.dtype
        g_rep, g_loc = g_rep.to(dt), g_loc.to(dt)
        g = torch.cat([g_rep, g_loc], 0)

        # out-projection; the shard rows' parts are psummed below
        d_proj_rep = y[:nb].t() @ g_rep
        d_proj_loc = y[nb:].t() @ g_loc
        dy = g @ proj_kernel.to(dt).t()
        do = dy.reshape(nb + ksh, H, hd).permute(1, 0, 2).contiguous()
        delta = (do.float() * o32).sum(-1, keepdim=True)

        # hop 0: the home block against the replicated keys and the home
        # shard (JAX's pass 1 and the ring's first step)
        k_home = torch.cat([kv_rep[0], kv_loc[0]], 1).contiguous()
        v_home = torch.cat([kv_rep[1], kv_loc[1]], 1).contiguous()
        dqs = flash_dq(qs, k_home, v_home, do, m, l, delta)
        do_s, delta_s = _down_weighted(do, delta, nb, mp)
        dk_home, dv_home = flash_dkv(qs, k_home, v_home, do_s, m, l, delta_s)
        del k_home, v_home
        dkb, dk_loc = dk_home[:, :nb], dk_home[:, nb:]
        dvb, dv_loc = dv_home[:, :nb], dv_home[:, nb:]
        k_loc, v_loc = kv_loc[0], kv_loc[1]
        # hops 1..MP-1: the other ranks' query blocks visit the home shard
        blk = [qs, do, m, l, delta, dqs]
        for _ in range(1, mp):
            blk = axis.ppermute(blk)
            b_qs, b_do, b_m, b_l, b_delta, b_dq = blk
            b_dq = b_dq + flash_dq(b_qs, k_loc, v_loc, b_do, b_m, b_l,
                                   b_delta)
            b_do_s, b_delta_s = _down_weighted(b_do, b_delta, nb, mp)
            dk_c, dv_c = flash_dkv(b_qs, k_loc, v_loc, b_do_s, b_m, b_l,
                                   b_delta_s)
            dk_loc = dk_loc + dk_c
            dv_loc = dv_loc + dv_c
            blk = [b_qs, b_do, b_m, b_l, b_delta, b_dq]
        # the last hop brings this rank's dq home
        dqs = axis.ppermute([blk[5]])[0] if mp > 1 else blk[5]
        dQ = dqs * scale

        ct_loc = _merge_heads(dQ[:, nb:], dk_loc, dv_loc, ksh, C).to(dt)
        ct_rep_q = _merge_heads(dQ[:, :nb], torch.zeros_like(dkb),
                                torch.zeros_like(dvb), nb, C).to(dt)
        ct_rep_kv = _merge_heads(torch.zeros_like(dkb), dkb, dvb, nb,
                                 C).to(dt)
        x_rep_dt = x_rep.to(dt)
        # every rank-varying part in one psum: the replicated keys' dk / dv
        # (from this rank's queries) and the shard rows' parameter parts
        d_qkv_var = x_loc.t() @ ct_loc + x_rep_dt.t() @ ct_rep_kv
        d_qkvb_var = ct_loc.sum(0) + ct_rep_kv.sum(0)
        d_projb_loc = g_loc.sum(0)
        axis.psum_([ct_rep_kv, d_qkv_var, d_qkvb_var, d_proj_loc,
                    d_projb_loc])
        ct_rep = ct_rep_q + ct_rep_kv
        w_qkv_t = qkv_kernel.to(dt).t()
        bdt, pbdt = ctx.dtypes
        d_qkv_kernel = (x_rep_dt.t() @ ct_rep_q + d_qkv_var).to(
            qkv_kernel.dtype)
        d_qkv_bias = ((ct_rep_q.sum(0) + d_qkvb_var).to(bdt)
                      if bdt is not None else None)
        d_proj_kernel = (d_proj_rep + d_proj_loc).to(proj_kernel.dtype)
        d_proj_bias = (g_rep.sum(0) + d_projb_loc).to(pbdt)
        d_x_rep = (ct_rep @ w_qkv_t).to(x_rep.dtype)
        d_x_loc = ct_loc @ w_qkv_t if ctx.needs_input_grad[1] else None
        return (d_x_rep, d_x_loc, d_qkv_kernel, d_qkv_bias, d_proj_kernel,
                d_proj_bias, None, None)


def ring_batch_token_attention(x_rep: torch.Tensor, x_loc: torch.Tensor,
                               qkv_kernel: torch.Tensor,
                               qkv_bias: Optional[torch.Tensor],
                               proj_kernel: torch.Tensor,
                               proj_bias: torch.Tensor, num_heads: int,
                               axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchTokenAttention (moma/cmo.py) over the tokens [x_rep (Nb rows
    alike on every model rank, may be empty); x_loc (this rank's Ksh rows)]
    -> (out_rep, out_loc), out_loc this rank's rows.  Kernels are
    (in, out), as in the JAX package; differentiable in every tensor."""
    return _RingAttention.apply(x_rep, x_loc, qkv_kernel, qkv_bias,
                                proj_kernel, proj_bias, num_heads, axis)
