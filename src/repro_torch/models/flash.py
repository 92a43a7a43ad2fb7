"""Blocked flash attention with a backward that recomputes, on torch.

Port of ``repro/models/flash.py``: double-blocked online softmax over
(query block x key block) tiles, in f32, with GQA, causal masking,
sliding windows and a gemma2-style score softcap.  It is not a Pallas
kernel in the reference (plain jnp over ``lax.map`` / ``lax.scan``), so
plain torch over the same blocks is its counterpart; the loops become
Python loops.

The reference's ``jax.custom_vjp`` becomes ``_Flash``, a
``torch.autograd.Function``: it saves only q, k, v, out and the
softmax's row max m and sum l (O(S) memory) and its backward recomputes
each block's scores (``_bwd_impl``), never the (S x S) probabilities.
The window is a plain int and takes no gradient (the reference returns a
zero cotangent for it).  Without autograd recording (serving), the
forward runs alone and nothing is saved.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG = -1e30


def _mask(qpos, kpos, causal, window):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _fwd_impl(q, k, v, window, causal, softcap, block_q, block_kv):
    """(out (B, Sq, H, hd) in q's dtype, m, l (B, K, G, Sq) f32)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    nq, nkv = Sq // block_q, Skv // block_kv
    scale = hd ** -0.5
    dev = q.device
    qb = q.reshape(B, nq, block_q, K, G, hd)
    kb = k.reshape(B, nkv, block_kv, K, hd)
    vb = v.reshape(B, nkv, block_kv, K, hd)
    outs, ms, ls = [], [], []
    for iq in range(nq):
        qg = qb[:, iq].to(F32)
        qpos = iq * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, K, G, block_q), NEG, dtype=F32, device=dev)
        l = torch.zeros((B, K, G, block_q), dtype=F32, device=dev)
        acc = torch.zeros((B, K, G, block_q, hd), dtype=F32, device=dev)
        for jk in range(nkv):
            kpos = jk * block_kv + torch.arange(block_kv, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg,
                             kb[:, jk].to(F32)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(_mask(qpos, kpos, causal, window), s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vb[:, jk].to(F32))
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))  # (B, bq, K, G, hd)
        ms.append(m)
        ls.append(l)
    out = torch.stack(outs, 1).reshape(B, Sq, H, hd).to(q.dtype)
    return out, torch.cat(ms, -1), torch.cat(ls, -1)


def _bwd_impl(q, k, v, out, m, l, dout, window, causal, softcap,
              block_q, block_kv):
    """(dq, dk, dv) in the dtypes of q, k, v.  Per (query block, key
    block) tile: p = exp(s - m) / max(l, 1e-30) from the recomputed
    scores, dp = dout . v, ds = p (dp - D) with D = rowsum(dout * out),
    times softcap's derivative 1 - tanh^2, 0 where masked; dk and dv
    accumulate over query blocks in f32."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    nq, nkv = Sq // block_q, Skv // block_kv
    scale = hd ** -0.5
    dev = q.device
    do = dout.to(F32).reshape(B, Sq, K, G, hd)
    of = out.to(F32).reshape(B, Sq, K, G, hd)
    D = torch.einsum("bskgh,bskgh->bkgs", do, of)  # (B, K, G, Sq)
    qb = q.reshape(B, nq, block_q, K, G, hd)
    dob = do.reshape(B, nq, block_q, K, G, hd)
    kb = k.reshape(B, nkv, block_kv, K, hd)
    vb = v.reshape(B, nkv, block_kv, K, hd)
    dk = torch.zeros((B, nkv, block_kv, K, hd), dtype=F32, device=dev)
    dv = torch.zeros((B, nkv, block_kv, K, hd), dtype=F32, device=dev)
    dqs = []
    for iq in range(nq):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        qg, doi = qb[:, iq].to(F32), dob[:, iq]
        mi, Di = m[..., qs], D[..., qs]
        li_safe = torch.clamp(l[..., qs], min=1e-30)
        qpos = iq * block_q + torch.arange(block_q, device=dev)
        dq_i = torch.zeros((B, block_q, K, G, hd), dtype=F32, device=dev)
        for jk in range(nkv):
            kpos = jk * block_kv + torch.arange(block_kv, device=dev)
            kjf, vjf = kb[:, jk].to(F32), vb[:, jk].to(F32)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, kjf) * scale
            if softcap:
                t = torch.tanh(s / softcap)
                s = t * softcap
            msk = _mask(qpos, kpos, causal, window)
            s = torch.where(msk, s, NEG)
            p = torch.exp(s - mi[..., None]) / li_safe[..., None]
            dp = torch.einsum("bqkgh,bskh->bkgqs", doi, vjf)
            ds = p * (dp - Di[..., None])
            if softcap:
                ds = ds * (1.0 - t * t)
            ds = torch.where(msk, ds, 0.0)
            dq_i = dq_i + torch.einsum("bkgqs,bskh->bqkgh", ds, kjf) * scale
            dk[:, jk] += torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
            dv[:, jk] += torch.einsum("bkgqs,bqkgh->bskh", p, doi)
        dqs.append(dq_i)
    dq = torch.stack(dqs, 1).reshape(B, Sq, H, hd)
    return (dq.to(q.dtype), dk.reshape(B, Skv, K, hd).to(k.dtype),
            dv.reshape(B, Skv, K, hd).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` / ``_fa_fwd`` / ``_fa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, softcap, block_q, block_kv):
        out, m, l = _fwd_impl(q, k, v, window, causal, softcap, block_q,
                              block_kv)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.static = (window, causal, softcap, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, out, m, l, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None, None


def _pick_block(s: int, target: int) -> int:
    if s <= target:
        return s
    for b in range(target, 127, -1):
        if s % b == 0:
            return b
    return 0  # no usable block size


def flash_attention(q, k, v, *, window=0, causal=True, softcap=0.0,
                    block_q=512, block_kv=1024):
    """q: (B, Sq, H, hd); k/v: (B, Skv, K, hd); window: int (<=0
    disables).  Returns (B, Sq, H, hd)."""
    bq = _pick_block(q.shape[1], block_q)
    bkv = _pick_block(k.shape[1], block_kv)
    if not bq or not bkv:
        raise ValueError(f"no block size for Sq={q.shape[1]} Skv={k.shape[1]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, int(window), causal, softcap, bq, bkv)
    out, _, _ = _fwd_impl(q, k, v, int(window), causal, softcap, bq, bkv)
    return out


def flash_ok(q_len: int, kv_len: int) -> bool:
    return bool(_pick_block(q_len, 512)) and bool(_pick_block(kv_len, 1024))
