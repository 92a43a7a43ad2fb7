"""Blocked flash-attention forward, on torch.

Port of the forward half of ``repro/models/flash.py``: double-blocked
online softmax over (query block x key block) tiles, in f32, with GQA,
causal masking, sliding windows and a gemma2-style score softcap.  It is
not a Pallas kernel in the reference (plain jnp over ``lax.map`` /
``lax.scan``), so plain torch over the same blocks is its counterpart;
the two loops become Python loops.  The custom-VJP backward belongs to
training and is not ported yet.
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
    out, _, _ = _fwd_impl(q, k, v, int(window), causal, softcap, bq, bkv)
    return out


def flash_ok(q_len: int, kv_len: int) -> bool:
    return bool(_pick_block(q_len, 512)) and bool(_pick_block(kv_len, 1024))
