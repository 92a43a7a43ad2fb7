"""Shared neural building blocks, forward only, on torch.

Port of ``repro/models/layers.py``.  Attention comes in three flavours:

  * ``flash.flash_attention`` — blocked online-softmax forward (prefill
    at S >= 1024, chosen by ``attend``).
  * ``attend_full`` — plain einsum path for short sequences.
  * ``attend_decode`` — single-token query against a KV cache (the plain
    route for layers with a sliding window or a score softcap; other
    layers decode through ``kernels/decode_attention``).

Scores are taken in f32 (the reference's ``preferred_element_type``:
bf16 inputs are upcast exactly, so only the summation order differs).
Norms and rope compute in f32 and cast back, as the reference does.  The
cross-entropy functions belong to training and are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30

# ----------------------------------------------------------------- norms


def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def l2_head_norm(x, scale, eps=1e-6):
    """qk-norm (qwen3): RMS-norm over head_dim with learned scale."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


# ----------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None):
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return theta ** (-ar / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    rotation is split-half (first half against second), in f32."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- masks


def _softcap(scores, cap: float):
    if cap and cap > 0:
        return torch.tanh(scores / cap) * cap
    return scores


def _window_mask(qpos, kpos, window):
    """True where key ``kpos`` is within ``window`` of query ``qpos``
    (everywhere when ``window <= 0``)."""
    if window <= 0:
        return torch.ones((), dtype=torch.bool, device=qpos.device)
    return qpos - kpos < window


# ----------------------------------------------------------------- attention


def attend_full(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, Sq, H, hd), k/v: (B, Skv, K, hd).  GQA via head grouping.
    (The reference's ``q_offset`` / ``kv_positions``, which no caller
    sets, are left out.)"""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    mask &= _window_mask(qpos[:, None], kpos[None, :], window)
    scores = torch.where(mask, scores, NEG)
    p = F.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(B, Sq, H, hd)


BLOCKWISE_THRESHOLD = 1024   # query length from which attend goes blocked


def attend(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The reference's dispatch: the blocked flash forward for long
    sequences whose lengths it can block, else ``attend_full``."""
    from repro_torch.models import flash
    if q.shape[1] >= BLOCKWISE_THRESHOLD and flash.flash_ok(q.shape[1],
                                                            k.shape[1]):
        return flash.flash_attention(q, k, v, window=window, causal=causal,
                                     softcap=softcap)
    return attend_full(q, k, v, causal=causal, window=window, softcap=softcap)


def attend_decode(q, k_cache, v_cache, pos, *, window=0, softcap=0.0):
    """One-token decode.  q: (B, H, hd); caches: (B, S, K, hd);
    pos: (B,) current positions (token being written is at cache[pos])."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    scale = hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None] <= pos[:, None]  # (B, S)
    mask &= _window_mask(pos[:, None], kpos[None], window)
    s = torch.where(mask[:, None, None], s, NEG)
    p = F.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache)
    return out.reshape(B, H, hd)


def scatter_kv(cache, new, pos):
    """Write one token into the cache, in place (the reference returns an
    updated copy: JAX arrays are immutable).  cache: (B, S, K, hd),
    new: (B, K, hd), pos: (B,)."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), pos] = new.to(cache.dtype)
    return cache


# ----------------------------------------------------------------- mlp


def swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


# ----------------------------------------------------------------- logits


def softcap_logits(logits, cap: float):
    return _softcap(logits, cap)
