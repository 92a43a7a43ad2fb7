"""whisper-style encoder-decoder backbone, on torch.

Port of ``repro/models/encdec.py``.  The audio frontend is a stub, as in
the reference: the caller passes frame embeddings (B, enc_seq, d_model).
Positions are sinusoidal.  Decoder layers: causal self-attention with a
KV cache, cross-attention to the encoder output (its K and V computed
once at prefill and cached), and a GELU MLP.

Decode self-attention goes through the CUDA ``decode_attention`` on the
card with ``pos + 1`` valid entries (the dense port's rule: the layers
have no window and no score softcap); decode cross-attention is the
plain ``attend_full`` over all ``enc_seq`` cached entries, as in the
reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.models import layers as L
from repro_torch.models.params import (ParamDef, compute_dtype, layer,
                                       zeros_of)

F32 = torch.float32


def _sinusoid(positions, d):
    """positions: (...,) -> (..., d) f32 sinusoidal embeddings."""
    half = d // 2
    ar = torch.arange(half, dtype=F32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_defs(cfg, Lx, st, prefix=""):
    d, hd = cfg.d_model, cfg.the_head_dim()
    H, K = cfg.n_heads, cfg.n_kv_heads
    return {
        prefix + "norm": ParamDef(Lx + (d,), st + (None,), init="zeros"),
        prefix + "wq": ParamDef(Lx + (d, H * hd), st + ("fsdp", "tp")),
        prefix + "wk": ParamDef(Lx + (d, K * hd), st + ("fsdp", "tp")),
        prefix + "wv": ParamDef(Lx + (d, K * hd), st + ("fsdp", "tp")),
        prefix + "wo": ParamDef(Lx + (H * hd, d), st + ("tp", "fsdp")),
    }


def _mlp_defs(cfg, Lx, st):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": ParamDef(Lx + (d,), st + (None,), init="zeros"),
        "w1": ParamDef(Lx + (d, f), st + ("fsdp", "tp")),
        "w2": ParamDef(Lx + (f, d), st + ("tp", "fsdp")),
    }


def param_defs(cfg: ModelConfig):
    d = cfg.d_model
    Le, Ld = (cfg.n_enc_layers,), (cfg.n_layers,)
    st = (None,)
    enc_blocks = {**_attn_defs(cfg, Le, st), **_mlp_defs(cfg, Le, st)}
    dec_blocks = {**_attn_defs(cfg, Ld, st),
                  **_attn_defs(cfg, Ld, st, prefix="x_"),
                  **_mlp_defs(cfg, Ld, st)}
    return {
        "embed": ParamDef((cfg.vocab_size, d), ("tp", "fsdp")),
        "enc_blocks": enc_blocks,
        "enc_norm": ParamDef((d,), (None,), init="zeros"),
        "dec_blocks": dec_blocks,
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "unembed": ParamDef((d, cfg.vocab_size), ("fsdp", "tp")),
    }


def _heads(cfg, t, n):
    return t.reshape(t.shape[0], t.shape[1], n, cfg.the_head_dim())


def _cross_kv(cfg, p, enc):
    """The cross-attention's K and V from the encoder output."""
    dt0 = enc.dtype
    kvn = L.rms_norm(enc, p["x_norm"], cfg.norm_eps)
    return (_heads(cfg, kvn @ p["x_wk"].to(dt0), cfg.n_kv_heads),
            _heads(cfg, kvn @ p["x_wv"].to(dt0), cfg.n_kv_heads))


def _self_attn(cfg, p, x, *, causal, cache=None, pos=None):
    """Self-attention sub-block; at decode (``cache`` given) the token's K
    and V are written into the cache in place.  -> (x + y, (k, v))."""
    dt0 = x.dtype
    H, K = cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    B, S, _ = h.shape
    q = _heads(cfg, h @ p["wq"].to(dt0), H)
    k = _heads(cfg, h @ p["wk"].to(dt0), K)
    v = _heads(cfg, h @ p["wv"].to(dt0), K)
    if cache is not None:
        kc, vc = cache
        L.scatter_kv(kc, k[:, 0], pos)
        L.scatter_kv(vc, v[:, 0], pos)
        # attend_decode attends to kpos <= pos, the kernel to kpos < its
        # count: the count of valid entries is pos + 1
        out = DA.decode_attention(q[:, 0], kc, vc, pos + 1)[:, None]
        new_cache = cache
    else:
        out = L.attend(q, k, v, causal=causal)
        new_cache = (k, v)
    y = out.reshape(B, S, -1) @ p["wo"].to(dt0)
    return x + y, new_cache


def _cross_attn(cfg, p, x, xk, xv):
    """Cross-attention to cached encoder K/V (no mask): ``attend_full``
    for one query token, as the reference's decode takes it, else
    ``attend``."""
    dt0 = x.dtype
    h = L.rms_norm(x, p["x_norm"], cfg.norm_eps)
    B, S, _ = h.shape
    q = _heads(cfg, h @ p["x_wq"].to(dt0), cfg.n_heads)
    out = (L.attend_full(q, xk, xv, causal=False) if S == 1
           else L.attend(q, xk, xv, causal=False))
    return x + out.reshape(B, S, -1) @ p["x_wo"].to(dt0)


def _mlp(cfg, p, x):
    dt0 = x.dtype
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.gelu_mlp(h, p["w1"].to(dt0), p["w2"].to(dt0))


def encode(cfg, params, frames):
    """frames: (B, enc_seq, d) stub embeddings -> encoder output."""
    dt0 = compute_dtype(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dt0) + _sinusoid(pos, cfg.d_model).to(dt0)[None]
    for l in range(cfg.n_enc_layers):
        p = layer(params["enc_blocks"], l)
        x, _ = _self_attn(cfg, p, x, causal=False)
        x = _mlp(cfg, p, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _embed(cfg, params, tokens, positions):
    dt0 = compute_dtype(cfg)
    return (L.embed(params, tokens, dt0)
            + _sinusoid(positions, cfg.d_model).to(dt0))


def _train_layer(cfg, p, x, enc):
    x, _ = _self_attn(cfg, p, x, causal=True)
    x = _cross_attn(cfg, p, x, *_cross_kv(cfg, p, enc))
    return _mlp(cfg, p, x)


def forward(cfg, params, tokens, *, frames, remat=True, return_hidden=False):
    """Frames and teacher-forced tokens -> (logits (B, S, V) f32, or the
    final normed hidden with ``return_hidden``; aux 0).  ``remat``
    recomputes each decoder layer in the backward (the encoder's are
    kept, as in the reference)."""
    enc = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens,
               torch.arange(S, device=tokens.device)[None])
    for l in range(cfg.n_layers):
        x = L.remat(remat, _train_layer, cfg, layer(params["dec_blocks"], l),
                    x, enc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params, x), aux


def init_cache_abstract(cfg, batch: int, cache_len: int):
    """(k, v, cross k, cross v) as meta tensors: the self-attention's
    (L, B, cache_len, K, hd), the cross-attention's (L, B, enc_seq, K,
    hd)."""
    hd = cfg.the_head_dim()
    dt0 = compute_dtype(cfg)
    Lr = cfg.n_layers
    kv = (Lr, batch, cache_len, cfg.n_kv_heads, hd)
    xkv = (Lr, batch, cfg.enc_seq, cfg.n_kv_heads, hd)
    return tuple(torch.empty(s, dtype=dt0, device="meta")
                 for s in (kv, kv, xkv, xkv))



def cache_logical_spec(cfg, tp_size: int):
    if cfg.n_kv_heads and tp_size and cfg.n_kv_heads % tp_size == 0:
        kv = (None, "batch", None, "tp", None)
        xkv = (None, "batch", None, "tp", None)
    else:
        kv = (None, "batch", "seq", None, None)
        xkv = (None, "batch", None, None, None)
    return (kv, kv, xkv, xkv)

def prefill(cfg, params, tokens, cache_len: int, *, frames):
    """-> (last-token logits (B, 1, V) f32, (k, v, cross k, cross v)),
    zeros in k and v past the prompt."""
    enc = encode(cfg, params, frames)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens,
               torch.arange(S, device=tokens.device)[None])
    kc, vc = zeros_of(init_cache_abstract(cfg, B, cache_len)[:2], x.device)
    xks, xvs = [], []
    for l in range(cfg.n_layers):
        p = layer(params["dec_blocks"], l)
        x, (k, v) = _self_attn(cfg, p, x, causal=True)
        kc[l, :, :S] = k
        vc[l, :, :S] = v
        # the cross K/V are computed once here, and cached for decode
        xk, xv = _cross_kv(cfg, p, enc)
        xks.append(xk)
        xvs.append(xv)
        x = _cross_attn(cfg, p, x, xk, xv)
        x = _mlp(cfg, p, x)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x), (kc, vc, torch.stack(xks), torch.stack(xvs))


def decode_step(cfg, params, cache, tokens, pos):
    """One step; k and v are written in place.  -> (logits (B, V) f32,
    cache)."""
    kc, vc, xk, xv = cache
    x = _embed(cfg, params, tokens[:, None], pos[:, None])
    for l in range(cfg.n_layers):
        p = layer(params["dec_blocks"], l)
        x, _ = _self_attn(cfg, p, x, causal=True, cache=(kc[l], vc[l]),
                          pos=pos)
        x = _cross_attn(cfg, p, x, xk[l], xv[l])
        x = _mlp(cfg, p, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x[:, 0]), cache
