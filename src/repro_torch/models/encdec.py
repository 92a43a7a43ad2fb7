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

Under a mesh the self- and cross-attention split their heads over
``model`` as ``transformer.attn_tp`` says (column-parallel q/k/v,
row-parallel output), the GELU MLP its ``d_ff`` (``w1`` column-,
``w2`` row-parallel); the self-attention cache lies where
``transformer.kv_layout`` places it, the cross K/V over their heads
where those divide the ranks and whole on every rank otherwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import axis_size
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (ParamDef, compute_dtype, layer,
                                       reduce_model, to_model, zeros_of)

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


def whole_leaves(cfg: ModelConfig, mesh) -> frozenset:
    """Leaves placed over ``model`` whose work does not split here: both
    attentions' when the heads do not divide the ranks (whisper's 6 on
    4)."""
    if tfm.attn_tp(cfg, mesh):
        return frozenset()
    return frozenset(tfm.ATTN_WEIGHTS
                     + tuple("x_" + w for w in tfm.ATTN_WEIGHTS))


def _normed(cfg, x, scale, mesh):
    """The norm of ``x`` entering a model-split attention."""
    h = L.rms_norm(x, scale, cfg.norm_eps)
    return to_model(h, mesh) if tfm.attn_tp(cfg, mesh) else h


def _out(cfg, out, wo, mesh):
    """The attention's output projection (row-parallel under a mesh)."""
    B, S = out.shape[:2]
    y = out.reshape(B, S, -1) @ wo.to(out.dtype)
    return reduce_model(y, mesh) if tfm.attn_tp(cfg, mesh) else y


def _cross_kv(cfg, p, enc, mesh=None):
    """The cross-attention's K and V from the encoder output (this rank's
    kv heads)."""
    kvn = _normed(cfg, enc, p["x_norm"], mesh)
    return tuple(tfm.kv_heads(cfg, kvn, p[w].to(enc.dtype), mesh)
                 for w in ("x_wk", "x_wv"))


def _self_attn(cfg, p, x, *, causal, cache=None, pos=None, mesh=None,
               kv: str = ""):
    """Self-attention sub-block; at decode (``cache`` given) the token's K
    and V are written into the cache in place.  -> (x + y, (k, v))."""
    h = _normed(cfg, x, p["norm"], mesh)
    q, k, v = tfm.qkv(cfg, p, h, mesh, all_kv=cache is not None
                      and tfm.attn_tp(cfg, mesh) and kv != "heads")
    if cache is not None:
        out = tfm.attend_cache(cfg, q, k, v, cache, pos, mesh, kv)
        new_cache = cache
    else:
        out = L.attend(q, k, v, causal=causal)
        new_cache = (k, v)
    return x + _out(cfg, out, p["wo"], mesh), new_cache


def _cross_attn(cfg, p, x, xk, xv, mesh=None):
    """Cross-attention to this rank's encoder K/V heads (no mask):
    ``attend_full`` for one query token, as the reference's decode takes
    it, else ``attend``."""
    h = _normed(cfg, x, p["x_norm"], mesh)
    B, S, _ = h.shape
    q = (h @ p["x_wq"].to(x.dtype)).reshape(B, S, -1, cfg.the_head_dim())
    out = (L.attend_full(q, xk, xv, causal=False) if S == 1
           else L.attend(q, xk, xv, causal=False))
    return x + _out(cfg, out, p["x_wo"], mesh)


def _mlp(cfg, p, x, mesh=None):
    dt0 = x.dtype
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if not tfm.mlp_tp(cfg, mesh):
        return x + L.gelu_mlp(h, p["w1"].to(dt0), p["w2"].to(dt0))
    return x + reduce_model(L.gelu_mlp(to_model(h, mesh), p["w1"].to(dt0),
                                       p["w2"].to(dt0)), mesh)


def encode(cfg, params, frames, mesh=None):
    """frames: (B, enc_seq, d) stub embeddings -> encoder output."""
    dt0 = compute_dtype(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dt0) + _sinusoid(pos, cfg.d_model).to(dt0)[None]
    for l in range(cfg.n_enc_layers):
        p = layer(params["enc_blocks"], l)
        x, _ = _self_attn(cfg, p, x, causal=False, mesh=mesh)
        x = _mlp(cfg, p, x, mesh)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _embed(cfg, params, tokens, positions, mesh=None):
    dt0 = compute_dtype(cfg)
    return (L.embed(params, tokens, dt0, L.vocab_mesh(cfg, mesh))
            + _sinusoid(positions, cfg.d_model).to(dt0))


def _logits(cfg, params, x, mesh=None):
    return L.unembed(params, x, L.vocab_mesh(cfg, mesh))


def _train_layer(cfg, p, x, enc, mesh=None):
    x, _ = _self_attn(cfg, p, x, causal=True, mesh=mesh)
    x = _cross_attn(cfg, p, x, *_cross_kv(cfg, p, enc, mesh), mesh)
    return _mlp(cfg, p, x, mesh)


def forward(cfg, params, tokens, *, frames, remat=True, return_hidden=False,
            mesh=None):
    """Frames and teacher-forced tokens -> (logits (B, S, V) f32, or the
    final normed hidden with ``return_hidden``; aux 0).  ``remat``
    recomputes each decoder layer in the backward (the encoder's are
    kept, as in the reference)."""
    enc = encode(cfg, params, frames, mesh)
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens,
               torch.arange(S, device=tokens.device)[None], mesh)
    for l in range(cfg.n_layers):
        x = L.remat(remat, _train_layer, cfg, layer(params["dec_blocks"], l),
                    x, enc, mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if return_hidden:
        return x, aux
    return _logits(cfg, params, x, mesh), aux


def _xkv_heads(cfg, mesh) -> bool:
    """Whether the cross K/V cache lies over its heads (else whole)."""
    tp = axis_size(mesh, "model")
    return tp > 1 and cfg.n_kv_heads % tp == 0


def init_cache_abstract(cfg, batch: int, cache_len: int, mesh=None):
    """(k, v, cross k, cross v) as meta tensors: the self-attention's
    (L, B, cache_len, K, hd), the cross-attention's (L, B, enc_seq, K,
    hd); with a ``mesh`` this rank's part."""
    kv = tfm.local_cache(cfg, batch, cache_len, mesh,
                         tfm.kv_layout(cfg, mesh, cache_len))
    K = cfg.n_kv_heads
    if _xkv_heads(cfg, mesh):
        K //= axis_size(mesh, "model")
    xkv = (cfg.n_layers, batch, cfg.enc_seq, K, cfg.the_head_dim())
    dt0 = compute_dtype(cfg)
    return kv + tuple(torch.empty(xkv, dtype=dt0, device="meta")
                      for _ in range(2))



def cache_logical_spec(cfg, tp_size: int):
    if cfg.n_kv_heads and tp_size and cfg.n_kv_heads % tp_size == 0:
        kv = (None, "batch", None, "tp", None)
        xkv = (None, "batch", None, "tp", None)
    else:
        kv = (None, "batch", "seq", None, None)
        xkv = (None, "batch", None, None, None)
    return (kv, kv, xkv, xkv)

def prefill(cfg, params, tokens, cache_len: int, *, frames, mesh=None):
    """-> (last-token logits (B, 1, V) f32, (k, v, cross k, cross v)),
    zeros in k and v past the prompt (this rank's part under a mesh)."""
    enc = encode(cfg, params, frames, mesh)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens,
               torch.arange(S, device=tokens.device)[None], mesh)
    kv = tfm.kv_layout(cfg, mesh, cache_len)
    kc, vc = zeros_of(init_cache_abstract(cfg, B, cache_len, mesh)[:2],
                      x.device)
    xks, xvs = [], []
    for l in range(cfg.n_layers):
        p = layer(params["dec_blocks"], l)
        x, (k, v) = _self_attn(cfg, p, x, causal=True, mesh=mesh)
        tfm.store_prompt(cfg, kc[l], k, mesh, kv)
        tfm.store_prompt(cfg, vc[l], v, mesh, kv)
        # the cross K/V are computed once here, and cached for decode
        xk, xv = _cross_kv(cfg, p, enc, mesh)
        x = _cross_attn(cfg, p, x, xk, xv, mesh)
        x = _mlp(cfg, p, x, mesh)
        if not _xkv_heads(cfg, mesh):       # cached whole on every rank
            xk, xv = (tfm.all_kv_heads(cfg, t, mesh) for t in (xk, xv))
        xks.append(xk)
        xvs.append(xv)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (_logits(cfg, params, x, mesh),
            (kc, vc, torch.stack(xks), torch.stack(xvs)))


def decode_step(cfg, params, cache, tokens, pos, *, mesh=None, kv: str = ""):
    """One step; k and v are written in place.  -> (logits (B, V) f32,
    cache)."""
    kc, vc, xk, xv = cache
    if not _xkv_heads(cfg, mesh):
        xk, xv = (tfm.my_kv_heads(cfg, t, mesh, 3) for t in (xk, xv))
    x = _embed(cfg, params, tokens[:, None], pos[:, None], mesh)
    for l in range(cfg.n_layers):
        p = layer(params["dec_blocks"], l)
        x, _ = _self_attn(cfg, p, x, causal=True, cache=(kc[l], vc[l]),
                          pos=pos, mesh=mesh, kv=kv)
        x = _cross_attn(cfg, p, x, xk[l], xv[l], mesh)
        x = _mlp(cfg, p, x, mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, 0], mesh), cache
