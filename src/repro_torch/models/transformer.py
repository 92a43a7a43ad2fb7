"""Dense decoder-only transformer, forward only, on torch.

Port of ``repro/models/transformer.py`` for the ``dense`` family.  The
reference stacks layers on a leading L axis and drives them with
``lax.scan``; here the stacked tensors stay as they are and a Python loop
indexes layer ``l`` (a view, no copy).  Per-layer sliding windows
(``layer_windows``) ride along as Python ints.

The KV cache ``(L, B, Smax, K, hd)`` is allocated once by ``prefill`` and
written in place by ``decode_step`` (JAX arrays are immutable, so the
reference returns an updated cache each step; the port's tensors are
not, and the returned cache is the same tensors).

Decode attention: a layer with no sliding window and no score softcap
goes through the hand-written kernel ``kernels/decode_attention``; the
others (gemma2's) through the plain ``layers.attend_decode``, as in the
reference.  The ``moe`` and ``vlm`` variants of this module are not
ported yet and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, seq_shard, shard_heads

NOT_PORTED = "not ported yet (ROADMAP queue 1, item 10)"

# ------------------------------------------------------------------ defs


def block_param_defs(cfg: ModelConfig, n_layers: int, stacked: bool = True):
    if cfg.family == "moe":
        raise NotImplementedError(f"the moe family is {NOT_PORTED}")
    d, hd = cfg.d_model, cfg.the_head_dim()
    H, K = cfg.n_heads, cfg.n_kv_heads
    Lx = (n_layers,) if stacked else ()
    st = (None,) if stacked else ()
    defs = {
        "attn_norm": ParamDef(Lx + (d,), st + (None,), init="zeros"),
        "wq": ParamDef(Lx + (d, H * hd), st + ("fsdp", "tp")),
        "wk": ParamDef(Lx + (d, K * hd), st + ("fsdp", "tp")),
        "wv": ParamDef(Lx + (d, K * hd), st + ("fsdp", "tp")),
        "wo": ParamDef(Lx + (H * hd, d), st + ("tp", "fsdp")),
        "mlp_norm": ParamDef(Lx + (d,), st + (None,), init="zeros"),
        "wg": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
        "wu": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
        "wd": ParamDef(Lx + (cfg.d_ff, d), st + ("tp", "fsdp")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(Lx + (hd,), st + (None,), init="zeros")
        defs["k_norm"] = ParamDef(Lx + (hd,), st + (None,), init="zeros")
    return defs


def param_defs(cfg: ModelConfig):
    if cfg.family == "vlm":
        raise NotImplementedError(f"the vlm family (patch_proj) is "
                                  f"{NOT_PORTED}")
    d = cfg.d_model
    return {
        "embed": ParamDef((cfg.vocab_size, d), ("tp", "fsdp"), scale=1.0),
        "blocks": block_param_defs(cfg, cfg.n_layers),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "unembed": ParamDef((d, cfg.vocab_size), ("fsdp", "tp")),
    }


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding-window sizes (0 = global)."""
    if cfg.local_global_pattern:
        w = np.zeros(cfg.n_layers, np.int32)
        w[::2] = cfg.local_window  # even layers local, odd global (gemma2)
        return w
    return np.full(cfg.n_layers, cfg.local_window, np.int32)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(blocks: dict, l: int) -> dict:
    """Layer ``l``'s parameters: views into the stacked tensors."""
    return {name: t[l] for name, t in blocks.items()}


# ------------------------------------------------------------------ blocks


def _attn_block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
                pos=None):
    """x: (B, S, d) for train/prefill; (B, 1, d) for decode."""
    dt = x.dtype
    hd = cfg.the_head_dim()
    H, K = cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    B, S, _ = h.shape
    q = (h @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (h @ p["wk"].to(dt)).reshape(B, S, K, hd)
    v = (h @ p["wv"].to(dt)).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = L.l2_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.l2_head_norm(k, p["k_norm"], cfg.norm_eps)
    if mode == "decode":
        positions = pos[:, None]  # (B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        kc, vc = cache  # (B, Smax, K, hd), written in place
        L.scatter_kv(kc, k[:, 0], pos)
        L.scatter_kv(vc, v[:, 0], pos)
        if window == 0 and not cfg.attn_softcap:
            # attend_decode attends to kpos <= pos (layers.py:175 of the
            # reference), the kernel to kpos < its count (decode_attention
            # kernel.py:56): the count of valid entries is pos + 1
            out = DA.decode_attention(q[:, 0], kc, vc, pos + 1)[:, None]
        else:
            out = L.attend_decode(q[:, 0], kc, vc, pos, window=window,
                                  softcap=cfg.attn_softcap)[:, None]
        new_cache = (kc, vc)
    else:
        q, k, v = (shard_heads(t) for t in (q, k, v))
        out = L.attend(q, k, v, causal=True, window=window,
                       softcap=cfg.attn_softcap)
        new_cache = (k, v) if mode == "prefill" else None
    y = out.reshape(B, S, H * hd) @ p["wo"].to(dt)
    return x + y, new_cache


def _mlp_block(cfg: ModelConfig, p, x):
    dt = x.dtype
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    y = L.swiglu(h, p["wg"].to(dt), p["wu"].to(dt), p["wd"].to(dt))
    return x + y


def block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
          pos=None):
    x, new_cache = _attn_block(cfg, p, x, window, mode=mode, cache=cache,
                               pos=pos)
    return _mlp_block(cfg, p, x), new_cache


# ------------------------------------------------------------------ model


def embed_tokens(cfg, params, tokens):
    # gather then cast: the same numbers as the reference's cast then
    # gather, without a bf16 copy of the whole table
    return params["embed"][tokens].to(_dtype(cfg))


def _logits(cfg, params, x):
    logits = x @ params["unembed"].to(x.dtype)
    return L.softcap_logits(logits.float(), cfg.logit_softcap)


def forward(cfg: ModelConfig, params, tokens):
    """Full-sequence forward -> (logits (B, S, V) f32, moe aux loss).  The
    aux loss is 0 for the dense family.  Forward only: no remat, and the
    reference's ``return_hidden`` (for the training loss) comes with
    training."""
    x = seq_shard(embed_tokens(cfg, params, tokens))
    for l, w in enumerate(layer_windows(cfg)):
        x, _ = block(cfg, _layer(params["blocks"], l), x, int(w),
                     mode="train")
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def prefill(cfg: ModelConfig, params, tokens, cache_len: int):
    """Prefill: returns (last-token logits (B, 1, V) f32, KV cache (k, v),
    each (L, B, cache_len, K, hd) with zeros past the prompt)."""
    x = embed_tokens(cfg, params, tokens)
    B, S = tokens.shape
    k_all, v_all = (torch.zeros(s.shape, dtype=s.dtype, device=x.device)
                    for s in init_cache_abstract(cfg, B, cache_len))
    for l, w in enumerate(layer_windows(cfg)):
        x, (k, v) = block(cfg, _layer(params["blocks"], l), x, int(w),
                          mode="prefill")
        k_all[l, :, :S] = k
        v_all[l, :, :S] = v
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), (k_all, v_all)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step.  tokens: (B,), pos: (B,) write positions.
    cache: (k, v) each (L, B, Smax, K, hd), updated in place.  Returns
    (logits (B, V) f32, cache)."""
    x = embed_tokens(cfg, params, tokens[:, None])
    k_all, v_all = cache
    for l, w in enumerate(layer_windows(cfg)):
        x, _ = block(cfg, _layer(params["blocks"], l), x, int(w),
                     mode="decode", cache=(k_all[l], v_all[l]), pos=pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, 0]), cache


def init_cache_abstract(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache's (k, v) as tensors on the meta device: shape and dtype,
    no storage (the reference's ``ShapeDtypeStruct``s)."""
    hd = cfg.the_head_dim()
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, hd)
    dt = _dtype(cfg)
    return (torch.empty(shape, dtype=dt, device="meta"),
            torch.empty(shape, dtype=dt, device="meta"))
