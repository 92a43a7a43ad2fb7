"""Decoder-only transformer, on torch: the ``dense`` family and the
backbone of ``moe`` and ``vlm``.

Port of ``repro/models/transformer.py``.  The
reference stacks layers on a leading L axis and drives them with
``lax.scan``; here the stacked tensors stay as they are and a Python loop
indexes layer ``l`` (a view, no copy; its gradient lands in the stacked
master).  Per-layer sliding windows (``layer_windows``) ride along as
Python ints.  The training forward recomputes each layer in the
backward (``remat``), as the reference's checkpointed scan body does.

The KV cache ``(L, B, Smax, K, hd)`` is allocated once by ``prefill`` and
written in place by ``decode_step`` (JAX arrays are immutable, so the
reference returns an updated cache each step; the port's tensors are
not, and the returned cache is the same tensors).

Decode attention: a layer with no sliding window and no score softcap
goes through the hand-written kernel ``kernels/decode_attention``; the
others (gemma2's) through the plain ``layers.attend_decode``, as in the
reference.

``moe`` swaps each layer's SwiGLU for ``models/moe.py``'s expert FFN (plus
llama4's always-on shared expert) and ``forward`` returns the mean of the
layers' load-balance losses; ``vlm`` prepends ``patches @ patch_proj`` to
the token embeddings when the batch carries patches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.core.mesh import axis_size, coordinate
from repro_torch.models.params import (ParamDef, compute_dtype, gather_model,
                                       layer, model_slice, reduce_model,
                                       seq_shard, shard_heads, to_model,
                                       zeros_of)

# ------------------------------------------------------------------ defs


def block_param_defs(cfg: ModelConfig, n_layers: int, stacked: bool = True):
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
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(Lx + (hd,), st + (None,), init="zeros")
        defs["k_norm"] = ParamDef(Lx + (hd,), st + (None,), init="zeros")
    if cfg.family == "moe":
        defs.update(moe_lib.moe_param_defs(cfg, Lx, st))
        if cfg.shared_expert:
            defs.update({
                "se_wg": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
                "se_wu": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
                "se_wd": ParamDef(Lx + (cfg.d_ff, d), st + ("tp", "fsdp")),
            })
    else:
        defs.update({
            "wg": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
            "wu": ParamDef(Lx + (d, cfg.d_ff), st + ("fsdp", "tp")),
            "wd": ParamDef(Lx + (cfg.d_ff, d), st + ("tp", "fsdp")),
        })
    return defs


def param_defs(cfg: ModelConfig):
    d = cfg.d_model
    defs = {
        "embed": ParamDef((cfg.vocab_size, d), ("tp", "fsdp"), scale=1.0),
        "blocks": block_param_defs(cfg, cfg.n_layers),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "unembed": ParamDef((d, cfg.vocab_size), ("fsdp", "tp")),
    }
    if cfg.family == "vlm":
        defs["patch_proj"] = ParamDef((d, d), ("fsdp", "tp"))
    return defs


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding-window sizes (0 = global)."""
    if cfg.local_global_pattern:
        w = np.zeros(cfg.n_layers, np.int32)
        w[::2] = cfg.local_window  # even layers local, odd global (gemma2)
        return w
    return np.full(cfg.n_layers, cfg.local_window, np.int32)


# ------------------------------------------------------------------ blocks


def _attn_block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
                pos=None, mesh=None):
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
        out = _attend_tp(cfg, q, k, v, window, mesh)
        new_cache = (k, v) if mode == "prefill" else None
    y = out.reshape(B, S, H * hd) @ p["wo"].to(dt)
    return x + y, new_cache


def _attend_tp(cfg: ModelConfig, q, k, v, window: int, mesh):
    """Attention of (B, S, H, hd) q over (B, S, K, hd) k, v.  Under a mesh
    each ``model`` rank attends with its share of the heads and the
    outputs are gathered (the reference's ``shard_heads`` constraints);
    when H doesn't divide the model axis but exceeds it (llama4: 40
    heads on tp=16), the GQA group dim is padded so K*G' divides tp, the
    padded heads are shared out, and the padding is cut off after."""
    tp = axis_size(mesh, "model")
    H, K = q.shape[2], k.shape[2]

    def attend(q, k, v):
        return L.attend(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap)
    if tp <= 1 or (H % tp and H <= tp):
        return attend(q, k, v)
    B, S, _, hd = q.shape
    G = H // K
    Gp = G
    while (K * Gp) % tp:
        Gp += 1
    if Gp != G:
        qg = q.reshape(B, S, K, G, hd)
        q = torch.nn.functional.pad(qg, (0, 0, 0, Gp - G)).reshape(
            B, S, K * Gp, hd)
    hl, r = K * Gp // tp, coordinate(mesh, "model")   # this rank's heads
    if hl % Gp and Gp % hl:
        # a rank's heads would span a ragged set of kv heads: unsharded
        out = attend(q, k, v)
    else:
        kl, kv0 = max(hl // Gp, 1), r * hl // Gp
        out = gather_model(attend(shard_heads(q, mesh),
                                  model_slice(k, 2, kv0, kl, mesh),
                                  model_slice(v, 2, kv0, kl, mesh)), 2, mesh)
    return out if Gp == G else _unpad(out, K, Gp, G)


def _unpad(out, K: int, Gp: int, G: int):
    B, S, _, hd = out.shape
    return out.reshape(B, S, K, Gp, hd)[:, :, :, :G].reshape(B, S, K * G, hd)


MLP_WEIGHTS = ("wg", "wu", "wd", "se_wg", "se_wu", "se_wd")


def mlp_tp(cfg: ModelConfig, mesh) -> bool:
    """Whether the SwiGLU runs Megatron-parallel over ``model``: its
    matrices keep their ``model`` shards of ``d_ff`` (column-parallel
    gate and up, row-parallel down, one all-reduce of the output)."""
    tp = axis_size(mesh, "model")
    return (cfg.family in ("dense", "moe", "vlm") and tp > 1
            and cfg.d_ff > 0 and cfg.d_ff % tp == 0)


def _swiglu(cfg, h, wg, wu, wd, mesh):
    if mlp_tp(cfg, mesh):
        return reduce_model(L.swiglu(to_model(h, mesh), wg, wu, wd), mesh)
    return L.swiglu(h, wg, wu, wd)


def _mlp_block(cfg: ModelConfig, p, x, mesh=None):
    dt = x.dtype
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    aux = 0.0                # no tensor (and no launch) unless moe
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(cfg, p, h, mesh=mesh)
        if cfg.shared_expert:
            y = y + _swiglu(cfg, h, p["se_wg"].to(dt), p["se_wu"].to(dt),
                            p["se_wd"].to(dt), mesh)
    else:
        y = _swiglu(cfg, h, p["wg"].to(dt), p["wu"].to(dt), p["wd"].to(dt),
                    mesh)
    return x + y, aux


def block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
          pos=None, mesh=None):
    """-> (x, new cache, the layer's moe aux loss (0 unless moe))."""
    x, new_cache = _attn_block(cfg, p, x, window, mode=mode, cache=cache,
                               pos=pos, mesh=mesh)
    x, aux = _mlp_block(cfg, p, x, mesh=mesh)
    return x, new_cache, aux


# ------------------------------------------------------------------ model


def embed_tokens(cfg, params, tokens, patches=None):
    dt = compute_dtype(cfg)
    x = L.embed(params, tokens, dt)
    if cfg.family == "vlm" and patches is not None:
        pe = patches.to(dt) @ params["patch_proj"].to(dt)
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(cfg, params, x):
    return L.softcap_logits(L.unembed(params, x), cfg.logit_softcap)


def _train_block(cfg, p, x, window: int, mesh=None):
    x, _, aux = block(cfg, p, x, window, mode="train", mesh=mesh)
    return x, aux


def forward(cfg: ModelConfig, params, tokens, *, patches=None, mesh=None,
            remat=True, return_hidden=False):
    """Full-sequence forward -> (logits (B, S_total, V) f32, moe aux loss:
    the mean over layers, 0 unless moe).  S_total counts the prepended
    patches (vlm).  With ``return_hidden``, the final normed hidden
    (B, S_total, d) in place of the logits (the training loss takes the
    chunked CE).  ``remat`` recomputes each layer in the backward."""
    x = seq_shard(embed_tokens(cfg, params, tokens, patches), mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, w in enumerate(layer_windows(cfg)):
        x, a = L.remat(remat, _train_block, cfg, layer(params["blocks"], l),
                       x, int(w), mesh)
        x = seq_shard(x, mesh)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = aux / max(cfg.n_layers, 1)
    if return_hidden:
        return x, aux
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, tokens, cache_len: int, *,
            patches=None, mesh=None):
    """Prefill: returns (last-token logits (B, 1, V) f32, KV cache (k, v),
    each (L, B, cache_len, K, hd) with zeros past the prompt, the
    prepended patches included)."""
    x = embed_tokens(cfg, params, tokens, patches)
    B, S = x.shape[:2]
    k_all, v_all = zeros_of(init_cache_abstract(cfg, B, cache_len),
                            x.device)
    for l, w in enumerate(layer_windows(cfg)):
        x, (k, v), _ = block(cfg, layer(params["blocks"], l), x, int(w),
                             mode="prefill", mesh=mesh)
        k_all[l, :, :S] = k
        v_all[l, :, :S] = v
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), (k_all, v_all)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, mesh=None):
    """One decode step.  tokens: (B,), pos: (B,) write positions.
    cache: (k, v) each (L, B, Smax, K, hd), updated in place.  Returns
    (logits (B, V) f32, cache)."""
    x = embed_tokens(cfg, params, tokens[:, None])
    k_all, v_all = cache
    for l, w in enumerate(layer_windows(cfg)):
        x, _, _ = block(cfg, layer(params["blocks"], l), x, int(w),
                        mode="decode", cache=(k_all[l], v_all[l]), pos=pos,
                        mesh=mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, 0]), cache


def init_cache_abstract(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache's (k, v) as tensors on the meta device: shape and dtype,
    no storage (the reference's ``ShapeDtypeStruct``s)."""
    hd = cfg.the_head_dim()
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, hd)
    dt = compute_dtype(cfg)
    return (torch.empty(shape, dtype=dt, device="meta"),
            torch.empty(shape, dtype=dt, device="meta"))


def cache_logical_spec(cfg: ModelConfig, tp_size: int):
    """(L, B, S, K, hd): shard K over tp when divisible, else shard S."""
    if cfg.n_kv_heads and tp_size and cfg.n_kv_heads % tp_size == 0:
        spec = (None, "batch", None, "tp", None)
    else:
        spec = (None, "batch", "seq", None, None)
    return (spec, spec)  # (k, v)
