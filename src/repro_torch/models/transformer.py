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

Under a mesh (``attn_tp``) q/k/v are column-parallel over ``model``,
computed for this rank's heads only, and ``wo`` row-parallel with one
all-reduce after it; when the kv heads are fewer than the ranks, the
ranks that share one gather its columns of ``wk``/``wv``.  The decode
attends the cache where it lies (``kv_layout``): its own kv heads, or
its sequence shard for every head (the new token written by the shard
that owns its position, the shards' softmax parts merged by their
log-sum-exp), or, where neither divides, the whole cache.  Heads that do
not divide the ranks (llama4's 40 on 16) keep the reference's padded
``_attend_tp`` on gathered weights.

Sequence parallelism (the reference's ``seq_shard``): where ``model``
divides S_total, the training forward carries each rank's shard of the
sequence between the layers.  A layer norms its shard, gathers the
normed input over S (``seq_gather``, in place of ``to_model``), runs its
split work on the whole sequence (RoPE's positions, attention and the
experts' capacity all see the reference's S) and reduce-scatters the
partial output over S (``seq_scatter``, in place of ``reduce_model``);
the residual add is on shards.  Work that runs whole on every rank
takes ``gather_model`` and ``seq_part``.  The norms' scales, used on
shards, get their gradients summed over ``model``.  The final hidden is
gathered over S before the logits or the loss.  Prefill and decode keep
the whole sequence, as the reference's do.

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
                                       gather_sum, layer, model_slice,
                                       reduce_model, seq_gather, seq_parallel,
                                       seq_part, seq_scatter, shard_heads,
                                       to_model, zeros_of)

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


ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def attn_tp(cfg: ModelConfig, mesh) -> bool:
    """Whether attention runs Megatron-style over ``model``: the heads
    divide the ranks and each rank's query heads use whole kv heads
    (K % tp == 0) or share one (tp % K == 0)."""
    tp = axis_size(mesh, "model")
    H, K = cfg.n_heads, cfg.n_kv_heads
    return tp > 1 and H > 0 and H % tp == 0 and (K % tp == 0 or tp % K == 0)


def kv_layout(cfg: ModelConfig, mesh, cache_len: int) -> str:
    """Where a kv cache of ``cache_len`` positions lies over ``model`` (the
    placement ``cache_logical_spec`` resolves to): "heads", "seq", or ""
    (whole on every rank)."""
    tp = axis_size(mesh, "model")
    if tp <= 1 or not cfg.n_kv_heads:
        return ""
    if cfg.n_kv_heads % tp == 0:
        return "heads"
    return "seq" if cache_len % tp == 0 else ""


def _shared_head(cfg, mesh) -> int:
    """The kv head this rank's query heads use when the kv heads are fewer
    than the ranks (-1 otherwise)."""
    tp, K = axis_size(mesh, "model"), cfg.n_kv_heads
    if not attn_tp(cfg, mesh) or K >= tp:
        return -1
    return coordinate(mesh, "model") // (tp // K)


def kv_heads(cfg, h, w, mesh):
    """(B, S, n, hd): this rank's kv heads of ``h @ w`` under ``attn_tp``
    (its K/tp, or the one it shares: that head's columns of ``w``,
    gathered over ``model`` where ``w`` is a column shard, so no rank
    computes another head), else all K."""
    B, S, _ = h.shape
    hd = cfg.the_head_dim()
    kh = _shared_head(cfg, mesh)
    if kh >= 0:
        w = (gather_sum(w, -1, mesh) if w.shape[-1] < cfg.n_kv_heads * hd
             else to_model(w, mesh)).narrow(-1, kh * hd, hd)
    return (h @ w).reshape(B, S, -1, hd)


def all_kv_heads(cfg, k, mesh):
    """Every kv head from this rank's (``kv_heads``'s) over ``model``."""
    if not attn_tp(cfg, mesh):
        return k
    k = gather_model(k, 2, mesh)
    tp = axis_size(mesh, "model")
    return k if cfg.n_kv_heads >= tp else k[:, :, ::tp // cfg.n_kv_heads]


def my_kv_heads(cfg, k, mesh, dim: int = 2):
    """This rank's kv heads of a tensor holding all K (along ``dim``)."""
    if not attn_tp(cfg, mesh):
        return k
    kh = _shared_head(cfg, mesh)
    if kh >= 0:
        return k.narrow(dim, kh, 1)
    n = cfg.n_kv_heads // axis_size(mesh, "model")
    return k.narrow(dim, coordinate(mesh, "model") * n, n)


def _cols(h, w, n_cols: int, mesh):
    """``h @ w`` for all ``n_cols`` columns: gathered over ``model`` from
    the ranks' column shards where ``w`` is one."""
    y = h @ w
    return y if w.shape[-1] == n_cols else gather_model(y, -1, mesh)


def qkv(cfg, p, h, mesh, *, all_kv: bool = False):
    """(q of this rank's heads, k and v of its kv heads), (B, S, n, hd)
    each, from the normed ``h`` (``to_model``-ed under ``attn_tp``);
    with ``all_kv`` k and v of every kv head (a decode step whose cache
    holds them all: the token's columns gathered, not the weights)."""
    B, S, _ = h.shape
    dt, hd = h.dtype, cfg.the_head_dim()
    q = (h @ p["wq"].to(dt)).reshape(B, S, -1, hd)
    if all_kv:
        n = cfg.n_kv_heads * hd
        k, v = (_cols(h, p[w].to(dt), n, mesh).reshape(B, S, -1, hd)
                for w in ("wk", "wv"))
    else:
        k, v = (kv_heads(cfg, h, p[w].to(dt), mesh) for w in ("wk", "wv"))
    return q, k, v


def store_prompt(cfg, dst, k, mesh, kv: str):
    """A prefill's k (or v) of this rank's kv heads (B, S, n, hd) into its
    part of one layer's cache ``dst``: its heads, its sequence shard of
    every head, or every head whole, as ``kv`` says."""
    S = k.shape[1]
    if kv == "heads":
        dst[:, :S] = k
        return
    k = all_kv_heads(cfg, k, mesh)
    lo = coordinate(mesh, "model") * dst.shape[1] if kv == "seq" else 0
    n = max(0, min(S - lo, dst.shape[1]))
    dst[:, :n] = k[:, lo:lo + n]


def attend_cache(cfg, q, k, v, cache, pos, mesh, kv: str, window: int = 0):
    """One decode token's attention over the cache where it lies.  q:
    this rank's heads (all of them under ``attn_tp`` unless ``kv`` is
    "heads"), k/v: the token's, of the kv heads the cache holds (B, 1,
    n, hd); the cache (B, S_l, n, hd) is written in place.  -> (B, 1, h,
    hd) for q's heads."""
    kc, vc = cache
    spread = attn_tp(cfg, mesh) and kv != "heads"
    if spread:          # the cache holds every head: attend them all
        q = gather_model(q, 2, mesh)
    fused = window == 0 and not cfg.attn_softcap
    if kv == "seq":
        S_l = kc.shape[1]
        start = coordinate(mesh, "model") * S_l
        for c, new in ((kc, k), (vc, v)):
            L.scatter_kv_owned(c, new[:, 0], pos - start)
        if fused:
            # the kernel's count: this shard's entries at positions <= pos
            o, lse = DA.decode_attention(
                q[:, 0], kc, vc, (pos + 1 - start).clamp(0, S_l),
                partial=True)
        else:
            o, lse = L.attend_decode_part(q[:, 0], kc, vc, pos, start,
                                          window=window,
                                          softcap=cfg.attn_softcap)
        out = L.merge_parts(o, lse, mesh).to(q.dtype)
    else:
        L.scatter_kv(kc, k[:, 0], pos)
        L.scatter_kv(vc, v[:, 0], pos)
        if fused:
            # attend_decode attends to kpos <= pos (layers.py:175 of the
            # reference), the kernel to kpos < its count (decode_attention
            # kernel.py:56): the count of valid entries is pos + 1
            out = DA.decode_attention(q[:, 0], kc, vc, pos + 1)
        else:
            out = L.attend_decode(q[:, 0], kc, vc, pos, window=window,
                                  softcap=cfg.attn_softcap)
    out = out[:, None]
    if spread:
        n = cfg.n_heads // axis_size(mesh, "model")
        out = out[:, :, coordinate(mesh, "model") * n:][:, :, :n]
    return out


def _norm_scale(scale, mesh, sp: bool):
    """A norm's scale; on sequence shards its gradient (from this rank's
    positions) is summed over ``model``."""
    return to_model(scale, mesh) if sp else scale


def _seq_in(h, mesh, sp: bool, split: bool):
    """A block's normed input for its work: gathered over S under
    sequence parallelism (for ``split`` work, whose gradient is each
    rank's part, or work run whole); ``to_model``-ed for split work on a
    replicated stream."""
    if sp:
        return seq_gather(h, mesh) if split else gather_model(h, 1, mesh)
    return to_model(h, mesh) if split else h


def _seq_out(y, mesh, sp: bool, split: bool):
    """A block's output onto the residual stream: partial sums of split
    work summed over ``model`` (reduce-scattered over S under sequence
    parallelism), work run whole cut to this rank's shard."""
    if sp:
        return seq_scatter(y, mesh) if split else seq_part(y, mesh)
    return reduce_model(y, mesh) if split else y


def _attn_block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
                pos=None, mesh=None, kv: str = "", sp: bool = False):
    """x: (B, S, d) for train/prefill; (B, 1, d) for decode; with ``sp``
    this rank's (B, S/tp, d) shard of a training sequence.  Prefill
    returns this rank's kv heads (``store_prompt`` places them)."""
    dt = x.dtype
    tp = attn_tp(cfg, mesh)
    h = L.rms_norm(x, _norm_scale(p["attn_norm"], mesh, sp), cfg.norm_eps)
    h = _seq_in(h, mesh, sp, tp)
    B, S, _ = h.shape
    q, k, v = qkv(cfg, p, h, mesh, all_kv=mode == "decode" and tp
                  and kv != "heads")
    if cfg.qk_norm:
        # the norms' gradients from this rank's heads, summed over model
        rep = (lambda t: to_model(t, mesh)) if tp else (lambda t: t)
        q = L.l2_head_norm(q, rep(p["q_norm"]), cfg.norm_eps)
        k = L.l2_head_norm(k, rep(p["k_norm"]), cfg.norm_eps)
    if mode == "decode":
        positions = pos[:, None]  # (B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        out = attend_cache(cfg, q, k, v, cache, pos, mesh, kv, window)
        new_cache = cache
    else:
        out = (L.attend(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap) if tp
               else _attend_tp(cfg, q, k, v, window, mesh))
        new_cache = (k, v) if mode == "prefill" else None
    y = out.reshape(B, S, -1) @ p["wo"].to(dt)
    return x + _seq_out(y, mesh, sp, tp), new_cache


def _attend_tp(cfg: ModelConfig, q, k, v, window: int, mesh):
    """Attention of (B, S, H, hd) q over (B, S, K, hd) k, v, all replicated
    over ``model`` (the heads do not split: ``attn_tp`` is false).  When
    H doesn't divide the model axis but exceeds it (llama4: 40 heads on
    tp=16), the GQA group dim is padded so K*G' divides tp, each rank
    attends its share of the padded heads, the outputs are gathered and
    the padding cut off (the reference's ``shard_heads`` constraints);
    otherwise every rank attends all heads."""
    tp = axis_size(mesh, "model")
    H, K = q.shape[2], k.shape[2]

    def attend(q, k, v):
        return L.attend(q, k, v, causal=True, window=window,
                        softcap=cfg.attn_softcap)
    if tp <= 1 or H % tp == 0 or H < tp:
        return attend(q, k, v)
    B, S, _, hd = q.shape
    G = H // K
    Gp = G
    while (K * Gp) % tp:
        Gp += 1
    q = torch.nn.functional.pad(q.reshape(B, S, K, G, hd),
                                (0, 0, 0, Gp - G)).reshape(B, S, K * Gp, hd)
    hl, r = K * Gp // tp, coordinate(mesh, "model")   # this rank's heads
    if hl % Gp and Gp % hl:
        # a rank's heads would span a ragged set of kv heads: unsharded
        out = attend(q, k, v)
    else:
        kl, kv0 = max(hl // Gp, 1), r * hl // Gp
        out = gather_model(attend(shard_heads(q, mesh),
                                  model_slice(k, 2, kv0, kl, mesh),
                                  model_slice(v, 2, kv0, kl, mesh)), 2, mesh)
    return _unpad(out, K, Gp, G)


def _unpad(out, K: int, Gp: int, G: int):
    B, S, _, hd = out.shape
    return out.reshape(B, S, K, Gp, hd)[:, :, :, :G].reshape(B, S, K * G, hd)


def mlp_tp(cfg: ModelConfig, mesh) -> bool:
    """Whether the MLP runs Megatron-parallel over ``model``: its matrices
    keep their ``model`` shards of ``d_ff`` (column-parallel gate and up,
    row-parallel down, one all-reduce of the output)."""
    tp = axis_size(mesh, "model")
    return tp > 1 and cfg.d_ff > 0 and cfg.d_ff % tp == 0


def whole_leaves(cfg: ModelConfig, mesh) -> frozenset:
    """The leaves placed over ``model`` whose work does not split over it
    here: they are gathered whole before a meshed step.  The attention's
    when its heads do not divide (``attn_tp``), and vlm's ``patch_proj``
    (the patches' projection runs replicated: this slice does not split
    it)."""
    return frozenset((() if attn_tp(cfg, mesh) else ATTN_WEIGHTS)
                     + ("patch_proj",))


def _swiglu(cfg, h, wg, wu, wd, mesh, sp: bool = False):
    split = mlp_tp(cfg, mesh)
    return _seq_out(L.swiglu(_seq_in(h, mesh, sp, split), wg, wu, wd), mesh,
                    sp, split)


def _mlp_block(cfg: ModelConfig, p, x, mesh=None, sp: bool = False):
    dt = x.dtype
    h = L.rms_norm(x, _norm_scale(p["mlp_norm"], mesh, sp), cfg.norm_eps)
    aux = 0.0                # no tensor (and no launch) unless moe
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(cfg, p, h, mesh=mesh, sp=sp)
        if cfg.shared_expert:
            y = y + _swiglu(cfg, h, p["se_wg"].to(dt), p["se_wu"].to(dt),
                            p["se_wd"].to(dt), mesh, sp)
    else:
        y = _swiglu(cfg, h, p["wg"].to(dt), p["wu"].to(dt), p["wd"].to(dt),
                    mesh, sp)
    return x + y, aux


def block(cfg: ModelConfig, p, x, window: int, *, mode, cache=None,
          pos=None, mesh=None, kv: str = "", sp: bool = False):
    """-> (x, new cache, the layer's moe aux loss (0 unless moe)).  With
    ``sp`` x is this rank's shard of the sequence, and so is the x
    returned."""
    x, new_cache = _attn_block(cfg, p, x, window, mode=mode, cache=cache,
                               pos=pos, mesh=mesh, kv=kv, sp=sp)
    x, aux = _mlp_block(cfg, p, x, mesh=mesh, sp=sp)
    return x, new_cache, aux


# ------------------------------------------------------------------ model


def embed_tokens(cfg, params, tokens, patches=None, mesh=None):
    dt = compute_dtype(cfg)
    x = L.embed(params, tokens, dt, L.vocab_mesh(cfg, mesh))
    if cfg.family == "vlm" and patches is not None:
        pe = patches.to(dt) @ params["patch_proj"].to(dt)
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(cfg, params, x, mesh=None):
    return L.softcap_logits(L.unembed(params, x, L.vocab_mesh(cfg, mesh)),
                            cfg.logit_softcap)


def _embed_shard(cfg, params, tokens, patches=None, mesh=None):
    """(the training forward's embedded input, whether it is sequence
    parallel): this rank's shard of the sequence where ``seq_parallel``
    holds on S_total (the vocab-parallel lookup then ends in a
    reduce-scatter over S, not an all-reduce), else the whole."""
    vlm = cfg.family == "vlm" and patches is not None
    S = tokens.shape[1] + (patches.shape[1] if vlm else 0)
    sp = seq_parallel((tokens.shape[0], S, cfg.d_model), mesh)
    vmesh = L.vocab_mesh(cfg, mesh)
    if sp and vmesh is not None and not vlm:
        return L.embed(params, tokens, compute_dtype(cfg), vmesh,
                       seq=True), True
    x = embed_tokens(cfg, params, tokens, patches, mesh)
    return (seq_part(x, mesh) if sp else x), sp


def _train_block(cfg, p, x, window: int, mesh=None, sp: bool = False):
    x, _, aux = block(cfg, p, x, window, mode="train", mesh=mesh, sp=sp)
    return x, aux


def forward(cfg: ModelConfig, params, tokens, *, patches=None, mesh=None,
            remat=True, return_hidden=False):
    """Full-sequence forward -> (logits (B, S_total, V) f32, moe aux loss:
    the mean over layers, 0 unless moe).  S_total counts the prepended
    patches (vlm).  With ``return_hidden``, the final normed hidden
    (B, S_total, d) in place of the logits (the training loss takes the
    chunked CE).  ``remat`` recomputes each layer in the backward.  Under
    sequence parallelism (``_embed_shard``) each layer takes and returns
    this rank's shard of the sequence (the reference's ``seq_shard``
    after the embedding and after every layer), and the final normed
    shard is gathered over S."""
    x, sp = _embed_shard(cfg, params, tokens, patches, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, w in enumerate(layer_windows(cfg)):
        x, a = L.remat(remat, _train_block, cfg, layer(params["blocks"], l),
                       x, int(w), mesh, sp)
        aux = aux + a
    x = L.rms_norm(x, _norm_scale(params["final_norm"], mesh, sp),
                   cfg.norm_eps)
    if sp:
        x = gather_model(x, 1, mesh)
    aux = aux / max(cfg.n_layers, 1)
    if return_hidden:
        return x, aux
    return _logits(cfg, params, x, mesh), aux


def prefill(cfg: ModelConfig, params, tokens, cache_len: int, *,
            patches=None, mesh=None):
    """Prefill: returns (last-token logits (B, 1, V) f32, KV cache (k, v),
    each (L, B, cache_len, K, hd) with zeros past the prompt, the
    prepended patches included; under a mesh this rank's part of it, as
    ``kv_layout`` places it)."""
    x = embed_tokens(cfg, params, tokens, patches, mesh)
    B = x.shape[0]
    kv = kv_layout(cfg, mesh, cache_len)
    k_all, v_all = zeros_of(local_cache(cfg, B, cache_len, mesh, kv),
                            x.device)
    for l, w in enumerate(layer_windows(cfg)):
        x, (k, v), _ = block(cfg, layer(params["blocks"], l), x, int(w),
                             mode="prefill", mesh=mesh)
        store_prompt(cfg, k_all[l], k, mesh, kv)
        store_prompt(cfg, v_all[l], v, mesh, kv)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x, mesh), (k_all, v_all)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *, mesh=None,
                kv: str = ""):
    """One decode step.  tokens: (B,), pos: (B,) write positions.
    cache: (k, v) each (L, B, Smax, K, hd), updated in place (under a
    mesh this rank's part, placed as ``kv`` says: ``kv_layout``).
    Returns (logits (B, V) f32, cache)."""
    x = embed_tokens(cfg, params, tokens[:, None], mesh=mesh)
    k_all, v_all = cache
    for l, w in enumerate(layer_windows(cfg)):
        x, _, _ = block(cfg, layer(params["blocks"], l), x, int(w),
                        mode="decode", cache=(k_all[l], v_all[l]), pos=pos,
                        mesh=mesh, kv=kv)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, 0], mesh), cache


def init_cache_abstract(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache's (k, v) as tensors on the meta device: shape and dtype,
    no storage (the reference's ``ShapeDtypeStruct``s)."""
    hd = cfg.the_head_dim()
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, hd)
    dt = compute_dtype(cfg)
    return (torch.empty(shape, dtype=dt, device="meta"),
            torch.empty(shape, dtype=dt, device="meta"))


def local_cache(cfg: ModelConfig, batch: int, cache_len: int, mesh,
                kv: str, n_layers: int = None):
    """This rank's (k, v) cache part as meta tensors, placed as ``kv``
    says (``init_cache_abstract``'s shapes without a mesh)."""
    tp = axis_size(mesh, "model")
    hd, K = cfg.the_head_dim(), cfg.n_kv_heads
    shape = (cfg.n_layers if n_layers is None else n_layers, batch,
             cache_len // tp if kv == "seq" else cache_len,
             K // tp if kv == "heads" else K, hd)
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
