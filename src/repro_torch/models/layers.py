"""Shared neural building blocks, on torch.

Port of ``repro/models/layers.py``.  Attention comes in three flavours:

  * ``flash.flash_attention`` — blocked online-softmax attention with a
    backward that recomputes block scores (training and prefill at
    S >= 1024, chosen by ``attend``).
  * ``attend_full`` — plain einsum path for short sequences.
  * ``attend_decode`` — single-token query against a KV cache (the plain
    route for layers with a sliding window or a score softcap; other
    layers decode through ``kernels/decode_attention``).

Scores are taken in f32 (the reference's ``preferred_element_type``:
bf16 inputs are upcast exactly, so only the summation order differs).
Norms and rope compute in f32 and cast back, as the reference does.

The loss: ``cross_entropy`` over f32 logits and ``chunked_cross_entropy``,
which never holds the (B, S, V) f32 logits: each S-chunk's logits are
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` with ``nothing_saveable``).  ``remat`` is the same
per-layer recompute for the models' training forward.

Under a mesh whose ``model`` axis divides the vocabulary (``vocab_mesh``)
the embedding, the logits and the loss run vocab-parallel on each rank's
rows of ``embed`` and columns of ``unembed``: a masked lookup summed over
``model``, a logits shard gathered over it, and each CE chunk's max, sum
of exponentials and true logit combined over it.  That is what the
reference's ``REPRO_LOSS_UNEMBED_TP`` and ``REPRO_SHARDED_CE`` ask of
its partitioner; the port does it always and reads neither flag.  A
decode over a cache sharded by sequence takes ``attend_decode_part``
(or the kernel's partial mode) on each rank and ``merge_parts`` over
``model``.  ``REPRO_FORCE_FULL_ATTENTION`` sends ``attend`` down the
full path (the reference's costing hook).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mesh import axis_size, coordinate, group
from repro_torch.models.params import (gather_model, reduce_model,
                                       seq_scatter, to_model)

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
    if os.environ.get("REPRO_FORCE_FULL_ATTENTION"):
        # costing hook (launch/dryrun.py): the full path does
        # the same products with no block loops to trace
        return attend_full(q, k, v, causal=causal, window=window,
                           softcap=softcap)
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


def attend_decode_part(q, k_cache, v_cache, pos, start: int, *, window=0,
                       softcap=0.0):
    """``attend_decode`` over one sequence shard of the cache, whose
    entries hold positions ``start + [0, S)``: (out (B, H, hd) f32, the
    softmax over this shard's valid keys alone; lse (B, H) f32, their
    log-sum-exp, -inf where the shard has none, whose out is 0)."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * (
        hd ** -0.5)
    s = _softcap(s, softcap)
    kpos = start + torch.arange(S, device=q.device)
    mask = (kpos[None] <= pos[:, None]) & _window_mask(pos[:, None],
                                                       kpos[None], window)
    s = torch.where(mask[:, None, None], s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask[:, None, None], torch.exp(s - m), 0.0)
    l = p.sum(-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    out = out.float() / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -torch.inf)
    return out.reshape(B, H, hd), lse.reshape(B, H)


def merge_parts(out, lse, mesh=None):
    """The ranks' softmax parts over disjoint key sets merged over
    ``model``: out (B, H, hd) f32 each normalised over its own keys, lse
    (B, H) their log-sum-exp (-inf: no key, weight 0).  One all-reduce of
    the max, one of the weighted outputs and the weights.  Without a
    mesh the parts are stacked on a leading axis and merged here."""
    if mesh is None:
        m = lse.amax(0)
    else:
        m = lse.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group(mesh, "model"))
    w = torch.where(lse > -torch.inf, torch.exp(lse - m), 0.0)
    both = torch.cat([out * w[..., None], w[..., None]], dim=-1)
    if mesh is None:
        both = both.sum(0)
    else:
        dist.all_reduce(both, group=group(mesh, "model"))
    return both[..., :-1] / both[..., -1:]


def scatter_kv(cache, new, pos):
    """Write one token into the cache, in place (the reference returns an
    updated copy: JAX arrays are immutable).  cache: (B, S, K, hd),
    new: (B, K, hd), pos: (B,)."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), pos] = new.to(cache.dtype)
    return cache


def scatter_kv_owned(cache, new, idx):
    """``scatter_kv`` into a sequence shard of the cache: row b written at
    ``idx[b]`` (its position less the shard's first) only where that
    falls inside the shard, so only the owner of a position writes it."""
    B, S = cache.shape[:2]
    own = (idx >= 0) & (idx < S)
    i = idx.clamp(0, S - 1)
    rows = torch.arange(B, device=cache.device)
    cache[rows, i] = torch.where(own[:, None, None], new.to(cache.dtype),
                                 cache[rows, i])
    return cache


# ----------------------------------------------------------------- mlp


def swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


def gelu_mlp(x, w1, w2):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w1, approximate="tanh") @ w2


# ------------------------------------------------------ embedding, logits


def vocab_mesh(cfg, mesh):
    """``mesh`` when its ``model`` axis splits the vocabulary (``embed``'s
    rows and ``unembed``'s columns are then each rank's shard), else
    None."""
    tp = axis_size(mesh, "model")
    return mesh if tp > 1 and cfg.vocab_size % tp == 0 else None


def embed(params, tokens, dt, vmesh=None, seq: bool = False):
    """Token embeddings in ``dt``.  Serving gathers then casts: the same
    numbers as the reference's cast then gather, without a copy of the
    whole table.  When the table takes a gradient the reference's order
    is kept, because it decides the backward: the scatter-add of repeated
    tokens' gradients then runs in ``dt`` (bf16), as the reference's does,
    before the cast back to the f32 master.  With ``vmesh`` the table is
    this rank's rows: a token outside them looks up 0, and the rows are
    summed over ``model`` (one of them is not 0: exact); with ``seq``
    reduce-scattered over S instead, to this rank's shard of the
    sequence (sequence parallelism's first split)."""
    table = params["embed"]
    if vmesh is not None:
        lo = coordinate(vmesh, "model") * table.shape[0]
        tokens = tokens - lo
        inside = (tokens >= 0) & (tokens < table.shape[0])
        tokens = tokens.clamp(0, table.shape[0] - 1)
    if table.requires_grad and torch.is_grad_enabled():
        x = table.to(dt)[tokens]
    else:
        x = table[tokens].to(dt)
    if vmesh is None:
        return x
    x = torch.where(inside[..., None], x, 0.0)
    return seq_scatter(x, vmesh) if seq else reduce_model(x, vmesh)


def unembed(params, x, vmesh=None):
    """Logits in f32 from the final hidden states ``x``; with ``vmesh``
    from this rank's vocabulary columns, gathered over ``model``."""
    if vmesh is None:
        return (x @ params["unembed"].to(x.dtype)).float()
    logits = (to_model(x, vmesh) @ params["unembed"].to(x.dtype)).float()
    return gather_model(logits, -1, vmesh)


def softcap_logits(logits, cap: float):
    return _softcap(logits, cap)


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``enabled`` and autograd is recording (the reference's per-layer
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ----------------------------------------------------------------- loss


def _true_logit(logits, labels):
    """``logits`` at each label, 0 where the label lies outside [0, V):
    the reference sums the logits against ``jax.nn.one_hot(labels, V)``,
    a zero row for such a label (``ignore_id = -1`` among them), where a
    torch gather would wrap -1 to the last logit."""
    V = logits.shape[-1]
    inside = (labels >= 0) & (labels < V)
    idx = labels.clamp(0, V - 1).long()[..., None]
    return torch.where(inside, logits.gather(-1, idx)[..., 0], 0.0)


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """logits: (B, S, V); labels: (B, S).  The mean negative log
    likelihood over the labels that are not ``ignore_id``."""
    logits = logits.float()
    nll = torch.logsumexp(logits, -1) - _true_logit(logits, labels)
    valid = (labels != ignore_id).float()
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _ce_chunk(xc, unembed, lc, softcap, ignore_id):
    """(sum of one chunk's nll over its valid labels, their count)."""
    logits = (xc @ unembed.to(xc.dtype)).float()
    logits = _softcap(logits, softcap)
    nll = torch.logsumexp(logits, -1) - _true_logit(logits, lc)
    valid = (lc != ignore_id).float()
    return (nll * valid).sum(), valid.sum()


def _ce_chunk_tp(xc, u_loc, lc, softcap, ignore_id, mesh):
    """``_ce_chunk`` over this rank's vocab slice ``u_loc`` (d, V/tp) of
    the unembed: the max, the sum of exponentials and the true logit are
    combined over ``model``."""
    Vl = u_loc.shape[1]
    lo = coordinate(mesh, "model") * Vl
    logits = (to_model(xc, mesh) @ u_loc.to(xc.dtype)).float()
    logits = _softcap(logits, softcap)
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group(mesh, "model"))
    se = reduce_model(torch.exp(logits - m[..., None]).sum(-1), mesh)
    inside = (lc >= lo) & (lc < lo + Vl)
    idx = (lc - lo).clamp(0, Vl - 1).long()[..., None]
    true = reduce_model(torch.where(inside, logits.gather(-1, idx)[..., 0],
                                    0.0), mesh)
    valid = (lc != ignore_id).float()
    nll = m + torch.log(se) - true
    return (nll * valid).sum(), valid.sum()


def chunked_cross_entropy(x, unembed, labels, *, softcap=0.0,
                          ignore_id: int = -1, chunk: int = 512, mesh=None):
    """CE without the full (B, S, V) f32 logits: a loop over S-chunks,
    each chunk's logits recomputed in the backward.  x: (B, S, d) final
    normed hidden; unembed: (d, V), cast to x's dtype inside each chunk
    (so its bf16 gradients meet in f32, as the reference's scan
    accumulates them).  Sequences of at most one chunk, or not a
    multiple of it, take the unchunked path, as the reference's do.
    With ``mesh`` (a ``vocab_mesh``) ``unembed`` is this rank's (d, V/tp)
    columns and every chunk (the unchunked sequence too) runs
    vocab-parallel."""
    B, S, d = x.shape
    chunked = not (S % chunk != 0 or S <= chunk)
    if not chunked and mesh is not None:
        nll, nv = _ce_chunk_tp(x, unembed, labels, softcap, ignore_id, mesh)
        return nll / torch.clamp(nv, min=1.0)
    if not chunked:
        logits = x @ unembed.to(x.dtype)
        return cross_entropy(softcap_logits(logits.float(), softcap),
                             labels, ignore_id=ignore_id)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        cs = slice(c * chunk, (c + 1) * chunk)
        if mesh is not None:
            nll, nv = remat(True, _ce_chunk_tp, x[:, cs], unembed,
                            labels[:, cs], softcap, ignore_id, mesh)
        else:
            nll, nv = remat(True, _ce_chunk, x[:, cs], unembed,
                            labels[:, cs], softcap, ignore_id)
        nll_sum = nll_sum + nll
        n_valid = n_valid + nv
    return nll_sum / torch.clamp(n_valid, min=1.0)
