"""zamba2-style hybrid, on torch: a Mamba-2 backbone and ONE
shared attention-and-MLP block applied after every ``attn_every`` mamba
layers, with the same weights at every use.

Port of ``repro/models/hybrid.py``.  The layer stack is ``n_uses`` groups
of [``attn_every`` x mamba2, shared block]; the reference reshapes the
stacked mamba params to (n_uses, attn_every, ...) and scans each group,
here a Python loop walks the layers in the same order.  The shared block
is ``transformer.block`` of the dense family with window 0, so its decode
attention goes through the CUDA ``decode_attention`` on the card.

The cache is mamba2's three stacked tensors plus the shared block's K and
V, one (B, cache_len, K, hd) slice per use; ``decode_step`` writes it in
place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (ParamDef, compute_dtype, layer,
                                       zeros_of)


def n_uses(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def param_defs(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": ParamDef((cfg.vocab_size, d), ("tp", "fsdp")),
        "blocks": mamba2.mixer_param_defs(cfg, (cfg.n_layers,), (None,)),
        "shared_attn": tfm.block_param_defs(
            cfg.replace(family="dense"), 0, stacked=False),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "unembed": ParamDef((d, cfg.vocab_size), ("fsdp", "tp")),
    }


def _groups(cfg):
    """(use, [mamba layer indices]) in the reference's order."""
    k = cfg.attn_every
    return [(u, range(u * k, (u + 1) * k)) for u in range(n_uses(cfg))]


def forward(cfg, params, tokens, *, remat=True, return_hidden=False):
    """-> (logits (B, S, V) f32, or the final normed hidden with
    ``return_hidden``; aux 0).  ``remat`` recomputes each mamba layer
    and each use of the shared block in the backward; the shared block's
    gradients from its uses meet in its f32 masters."""
    x = mamba2.embed(cfg, params, tokens)
    dense_cfg = cfg.replace(family="dense")
    for _, layers in _groups(cfg):
        for l in layers:
            x = L.remat(remat, mamba2._train_mixer, cfg,
                        layer(params["blocks"], l), x)
        x, _ = L.remat(remat, tfm._train_block, dense_cfg,
                       params["shared_attn"], x, 0)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params, x), aux


def init_cache_abstract(cfg, batch: int, cache_len: int):
    mcache = mamba2.init_cache_abstract(cfg, batch, cache_len)
    hd = cfg.the_head_dim()
    kv = (n_uses(cfg), batch, cache_len, cfg.n_kv_heads, hd)
    dt = compute_dtype(cfg)
    return mcache + (torch.empty(kv, dtype=dt, device="meta"),
                     torch.empty(kv, dtype=dt, device="meta"))


def prefill(cfg, params, tokens, cache_len: int):
    """-> (last-token logits (B, 1, V) f32, (conv_x, conv_bc, ssm, k, v))
    with zeros in k and v past the prompt."""
    x = mamba2.embed(cfg, params, tokens)
    B, S = tokens.shape
    cache = zeros_of(init_cache_abstract(cfg, B, cache_len), x.device)
    dense_cfg = cfg.replace(family="dense")
    for u, layers in _groups(cfg):
        for l in layers:
            x, c = mamba2.mixer(cfg, layer(params["blocks"], l), x,
                                mode="prefill")
            for dst, src in zip(cache[:3], c):
                dst[l] = src
        x, (k, v), _ = tfm.block(dense_cfg, params["shared_attn"], x, 0,
                                 mode="prefill")
        cache[3][u, :, :S] = k
        cache[4][u, :, :S] = v
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x), cache


def decode_step(cfg, params, cache, tokens, pos):
    """One step; the cache is updated in place.  -> (logits (B, V) f32,
    cache)."""
    cx, cbc, cs, kc, vc = cache
    x = mamba2.embed(cfg, params, tokens[:, None])
    dense_cfg = cfg.replace(family="dense")
    for u, layers in _groups(cfg):
        for l in layers:
            x, _ = mamba2.mixer(cfg, layer(params["blocks"], l), x,
                                mode="decode", cache=(cx[l], cbc[l], cs[l]))
        x, _, _ = tfm.block(dense_cfg, params["shared_attn"], x, 0,
                            mode="decode", cache=(kc[u], vc[u]), pos=pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x[:, 0]), cache
