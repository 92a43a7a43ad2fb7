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
place.  Under a mesh the mamba2 layers split their heads and the shared
block its attention and MLP over ``model`` as those modules do, and the
K and V lie where ``transformer.kv_layout`` places them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.params import ParamDef, layer, zeros_of


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


def whole_leaves(cfg: ModelConfig, mesh) -> frozenset:
    """Leaves placed over ``model`` whose work does not split here: the
    shared block's attention where its heads do not divide the ranks."""
    return tfm.whole_leaves(cfg.replace(family="dense"), mesh)


def _groups(cfg):
    """(use, [mamba layer indices]) in the reference's order."""
    k = cfg.attn_every
    return [(u, range(u * k, (u + 1) * k)) for u in range(n_uses(cfg))]


def forward(cfg, params, tokens, *, remat=True, return_hidden=False,
            mesh=None):
    """-> (logits (B, S, V) f32, or the final normed hidden with
    ``return_hidden``; aux 0).  ``remat`` recomputes each mamba layer
    and each use of the shared block in the backward; the shared block's
    gradients from its uses meet in its f32 masters."""
    x = mamba2.embed(cfg, params, tokens, mesh)
    dense_cfg = cfg.replace(family="dense")
    for _, layers in _groups(cfg):
        for l in layers:
            x = L.remat(remat, mamba2._train_mixer, cfg,
                        layer(params["blocks"], l), x, mesh)
        x, _ = L.remat(remat, tfm._train_block, dense_cfg,
                       params["shared_attn"], x, 0, mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return mamba2.logits(cfg, params, x, mesh), aux


def init_cache_abstract(cfg, batch: int, cache_len: int, mesh=None):
    """Meta tensors of the cache; with a ``mesh`` this rank's part."""
    kv = tfm.kv_layout(cfg, mesh, cache_len)
    return (mamba2.init_cache_abstract(cfg, batch, cache_len, mesh)
            + tfm.local_cache(cfg, batch, cache_len, mesh, kv,
                              n_layers=n_uses(cfg)))



def cache_logical_spec(cfg, tp_size: int):
    mspec = mamba2.cache_logical_spec(cfg, tp_size)
    if cfg.n_kv_heads and tp_size and cfg.n_kv_heads % tp_size == 0:
        kv = (None, "batch", None, "tp", None)
    else:
        kv = (None, "batch", "seq", None, None)
    return mspec + (kv, kv)

def prefill(cfg, params, tokens, cache_len: int, *, mesh=None):
    """-> (last-token logits (B, 1, V) f32, (conv_x, conv_bc, ssm, k, v))
    with zeros in k and v past the prompt (this rank's part under a
    mesh)."""
    x = mamba2.embed(cfg, params, tokens, mesh)
    B = tokens.shape[0]
    cache = zeros_of(init_cache_abstract(cfg, B, cache_len, mesh), x.device)
    dense_cfg = cfg.replace(family="dense")
    kv = tfm.kv_layout(cfg, mesh, cache_len)
    for u, layers in _groups(cfg):
        for l in layers:
            x, c = mamba2.mixer(cfg, layer(params["blocks"], l), x,
                                mode="prefill", mesh=mesh)
            for dst, src in zip(cache[:3], c):
                dst[l] = src
        x, (k, v), _ = tfm.block(dense_cfg, params["shared_attn"], x, 0,
                                 mode="prefill", mesh=mesh)
        tfm.store_prompt(cfg, cache[3][u], k, mesh, kv)
        tfm.store_prompt(cfg, cache[4][u], v, mesh, kv)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return mamba2.logits(cfg, params, x, mesh), cache


def decode_step(cfg, params, cache, tokens, pos, *, mesh=None, kv: str = ""):
    """One step; the cache is updated in place.  -> (logits (B, V) f32,
    cache)."""
    cx, cbc, cs, kc, vc = cache
    x = mamba2.embed(cfg, params, tokens[:, None], mesh)
    dense_cfg = cfg.replace(family="dense")
    for u, layers in _groups(cfg):
        for l in layers:
            x, _ = mamba2.mixer(cfg, layer(params["blocks"], l), x,
                                mode="decode", cache=(cx[l], cbc[l], cs[l]),
                                mesh=mesh)
        x, _, _ = tfm.block(dense_cfg, params["shared_attn"], x, 0,
                            mode="decode", cache=(kc[u], vc[u]), pos=pos,
                            mesh=mesh, kv=kv)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return mamba2.logits(cfg, params, x[:, 0], mesh), cache
