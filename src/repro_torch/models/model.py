"""Family dispatcher, on torch.

Port of ``repro/models/model.py``'s dispatch (``param_defs``,
``forward``, ``prefill``, ``decode_step``, ``init_cache_abstract``) for
all six families.  As in the reference, an ``encdec`` batch must carry
``"frames"`` (a ``KeyError`` otherwise) and a ``vlm`` batch may carry
``"patches"``.  The reference's abstract inputs and sharding specs serve
its XLA dry-runs, which have no counterpart here.

``stored_dtype`` says how a serving copy keeps each parameter: the
matrices that every product casts to the compute dtype
(``.astype(cfg.dtype)`` in the reference) are stored in it once, which
gives the same numbers (rounding once equals rounding at each use); the
embedding table, the router, ``A_log``, ``dt_bias`` and the norm scales
stay f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.params import compute_dtype

_FAMS = {
    "dense": tfm, "moe": tfm, "vlm": tfm,
    "ssm": mamba2, "hybrid": hybrid, "encdec": encdec,
}
# the matrices that the reference casts to the compute dtype before every
# product: transformer.py (_attn_block, _mlp_block, embed_tokens and the
# unembed), moe.py (_moe_dense), mamba2.py (_project, the conv, Dskip,
# out_proj) and encdec.py (_mha, _mlp, the cross K/V)
MATMUL_WEIGHTS = frozenset((
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "unembed",
    "we_g", "we_u", "we_d", "se_wg", "se_wu", "se_wd",
    "patch_proj",
    "in_zx", "in_bc", "in_dt", "out_proj", "conv_x", "conv_bc", "Dskip",
    "w1", "w2", "x_wq", "x_wk", "x_wv", "x_wo"))


def family_module(cfg: ModelConfig):
    return _FAMS[cfg.family]


def stored_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype a serving copy keeps parameter ``name`` in."""
    return compute_dtype(cfg) if name in MATMUL_WEIGHTS else torch.float32


def param_defs(cfg: ModelConfig):
    return family_module(cfg).param_defs(cfg)


def _inputs(cfg, batch: dict) -> dict:
    if cfg.family == "encdec":
        return {"frames": batch["frames"]}
    if cfg.family == "vlm":
        return {"patches": batch.get("patches")}
    return {}


def forward(cfg, params, batch: dict):
    """-> (logits (B, S, V) f32, moe aux loss)."""
    return family_module(cfg).forward(cfg, params, batch["tokens"],
                                      **_inputs(cfg, batch))


def prefill(cfg, params, batch: dict, cache_len: int):
    """-> (last-token logits (B, 1, V) f32, the family's cache)."""
    return family_module(cfg).prefill(cfg, params, batch["tokens"],
                                      cache_len, **_inputs(cfg, batch))


def decode_step(cfg, params, cache, tokens, pos):
    """-> (logits (B, V) f32, the cache, updated in place)."""
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def init_cache_abstract(cfg, batch: int, cache_len: int):
    return family_module(cfg).init_cache_abstract(cfg, batch, cache_len)
