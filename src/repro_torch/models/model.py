"""Family dispatcher, on torch.

Port of ``repro/models/model.py``'s dispatch (``param_defs``,
``forward``, ``prefill``, ``decode_step``, ``init_cache_abstract``) for
the ``dense`` family; the other families are not ported yet and raise.
The reference's abstract inputs and sharding specs serve its XLA
dry-runs, which have no counterpart here.

``stored_dtype`` says how a serving copy keeps each parameter: the
matrices that every product casts to the compute dtype
(``.astype(cfg.dtype)`` in the reference) are stored in it once, which
gives the same numbers (rounding once equals rounding at each use); the
embedding table and the norm scales stay f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

_FAMS = {"dense": tfm}
# the matrices that the reference casts to the compute dtype before every
# product (transformer.py: _attn_block, _mlp_block, forward/prefill/decode)
MATMUL_WEIGHTS = frozenset(
    ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "unembed"))


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP queue "
            f"1, item 10); the port runs {sorted(_FAMS)}")
    return _FAMS[cfg.family]


def stored_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype a serving copy keeps parameter ``name`` in."""
    return getattr(torch, cfg.dtype) if name in MATMUL_WEIGHTS else (
        torch.float32)


def param_defs(cfg: ModelConfig):
    return family_module(cfg).param_defs(cfg)


def forward(cfg, params, batch: dict):
    return family_module(cfg).forward(cfg, params, batch["tokens"])


def prefill(cfg, params, batch: dict, cache_len: int):
    return family_module(cfg).prefill(cfg, params, batch["tokens"],
                                      cache_len)


def decode_step(cfg, params, cache, tokens, pos):
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def init_cache_abstract(cfg, batch: int, cache_len: int):
    return family_module(cfg).init_cache_abstract(cfg, batch, cache_len)
