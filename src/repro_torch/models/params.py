"""Parameter definitions and their initialisation, on torch.

Port of ``repro/models/params.py``.  Params are nested dicts of tensors;
each leaf is declared once as a ``ParamDef`` (shape, logical partition
spec, init, scale, dtype).  The reference's mesh machinery
(``resolve_spec``, ``named_sharding``, ``param_shardings``,
``param_pspecs``) has no counterpart here: the port runs on one card, so
``seq_shard`` and ``shard_heads`` are the identity, as the reference's
are with ``mesh=None``.

Initial values are drawn from an explicit ``torch.Generator`` on the
target device with the reference's std (``scale / sqrt(fan_in)``).  The
two frameworks draw different numbers from one seed; the tests carry the
reference's values across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple  # logical partition spec, one entry per dim (None ok)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0
    dtype: Any = torch.float32


def init_leaf(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    """One leaf on ``generator``'s device."""
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return x.mul_(std).to(d.dtype)


def _leaves(defs, path=()):
    """(path, ParamDef) of every leaf, in sorted key order (as
    ``jax.tree.flatten`` walks a dict)."""
    if isinstance(defs, ParamDef):
        yield path, defs
        return
    for key in sorted(defs):
        yield from _leaves(defs[key], path + (key,))


def init_params(defs, generator: torch.Generator, *,
                cast: Optional[Callable[[str, torch.Tensor],
                                        torch.Tensor]] = None) -> dict:
    """A params tree for ``defs``, drawn one leaf at a time on
    ``generator``'s device.  ``cast(name, leaf)`` (name = the leaf's own
    key) is applied to each leaf as soon as it is drawn, so a model whose
    matrices are kept in bf16 never holds a second f32 copy of itself."""
    out: dict = {}
    for path, d in _leaves(defs):
        leaf = init_leaf(d, generator)
        if cast is not None:
            leaf = cast(path[-1], leaf)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def seq_shard(x, mesh=None):
    """The identity: one card has no sequence axis to shard over."""
    return x


def shard_heads(t, mesh=None):
    """The identity: one card has no head axis to shard over."""
    return t


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves(defs))
