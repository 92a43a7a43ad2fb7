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


# a leaf of more elements than this is drawn in slices along axis 0, each
# cast to the stored dtype as soon as it is drawn: qwen3-moe's stacked
# expert matrices (48, 128, 2048, 768) would otherwise pass through a
# 38.7 GB f32 temporary before the cast
SLICE_ELEMS = 1 << 26


def init_leaf(d: ParamDef, generator: torch.Generator,
              cast: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
    """One leaf on ``generator``'s device, passed through ``cast`` (the
    identity by default).  A leaf of more than ``SLICE_ELEMS`` elements
    is drawn one axis-0 slice at a time straight into the cast's dtype,
    so the peak is the cast leaf plus one f32 slice."""
    dev = generator.device
    cast = cast or (lambda t: t)
    if d.init == "zeros":
        return cast(torch.zeros(d.shape, dtype=d.dtype, device=dev))
    if d.init == "ones":
        return cast(torch.ones(d.shape, dtype=d.dtype, device=dev))
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))

    def draw(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return cast(x.mul_(std).to(d.dtype))

    n = int(np.prod(d.shape))
    if n <= SLICE_ELEMS or len(d.shape) < 2 or d.shape[0] < 2:
        return draw(d.shape)
    rows = max(1, SLICE_ELEMS // (n // d.shape[0]))
    first = draw((min(rows, d.shape[0]),) + tuple(d.shape[1:]))
    out = torch.empty(d.shape, dtype=first.dtype, device=dev)
    out[:first.shape[0]] = first
    del first
    for lo in range(rows, d.shape[0], rows):
        hi = min(lo + rows, d.shape[0])
        out[lo:hi] = draw((hi - lo,) + tuple(d.shape[1:]))
    return out


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
    key) is applied to each leaf as soon as it is drawn (to each slice of
    a large one, ``init_leaf``), so a model whose matrices are kept in
    bf16 never holds a second f32 copy of itself."""
    out: dict = {}
    for path, d in _leaves(defs):
        leaf = init_leaf(d, generator, None if cast is None else (
            lambda t, name=path[-1]: cast(name, t)))
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def compute_dtype(cfg) -> torch.dtype:
    """The compute dtype ``cfg.dtype`` names."""
    return getattr(torch, cfg.dtype)


def layer(blocks: dict, l: int) -> dict:
    """Layer ``l``'s parameters: views into the stacked tensors (the
    reference scans over the leading axis; the port loops and indexes)."""
    return {name: t[l] for name, t in blocks.items()}


def zeros_of(abstract, device) -> tuple:
    """Zeroed tensors on ``device`` of the shapes and dtypes of the meta
    tensors ``abstract`` (an ``init_cache_abstract`` result)."""
    return tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for s in abstract)


def seq_shard(x, mesh=None):
    """The identity: one card has no sequence axis to shard over."""
    return x


def shard_heads(t, mesh=None):
    """The identity: one card has no head axis to shard over."""
    return t


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves(defs))
