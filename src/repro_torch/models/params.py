"""Parameter definitions and their initialisation, on torch.

Port of ``repro/models/params.py``.  Params are nested dicts of tensors;
each leaf is declared once as a ``ParamDef`` (shape, logical partition
spec, init, scale, dtype).  ``resolve_spec`` maps the logical names onto
the axes a mesh has ("data", "model", optionally "pod") by the
reference's rule (divisibility-checked, trailing ``None``s dropped) and
returns the spec as the tuple ``P(...)`` reads as; ``placements`` turns
it into DTensor placements on a ``DeviceMesh`` (a dim sharded over
``("pod", "data")`` is ``Shard(d)`` on both, pod the major, as in JAX).
A mesh here is a ``DeviceMesh`` or an ``AbstractMesh`` (names and sizes,
no ranks), as the reference's ``resolve_spec`` needs only those.

Under a mesh the port's steps run SPMD on local tensors (the
reference's ``shard_map`` regions): activations are split over the
batch axes and replicated over ``model``; each weight keeps its
``model`` shard and the work it feeds splits over ``model`` (Megatron's
column- and row-parallel products), joined by the model-axis
collectives below, which carry the matching backward.  Where the
reference's ``seq_shard`` condition holds, the transformer's training
forward keeps the residual stream as this rank's shard of the sequence
(Megatron sequence parallelism): each layer gathers its normed input
over S (``seq_gather``) and reduce-scatters its output over S
(``seq_scatter``).  ``seq_shard`` and ``shard_heads`` are the identity
without a mesh, as the reference's are.

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
import torch.distributed as dist

from repro_torch.core.mesh import (AbstractMesh, NamedSharding, P,  # noqa: F401
                                   axis_names, axis_size, coordinate,
                                   group, local_shape, placements)


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple  # logical partition spec, one entry per dim (None ok)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0
    dtype: Any = torch.float32

    def abstract(self) -> torch.Tensor:
        """The leaf on the meta device: shape and dtype, no storage."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


# logical axis name -> function(mesh axis names) -> physical axis (or None)
_LOGICAL = {
    "batch": lambda names: tuple(a for a in ("pod", "data")
                                 if a in names) or None,
    "fsdp": lambda names: "data" if "data" in names else None,
    "tp": lambda names: "model" if "model" in names else None,
    "seq": lambda names: "model" if "model" in names else None,
    "pod": lambda names: "pod" if "pod" in names else None,
    None: lambda names: None,
}


def _axis_size(mesh, phys) -> int:
    return axis_size(mesh, phys)


def resolve_spec(logical: tuple, shape: tuple, mesh) -> P:
    """Logical spec -> the partition spec valid on ``mesh``
    (divisibility-checked)."""
    if mesh is None:
        return P()
    names = axis_names(mesh)
    out = []
    for dim, log in zip(shape, logical):
        phys = _LOGICAL[log](names) if log in _LOGICAL else None
        if phys is not None and dim % _axis_size(mesh, phys) == 0 and dim > 0:
            out.append(phys)
        else:
            out.append(None)
    # trailing Nones are implicit
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def named_sharding(mesh, logical: tuple, shape: tuple):
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(logical, shape, mesh))


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


def abstract_params(defs) -> dict:
    return _map_defs(lambda d: d.abstract(), defs)


def param_shardings(defs, mesh) -> dict:
    return _map_defs(lambda d: named_sharding(mesh, d.logical, d.shape), defs)


def param_pspecs(defs, mesh) -> dict:
    return _map_defs(lambda d: resolve_spec(d.logical, d.shape, mesh), defs)


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


# ------------------------------------------------ DTensors and local parts

BATCH_AXES = ("pod", "data")


def _spec_axes(spec: tuple, d: int) -> tuple:
    e = spec[d] if d < len(spec) else None
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def local_part(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of ``full`` (the same tensor on every rank): a
    view, major axis first along a dim sharded over several."""
    out = full
    for d in range(full.ndim):
        axes = _spec_axes(sharding.spec, d)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * axis_size(sharding.mesh, a) + coordinate(
                sharding.mesh, a)
            n *= axis_size(sharding.mesh, a)
        size = full.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out


def contiguous_stride(shape) -> tuple:
    return tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                 for i in range(len(shape)))


def shard_tensor(full: torch.Tensor, sharding: Optional[NamedSharding]):
    """``full`` (the same on every rank) as a DTensor placed by
    ``sharding``: each rank keeps its own shard (a copy), no collective.
    ``full`` itself where ``sharding`` is None."""
    if sharding is None:
        return full
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_part(full, sharding).clone(),
                              sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def gather_local(t, keep: tuple = ()) -> torch.Tensor:
    """The local tensor of DTensor ``t`` gathered over every mesh axis
    but those in ``keep`` (``lax.all_gather`` of a ``shard_map`` input);
    its local tensor itself (no copy) when nothing needs gathering.  A
    plain tensor is returned as it is.  The list form of all-gather
    (``_all_gather``), minor axes first, so that gloo gathers CUDA
    tensors too (its functional all-gather, which DTensor's
    ``redistribute`` calls, does not)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    mesh, out = t.device_mesh, t.to_local()
    for a, p in reversed(list(zip(axis_names(mesh), t.placements))):
        if a not in keep and p.is_shard() and axis_size(mesh, a) > 1:
            out = _all_gather(out, p.dim, group(mesh, a))
    return out


def reduce_to(g: torch.Tensor, like, keep: tuple = (),
              partial: bool = True) -> torch.Tensor:
    """A gradient of ``gather_local(like, keep)`` computed on this rank's
    batch shard, summed over the batch axes and cut to ``like``'s
    placements: this rank's local gradient shard (a reduce-scatter where
    ``like`` is sharded over a batch axis).  ``partial=False``: every
    rank ran the whole batch, so nothing is summed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = like.device_mesh
    names = axis_names(mesh)
    src = [p if (a in keep and not p.is_replicate())
           else Partial() if (a in BATCH_AXES and partial) else Replicate()
           for a, p in zip(names, like.placements)]
    if all(axis_size(mesh, a) == 1 for a in names):
        return g
    d = DTensor.from_local(g, mesh, src, run_check=False,
                           shape=like.shape, stride=like.stride())
    return d.redistribute(mesh, like.placements).to_local()


def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (a partial value on each rank, the same over ``model``)
    summed over the batch axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    names = axis_names(mesh)
    if all(axis_size(mesh, a) == 1 for a in names if a in BATCH_AXES):
        return x
    src = [Partial() if a in BATCH_AXES else Replicate() for a in names]
    return DTensor.from_local(x, mesh, src, run_check=False).full_tensor()


# ----------------------------------------------- model-axis collectives
# Megatron's f / g pair: a tensor replicated over `model` that enters a
# model-sharded region needs its gradients summed over `model` on the
# way out of the backward (``to_model``); partial results leaving the
# region are summed in the forward (``reduce_model``); heads computed
# apart are concatenated (``gather_model``), whose backward keeps this
# rank's slice (the gradient after it is the same on every rank).  A sum
# that feeds each rank's own work again (the gated norm's sum of squares
# over d_in) is summed both ways (``sum_model``); shards gathered for
# work that differs by rank (a weight's column blocks) sum their
# gradients back into the shards (``gather_sum``, a reduce-scatter).


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.grp)
        return g, None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=grp)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grp):
        n = dist.get_world_size(grp)
        ctx.dim, ctx.rank, ctx.n = dim, dist.get_rank(grp), n
        return _all_gather(x, dim, grp)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank], None, None


def _all_gather(x, dim: int, grp):
    """The ranks' ``x`` concatenated along ``dim`` (the list form of
    all-gather, which gloo also runs on CUDA tensors)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, x.contiguous(), group=grp)
    return torch.cat(parts, dim=dim)


class _GatherSum(torch.autograd.Function):
    """All-gather whose ranks use the result differently (different batch
    shards over ``data``, different column blocks over ``model``): the
    backward sums the gradients over the axis and keeps this rank's
    slice (a reduce-scatter, ``lax.all_gather``'s transpose)."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        dim = dim % x.ndim
        ctx.dim, ctx.n, ctx.grp = dim, dist.get_world_size(grp), grp
        return _all_gather(x, dim, grp)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.grp), None, None


def _reduce_scatter(x, dim: int, grp):
    """This rank's ``1/n`` slice along ``dim`` of ``x`` summed over the
    ``n`` ranks of ``grp``."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // dist.get_world_size(grp),)
                       + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=grp)
    return out.movedim(0, dim)


class _ScatterSum(torch.autograd.Function):
    """Partial sums over the ranks to this rank's slice of their total
    along ``dim`` (a reduce-scatter); the backward gathers the slices'
    gradients (an all-gather), ``_GatherSum``'s mirror."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        ctx.dim, ctx.grp = dim % x.ndim, grp
        return _reduce_scatter(x, ctx.dim, grp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.grp), None, None


def gather_data(x, dim: int, mesh):
    """``x``'s shards over ``data`` concatenated along ``dim`` (the
    reference's FSDP gather inside ``shard_map``)."""
    if axis_size(mesh, "data") <= 1:
        return x
    return _GatherSum.apply(x, dim, group(mesh, "data"))


def _model_group(mesh):
    return group(mesh, "model") if axis_size(mesh, "model") > 1 else None


def to_model(x, mesh):
    grp = _model_group(mesh)
    return x if grp is None else _ToModel.apply(x, grp)


def reduce_model(x, mesh):
    grp = _model_group(mesh)
    return x if grp is None else _ReduceModel.apply(x, grp)


def sum_model(x, mesh):
    """``x`` summed over ``model``, its gradient summed too: a sum whose
    result each rank then uses for its own shard of the work."""
    return to_model(reduce_model(x, mesh), mesh)


def gather_model(x, dim: int, mesh):
    grp = _model_group(mesh)
    return x if grp is None else _GatherModel.apply(x, dim, grp)


def gather_sum(x, dim: int, mesh):
    """``x``'s blocks over ``model`` concatenated along ``dim``, for work
    that differs by rank (its backward is a reduce-scatter)."""
    grp = _model_group(mesh)
    return x if grp is None else _GatherSum.apply(x, dim, grp)


def model_slice(x, dim: int, start: int, size: int, mesh):
    """``x[..., start:start + size, ...]`` along ``dim`` of a tensor
    replicated over ``model``, for this rank's share of the work."""
    return to_model(x, mesh).narrow(dim, start, size)


def col_blocks(h, w, starts, n: int, mesh):
    """Columns ``[s, s + n)`` of ``h @ W`` for each ``s`` in ``starts``,
    side by side, where this rank holds ``w``, a block of W's columns
    over ``model`` (``h`` already ``to_model``-ed).  The smaller of W and
    the product is gathered (backward: reduce-scatter): a decode step
    gathers its few rows of the product, a sequence gathers W and
    multiplies only the blocks it keeps."""
    if h.numel() // h.shape[-1] < w.shape[0]:
        y = gather_sum(h @ w, -1, mesh)
        return torch.cat([y.narrow(-1, s, n) for s in starts], dim=-1)
    w = gather_sum(w, -1, mesh)
    return h @ torch.cat([w.narrow(-1, s, n) for s in starts], dim=-1)


# ---------------------------------------- sequence parallelism (Megatron)
# Where ``seq_parallel`` holds, a (B, S, d) residual is this rank's S/tp
# shard of the sequence.  The first split of a tensor replicated over
# ``model`` is ``seq_shard`` (``model_slice``: a narrow, its gradients
# summed).  Work split over ``model`` (heads, d_ff, experts) takes its
# input from ``seq_gather`` (all-gather over S; backward reduce-scatter:
# each rank's gradient is its own work's part) and gives its partial
# output to ``seq_scatter`` (reduce-scatter over S; backward all-gather).
# Work every rank runs whole (heads that do not divide the ranks) takes
# ``gather_model`` over S (its gradients are the same on every rank) and
# ``seq_part`` of its output.


def seq_parallel(shape, mesh) -> bool:
    """The reference's ``seq_shard`` condition on a (B, S, d) shape: a
    ``model`` axis of more than one rank that divides S."""
    if mesh is None or "model" not in axis_names(mesh):
        return False
    tp = axis_size(mesh, "model")
    return tp > 1 and len(shape) >= 3 and shape[1] % tp == 0


def seq_part(x, mesh):
    """This rank's shard over S of ``x``, replicated over ``model``."""
    n = x.shape[1] // axis_size(mesh, "model")
    return model_slice(x, 1, coordinate(mesh, "model") * n, n, mesh)


def seq_shard(x, mesh=None):
    """The reference's sequence-parallel constraint on (B, S, d) residuals
    (batch over the batch axes, S over ``model``): this rank's shard of
    the sequence where ``seq_parallel`` holds, ``x`` itself otherwise."""
    return seq_part(x, mesh) if seq_parallel(x.shape, mesh) else x


def seq_gather(x, mesh):
    """The ranks' sequence shards of ``x`` concatenated over S, for work
    split over ``model`` (its backward is a reduce-scatter)."""
    return _GatherSum.apply(x, 1, group(mesh, "model"))


def seq_scatter(x, mesh):
    """Partial (B, S, d) results summed over ``model``, this rank's shard
    of S kept (its backward is an all-gather)."""
    return _ScatterSum.apply(x, 1, group(mesh, "model"))


def shard_heads(t, mesh=None):
    """(B, S, H, hd) attention tensors replicated over ``model``: this
    rank's heads when H divides (the reference's constraint, whose
    redistribute of a replicated tensor is a slice; its backward sums
    over ``model``), else as they are.  The identity without a mesh."""
    tp = axis_size(mesh, "model")
    if tp <= 1 or t.shape[2] % tp:
        return t
    n = t.shape[2] // tp
    return model_slice(t, 2, coordinate(mesh, "model") * n, n, mesh)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves(defs))
