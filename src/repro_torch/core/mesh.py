"""The mesh vocabulary, on torch: the port's counterpart of
``jax.sharding`` and of the collective counting the dry runs read.

A mesh is a ``DeviceMesh`` or an ``AbstractMesh`` (names and sizes, no
ranks).  ``P`` is a partition spec (one entry per leading tensor dim: a
mesh axis name, a tuple of them, or None) and ``NamedSharding`` a spec
on a mesh; ``placements`` turns a spec into DTensor placements (a dim
sharded over ``("pod", "data")`` is ``Shard(d)`` on both, pod the
major, as in JAX).  The axis helpers read a mesh's names, sizes, this
rank's coordinates and groups, and are total: an axis the mesh lacks has
size 1, coordinate 0 and no group.

``CollectiveCounter`` is a dispatch mode that records every collective
that runs under it (kind, operand bytes, group size);
``count_collectives`` sums them per kind with the ring model of the
reference's ``launch/dryrun.parse_collectives``.

Nothing here starts a process group or touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, phys) -> int:
    """The size of mesh axis ``phys`` (1 where it is None or the mesh has
    no such axis, as the reference's ``mesh.shape`` lookups are
    guarded); of a tuple of axes, the product."""
    if phys is None or mesh is None:
        return 1
    if isinstance(phys, tuple):
        return int(np.prod([axis_size(mesh, a) for a in phys]))
    if phys not in axis_names(mesh):
        return 1
    return mesh.size(axis_names(mesh).index(phys))


def coordinate(mesh, name: str) -> int:
    """This rank's index along axis ``name`` (``lax.axis_index``)."""
    if mesh is None or name not in axis_names(mesh):
        return 0
    return mesh.get_local_rank(name)


def group(mesh, name: str):
    """The process group of axis ``name`` (None where absent)."""
    if mesh is None or name not in axis_names(mesh):
        return None
    return mesh.get_group(name)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no ranks (``jax.sharding.
    AbstractMesh``): enough to resolve specs and count per-device bytes."""
    shape: tuple
    mesh_dim_names: tuple

    def size(self, dim: int = None) -> int:
        return (int(np.prod(self.shape)) if dim is None
                else self.shape[dim])

    def get_local_rank(self, name: str) -> int:
        return 0                # no ranks: rank 0's view


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each a mesh
    axis name, a tuple of them, or None (``jax.sharding.PartitionSpec``,
    which is a tuple too)."""

    def __new__(cls, *entries):
        # a tuple of one axis reads as the axis, as in JAX
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh axis that ``spec`` puts on tensor dim d, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """One rank's shard shape of a ``shape`` tensor placed by ``spec``."""
    return tuple(n // axis_size(mesh, spec[d] if d < len(spec) else None)
                 for d, n in enumerate(shape))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def local_shape(self, shape: tuple) -> tuple:
        return local_shape(self.spec, tuple(shape), self.mesh)

    def shard_bytes(self, t: torch.Tensor) -> int:
        """One rank's bytes of ``t`` (a full-size or meta tensor) here."""
        return (int(np.prod(self.local_shape(t.shape), dtype=np.int64))
                * t.element_size())


# ------------------------------------------------ counting collectives

# the kinds, by the op's name in the dispatch (c10d and functional)
_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
          ("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "collective-permute"))


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    return 0


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """While active, every collective dispatched: (kind, operand bytes,
    group size).  A collective over a group of one rank moves nothing
    and is not counted (XLA drops it before the reference parses)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "c10d" in name and "wait" not in name:
            kind = next((k for key, k in _KINDS if key in name), None)
            if kind is not None:
                g = _group_size(args)
                # c10d's gather / scatter ops take (output, input); the
                # others and the functional ones take the input first
                src = args[1] if name.startswith("c10d.") and (
                    "gather" in name or "scatter" in name) else args[0]
                if g > 1:
                    self.ops.append((kind, _bytes(src), g))
        return func(*args, **(kwargs or {}))

    def summary(self) -> dict:
        return count_collectives(self.ops)


def count_collectives(ops) -> dict:
    """Per kind the operand bytes, and a ring-model wire-bytes estimate a
    participating device (``parse_collectives``'s model): all-gather
    result (g-1)/g, all-reduce 2 op (g-1)/g, reduce-scatter result (g-1),
    all-to-all op (g-1)/g, a permute its operand."""
    per_kind: dict = {}
    wire = 0.0
    for kind, op_b, g in ops:
        if kind == "all-gather":
            w = op_b * g * (g - 1) / g
        elif kind == "all-reduce":
            w = 2 * op_b * (g - 1) / g
        elif kind == "reduce-scatter":
            w = op_b / g * (g - 1)
        elif kind == "all-to-all":
            w = op_b * (g - 1) / g
        else:
            w = op_b
        per_kind[kind] = per_kind.get(kind, 0.0) + op_b
        wire += w
    return {"operand_bytes_by_kind": per_kind,
            "operand_bytes_total": sum(per_kind.values()),
            "wire_bytes_per_device": wire,
            "n_collectives": len(ops)}
