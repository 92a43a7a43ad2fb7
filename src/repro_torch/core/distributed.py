"""Distributed memory pool: the store sharded across the ranks of a
``torch.distributed`` process group.

Port of ``repro/core/distributed.py``.  The paper's memory pool is one
big registered region on memory nodes; a compute node READs blocks by
remote address.  Here each rank of the group owns ``n_blocks / world``
contiguous blocks of the block buffers (one "memory instance"), the
metadata table is replicated on every rank (the paper caches it in every
compute instance), and a doorbell fetch is ONE collective: every owner
contributes its requested blocks, zero rows elsewhere, and one
``all_reduce(SUM)`` assembles the staging buffer on every rank (the
reference's ``psum`` over the mesh axis).

The f32 vector rows travel as their int32 bits, concatenated to the graph
rows, so one integer all-reduce carries both buffers; exactly one owner
adds non-zero bits to each row, so the result is bit-exact (``-0.0``
included, which an f32 sum would turn into ``+0.0``).

One fetch is one collective (one network round trip, the paper's
metric); ``stats`` counts the fetches and the operand bytes, the numbers
the reference's docstring ties to its dry-run's collective parser.  The
reference's ``fetch_fn`` issues two ``psum``s, one a buffer; the port's
fuses them into one all-reduce of the same operand bytes (the graph
rows' 4-byte ints and the vectors' 4-byte floats side by side), so its
count is 1 where the reference's is 2.  The caller initialises the
group: gloo for CPU tensors (and for CUDA tensors of several ranks on
one card), NCCL when each rank has a card of its own.

``shard_map_compat`` runs a function on the local shards of DTensors
(the reference's ``shard_map``); ``abstract_fetch_counted`` is the twin
of ``abstract_fetch_lowered``: the fetch traced on fake tensors over the
fake backend, its collectives counted, no store allocated.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.core.layout import Store
from repro_torch.core.mesh import (CollectiveCounter, P, axis_size, group,
                                   placements)


def shard_map_compat(f, *, mesh, in_specs, out_specs, check: bool = False):
    """``f`` over the local shards of its DTensor arguments, each first
    placed as its entry of ``in_specs`` says (a plain tensor is passed as
    it is); its outputs wrapped as DTensors placed by ``out_specs`` (one
    ``P`` or a tuple of them).  ``check`` asks DTensor to verify that a
    replicated output agrees over the ranks."""
    from torch.distributed.tensor import DTensor

    def run(*args):
        loc = [a.redistribute(mesh, placements(sp, mesh)).to_local()
               if isinstance(a, DTensor) else a
               for a, sp in zip(args, in_specs)]
        out = f(*loc)

        def wrap(o, sp):
            return DTensor.from_local(o, mesh, placements(sp, mesh),
                                      run_check=check)
        if isinstance(out_specs, P):
            return wrap(out, out_specs)
        return tuple(wrap(o, sp) for o, sp in zip(out, out_specs))
    return run


def fetch_rows(graph_buf, vec_buf, ids, *, lo: int, per_shard: int,
               group=None):
    """One doorbell fetch on this rank's shard (rows ``lo .. lo +
    per_shard`` of the region): its requested rows, zero elsewhere, summed
    over ``group`` by ONE all-reduce of the graph rows and the vector
    rows' int32 bits side by side.  -> (graph rows, vector rows)."""
    local = ids - lo
    mine = (local >= 0) & (local < per_shard)
    at = torch.where(mine, local, 0)
    rows = torch.cat([graph_buf[at], vec_buf[at].view(torch.int32)], dim=1)
    rows = torch.where(mine[:, None], rows, 0)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    gblk = graph_buf.shape[1]
    return rows[:, :gblk], rows[:, gblk:].contiguous().view(torch.float32)


def _pad_blocks(arr: np.ndarray, mult: int) -> np.ndarray:
    pad = (-arr.shape[0]) % mult
    if pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


class ShardedStore:
    """This rank's shard of a store sharded over ``group`` (the default
    group when None), on ``device``."""

    def __init__(self, store: Store, *, group=None, device="cuda"):
        self.spec = store.spec
        self.group = group
        self.device = resolve_device(device)
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        g = _pad_blocks(store.graph_buf, self.world)
        v = _pad_blocks(store.vec_buf, self.world)
        self.n_blocks = g.shape[0]
        self.per_shard = self.n_blocks // self.world
        self.lo = self.rank * self.per_shard
        rows = slice(self.lo, self.lo + self.per_shard)
        self.graph_buf = torch.tensor(g[rows], dtype=torch.int32,
                                      device=self.device)
        self.vec_buf = torch.tensor(v[rows], dtype=torch.float32,
                                    device=self.device)
        # compute-pool replica (paper: cached in every compute instance)
        self.meta_table = torch.tensor(store.meta_table, dtype=torch.int32,
                                       device=self.device)
        self.stats = {"fetches": 0, "operand_bytes": 0}

    # -------------------------------------------------------------- fetch

    def fetch_fn(self):
        """``fetch(graph_buf, vec_buf, block_ids) -> (g_blocks,
        v_blocks)`` over this rank's shards: ONE collective launch per
        call (= one doorbell round trip), the same rows on every rank."""
        lo, per_shard, grp = self.lo, self.per_shard, self.group

        def fetch(graph_buf, vec_buf, block_ids):
            return fetch_rows(graph_buf, vec_buf, block_ids, lo=lo,
                              per_shard=per_shard, group=grp)
        return fetch

    def fetch(self, block_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """(graph blocks (n, gblk) int32, vector blocks (n, vblk) f32) of
        ``block_ids`` on every rank, by one all-reduce.  An id that no
        rank owns gives zero rows, as in the reference."""
        ids = torch.as_tensor(np.asarray(block_ids).reshape(-1),
                              dtype=torch.int64, device=self.device)
        g, v = self.fetch_fn()(self.graph_buf, self.vec_buf, ids)
        self.stats["fetches"] += 1
        self.stats["operand_bytes"] += (g.numel() * g.element_size()
                                        + v.numel() * v.element_size())
        return g, v

    # ------------------------------------------------------- rebalancing

    def owner_of(self, block_id: int) -> int:
        return block_id // self.per_shard

    def partition_owners(self, store: Store) -> np.ndarray:
        """(P,) owner shard of each partition's span start — the
        partition->memory-instance map the heartbeat monitor rebalances."""
        starts = store.meta_table[:, 0]
        return (starts // self.per_shard).astype(np.int32)


def abstract_fetch_counted(store: Store, mesh, m_blocks: int,
                           axis: str = "model") -> dict:
    """Dry run: the fetch of a doorbell batch of ``m_blocks`` spans traced
    on fake tensors (the store's shapes, nothing allocated) over ``mesh``
    (a mesh of the fake backend), its collectives counted as
    ``core.mesh.count_collectives`` counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = store.spec
    tp = axis_size(mesh, axis)
    n_blocks = store.graph_buf.shape[0] + ((-store.graph_buf.shape[0]) % tp)
    per_shard = n_blocks // tp
    with FakeTensorMode(), CollectiveCounter() as cc:
        g = torch.empty((per_shard, spec.gblk), dtype=torch.int32)
        v = torch.empty((per_shard, spec.vblk), dtype=torch.float32)
        ids = torch.zeros(m_blocks * spec.fetch_blocks, dtype=torch.int64)
        fetch_rows(g, v, ids, lo=0, per_shard=per_shard,
                   group=group(mesh, axis))
    return cc.summary()
