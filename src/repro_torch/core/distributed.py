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
caller initialises the group: gloo for CPU tensors (and for CUDA tensors
of several ranks on one card), NCCL when each rank has a card of its own.
The reference's XLA dry-run helpers (``shard_map_compat``,
``abstract_fetch_lowered``) have no counterpart yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.core.layout import Store


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

    def fetch(self, block_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """(graph blocks (n, gblk) int32, vector blocks (n, vblk) f32) of
        ``block_ids`` on every rank, by one all-reduce.  An id that no
        rank owns gives zero rows, as in the reference."""
        ids = torch.as_tensor(np.asarray(block_ids).reshape(-1),
                              dtype=torch.int64, device=self.device)
        local = ids - self.lo
        mine = (local >= 0) & (local < self.per_shard)
        at = torch.where(mine, local, 0)
        rows = torch.cat([self.graph_buf[at],
                          self.vec_buf[at].view(torch.int32)], dim=1)
        rows = torch.where(mine[:, None], rows, 0)
        dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=self.group)
        self.stats["fetches"] += 1
        self.stats["operand_bytes"] += rows.numel() * rows.element_size()
        gblk = self.graph_buf.shape[1]
        return rows[:, :gblk], rows[:, gblk:].contiguous().view(torch.float32)

    # ------------------------------------------------------- rebalancing

    def owner_of(self, block_id: int) -> int:
        return block_id // self.per_shard

    def partition_owners(self, store: Store) -> np.ndarray:
        """(P,) owner shard of each partition's span start — the
        partition->memory-instance map the heartbeat monitor rebalances."""
        starts = store.meta_table[:, 0]
        return (starts // self.per_shard).astype(np.int32)
