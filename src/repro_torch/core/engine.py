"""DHNSWEngine — the paper's system, end to end, on torch.

Port of ``repro/core/engine.py``.  ``EngineConfig`` is a copy of the
reference's with every field, so one set of keyword arguments drives both
engines; the engine is a thin facade over ``ComputeClient`` + a
``MemoryPool`` (``repro_torch/pool``).

Three schemes (the paper's evaluation §4): ``naive`` (every (query,
partition) need is its own remote read), ``no_doorbell`` (meta-HNSW
caching + query-aware batched loading, one round trip per span) and
``full`` (+ doorbell batching).  Search inside a loaded partition is
``graph`` (the sub-HNSW beam walk + overflow scan) or ``scan`` (an exact
brute scan of the fetched partition).

Every tensor lives on ``device`` — ``"cuda"`` unless the caller asks for
``"cpu"``.  Asking for ``"cuda"`` on a machine without a card raises;
nothing falls back to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import (RDMA_100G, TPU_ICI, Fabric,  # noqa: F401
                                         NetLedger)
from repro_torch.core.scheduler import pow2_pad  # noqa: F401  (re-export)
from repro_torch.obs.trace import TRACER

MODES = ("naive", "no_doorbell", "full")
POOLS = ("local", "sim_rdma", "sharded", "remote")


@dataclass
class EngineConfig:
    mode: str = "full"              # naive | no_doorbell | full
    search_mode: str = "graph"      # graph (paper) | scan (beyond-paper)
    b: int = 2                      # partitions probed per query (top-b)
    ef: int = 48                    # sub-HNSW beam width (efSearch)
    n_rep: int = 500                # representatives (= partitions)
    cache_frac: float = 0.10        # compute-pool cache: 10% of partitions
    doorbell: int = 8               # spans per doorbell batch
    fabric: Fabric = TPU_ICI
    use_gather_kernel: bool = False  # CUDA doorbell gather (plain on CPU)
    meta_levels: int = 3
    sub_M0: int = 16
    ef_construction: int = 80
    seed: int = 0
    # quantized resident tier (src/repro/quant): "none" keeps the exact
    # single-tier path bit-identical; "int8" searches in two stages —
    # quantized candidate generation over a LARGE int8 tier, then exact
    # re-ranking of only the candidate rows
    quant: str = "none"             # none | int8
    quant_group: int = 32           # int8 codec group size (divides dim)
    rerank_m: int = 0               # stage-2 candidate pool (0 = 2k)
    exact_frac: float = 0.25        # share of the cache BYTE budget kept
                                    # as full-precision (exact-tier) slots
    # memory-pool transport (repro/pool): "local" is in-process and
    # bit-identical; "sim_rdma" adds the per-verb latency model;
    # "sharded" splits the region group-granularly across n_shards
    # child pools (per-shard doorbell fan-out, pluggable placement)
    pool: str = "local"             # local | sim_rdma | sharded | remote
    n_shards: int = 2               # shards under pool="sharded"
    # pool="remote": TCP pool-server endpoints ("host:port" strings or
    # (host, port) tuples).  One endpoint = a single RemotePool; several
    # = a ShardedPool whose children are RemotePools, one per server
    # process (placement/shard_parallel apply).  Also used by
    # pool="sharded" + shard_transport="remote" (len == n_shards).
    endpoints: Optional[tuple] = None
    # pool="remote" bearer (repro/rdma): "tcp" frames WR lists over the
    # socket wire to PoolServer processes at `endpoints`; "loopback"
    # runs the same verbs/QP path against an in-process HostRegion (no
    # endpoints, no sockets) — the conformance bearer
    bearer: str = "tcp"             # tcp | loopback
    # placement: policy name ("round_robin" | "size_balanced" | "freq")
    # or a ready PlacementPolicy instance (one engine per instance —
    # policies are stateful)
    placement: object = "round_robin"
    shard_transport: str = "local"  # child transport: local | sim_rdma
    # per-shard fabrics (len == n_shards) to model stragglers; None
    # replicates `fabric` on every shard
    shard_fabrics: Optional[tuple] = None
    shard_parallel: bool = True     # shards answer doorbell batches
                                    # concurrently (trips/modeled time
                                    # reduce by max); False sums
    # replication: copies of every group across distinct shards (clamped
    # to the shard count).  R >= 2 makes the sharded/remote pool survive
    # a node death: reads fail over to a surviving replica and the dead
    # node's groups re-replicate from the host region.  R = 1 keeps the
    # pre-replication behavior (a death surfaces PoolUnavailableError).
    replication: int = 1
    # per-shard capacity budgets in bytes (len == shard count); groups
    # that would overflow a shard spill to the next-best one.  None =
    # unbounded shards.
    shard_budgets: Optional[tuple] = None
    # straggler detection cadence for sharded/remote pools: run the
    # tail-divergence detector over the per-(verb, shard) latency
    # histograms every N charged span reads and penalize flagged shards
    # in replica-read ranking (0 = off; manual pool.check_stragglers()
    # always works).  Needs replication >= 2 to actually reroute.
    straggler_check_every: int = 0
    # stage-1 flat kernel route: "off" keeps the per-pair path; "auto"
    # routes flat (scan-mode) stage 1 through the fused quant_topk kernel
    # when the quantized tier is dense-resident (capacity >=
    # n_partitions) — the CUDA kernel for tensors on the card, its plain
    # torch version for tensors on the CPU; "ref" forces the plain version
    quant_kernel: str = "off"       # off | auto | ref
    # durable / streaming ingestion (repro.ingest): the default spill
    # directory for build_streaming and, for remote pools, where the
    # servers keep WAL + checkpoints (operational knob, not wired into
    # pool construction — servers own their own --data-dir)
    data_dir: Optional[str] = None


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch sees no "
                           "CUDA device on this machine")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class DHNSWEngine:
    """Build once, then ``search`` and ``insert`` batches.

    Facade over ``ComputeClient + MemoryPool``; ``engine.client`` and
    ``engine.pool`` expose the boundary itself."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 device="cuda", **kw):
        from repro_torch.pool import make_pool_factory
        from repro_torch.pool.compute import ComputeClient
        self.cfg = config or EngineConfig(**kw)
        self.device = resolve_device(device)
        for name, allowed in (("mode", MODES), ("quant", ("none", "int8")),
                              ("pool", POOLS),
                              ("quant_kernel", ("off", "auto", "ref"))):
            if getattr(self.cfg, name) not in allowed:
                raise ValueError(f"EngineConfig.{name}="
                                 f"{getattr(self.cfg, name)!r} not in "
                                 f"{allowed}")
        if self.cfg.pool == "sharded":
            if self.cfg.n_shards < 1:
                raise ValueError(f"EngineConfig.n_shards="
                                 f"{self.cfg.n_shards} must be >= 1")
            if (self.cfg.shard_transport == "remote"
                    and self.cfg.bearer == "tcp"
                    and len(self.cfg.endpoints or ()) != self.cfg.n_shards):
                raise ValueError("shard_transport='remote' over tcp needs "
                                 "one endpoint per shard: endpoints has "
                                 f"{len(self.cfg.endpoints or ())} entries "
                                 f"for n_shards={self.cfg.n_shards}")
        if self.cfg.bearer not in ("tcp", "loopback"):
            raise ValueError(f"EngineConfig.bearer={self.cfg.bearer!r} not "
                             "in ('tcp', 'loopback')")
        if (self.cfg.pool == "remote" and self.cfg.bearer == "tcp"
                and not self.cfg.endpoints):
            raise ValueError("pool='remote' over tcp needs "
                             "EngineConfig.endpoints")
        if self.cfg.replication < 1 or (
                self.cfg.replication > 1
                and self.cfg.pool not in ("sharded", "remote")):
            raise ValueError("replication needs a value >= 1, and > 1 "
                             "needs a multi-node pool (sharded/remote)")
        self.client = ComputeClient(
            self.cfg, make_pool_factory(self.cfg, self.device), self.device)

    # ------------------------------------------------------------ lifecycle

    def build(self, data: np.ndarray) -> "DHNSWEngine":
        self.client.build(data)
        return self

    def build_streaming(self, source, *, chunk_rows: int,
                        spill_dir: Optional[str] = None) -> "DHNSWEngine":
        """Out-of-core build: stream ``source`` (an iterator of row
        chunks) through ``repro_torch.ingest.BulkLoader`` with O(chunk)
        peak builder memory.  Bit-identical to ``build`` on the
        concatenated data; the loader's ``LoadReport`` lands on
        ``self.last_load_report``."""
        from repro_torch.core.hnsw import HNSWParams
        from repro_torch.ingest.loader import BulkLoader
        cfg = self.cfg
        loader = BulkLoader(
            n_rep=cfg.n_rep, chunk_rows=chunk_rows, seed=cfg.seed,
            meta_levels=cfg.meta_levels,
            sub_params=HNSWParams(M=max(cfg.sub_M0 // 2, 2), M0=cfg.sub_M0,
                                  ef_construction=cfg.ef_construction),
            spill_dir=spill_dir or cfg.data_dir,
            quant_group=cfg.quant_group if cfg.quant == "int8" else 0)
        loader.add_chunks(source)
        meta, store, report = loader.finalize()
        # the disk-backed spill view backs repack/rebuild lookups, so
        # the full dataset never has to be resident on the builder
        view = loader.data_view()
        loader.close()
        self.client.adopt_built(meta, store, view)
        self.last_load_report = report
        return self

    def adopt_built(self, meta, store, data: np.ndarray) -> "DHNSWEngine":
        """Serve a meta + region built elsewhere (see
        ``ComputeClient.adopt_built`` and ``repro_torch.convert``)."""
        self.client.adopt_built(meta, store, data)
        return self

    # ------------------------------------------------------------ requests

    def search(self, queries: np.ndarray, k: int = 10,
               ef: Optional[int] = None, b: Optional[int] = None):
        """Batched top-k.  Returns (dists (B,k), gids (B,k), stats)."""
        with TRACER.span("compute.search", tier="compute", k=int(k),
                         quant=self.cfg.quant):
            return self.client.search(queries, k=k, ef=ef, b=b)

    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Dynamic insertion (paper §3.2) through the pool WRITE verb."""
        with TRACER.span("compute.insert", tier="compute"):
            return self.client.insert(vecs)

    # ------------------------------------------------------------ state

    @property
    def pool(self):
        return self.client.pool

    @property
    def meta(self):
        return self.client.meta

    @property
    def store(self):
        return None if self.client.pool is None else self.client.pool.store

    @property
    def cache(self):
        return self.client.cache

    @property
    def tiers(self):
        return self.client.tiers

    @property
    def _last_insert_net(self):
        return self.client._last_insert_net

    def _invalidate_pid(self, pid: int):
        self.client._invalidate_pid(pid)
