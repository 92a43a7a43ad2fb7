"""d-HNSW core: the paper's contribution, on torch.

Public API (the reference's ``repro.core``, name for name):
    DHNSWEngine / EngineConfig   — build + batched search + insert
    build_meta                   — representative index (§3.1)
    build_store / LayoutSpec     — RDMA-friendly layout (§3.2)
    plan_batch                   — query-aware batched loading (§3.3)

Host-side build (hnsw, meta, layout), the round scheduler and the
network cost model are copies of the reference's; the device path
(search, device_store) runs on torch.
"""
from repro_torch.core.cost_model import RDMA_100G, TPU_ICI, Fabric, NetLedger
from repro_torch.core.engine import MODES, POOLS, DHNSWEngine, EngineConfig
from repro_torch.core.hnsw import (HNSW, HNSWParams, PaddedGraph,
                                   brute_force_knn, recall_at_k)
from repro_torch.core.layout import LayoutSpec, Store, build_store
from repro_torch.core.meta import MetaIndex, build_meta
from repro_torch.core.scheduler import (LRUCacheState, Plan, TieredCacheState,
                                        naive_plan, plan_batch)

__all__ = [
    "DHNSWEngine", "EngineConfig", "MODES", "POOLS",
    "HNSW", "HNSWParams", "PaddedGraph", "brute_force_knn", "recall_at_k",
    "MetaIndex", "build_meta",
    "LayoutSpec", "Store", "build_store",
    "LRUCacheState", "TieredCacheState", "Plan", "plan_batch", "naive_plan",
    "Fabric", "NetLedger", "RDMA_100G", "TPU_ICI",
]
