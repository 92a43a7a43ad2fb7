"""Representative index (meta-HNSW) construction — paper §3.1.

Uniformly sample ``n_rep`` (paper: 500) vectors, build a **3-layer**
HNSW over them (the meta-HNSW).  Each bottom-layer (L0) representative
defines a partition; every dataset vector is assigned to its nearest
representative, and each partition's vectors get their own *sub-HNSW*
whose entry point is the representative.

The meta-HNSW is tiny (paper: 0.373 MB on SIFT1M) and is **cached
replicated in every compute instance** — here, replicated on every
device.  ``MetaIndex.device_arrays()`` exports the fixed-shape arrays the
JAX search consumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.hnsw import HNSW, HNSWParams, PaddedGraph, brute_force_knn


@dataclass
class MetaIndex:
    reps: np.ndarray           # (P, D) representative vectors (partition centers)
    rep_ids: np.ndarray        # (P,) ids of reps in the original dataset
    graph: PaddedGraph         # 3-layer meta-HNSW over reps
    assignments: np.ndarray    # (N,) partition id per dataset vector

    @property
    def n_partitions(self) -> int:
        return self.reps.shape[0]

    def size_bytes(self) -> int:
        """Footprint of what the compute pool caches (paper's 0.373 MB)."""
        return (self.reps.nbytes + self.graph.adjacency.nbytes
                + self.graph.node_level.nbytes)

    def partition_lists(self) -> list[np.ndarray]:
        order = np.argsort(self.assignments, kind="stable")
        sorted_assign = self.assignments[order]
        bounds = np.searchsorted(sorted_assign, np.arange(self.n_partitions + 1))
        return [order[bounds[p]:bounds[p + 1]] for p in range(self.n_partitions)]


def rep_sample_ids(n: int, n_rep: int, *, seed: int = 0) -> np.ndarray:
    """Uniform representative sample — a function of ``(n, seed)`` only.

    Split out so the out-of-core loader can pick the identical reps
    before the dataset is resident (it only needs the row count).
    """
    n_rep = min(n_rep, n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=n_rep, replace=False))


def build_meta_from_parts(reps: np.ndarray, rep_ids: np.ndarray,
                          assignments: np.ndarray, *, seed: int = 0,
                          meta_levels: int = 3,
                          params: Optional[HNSWParams] = None) -> MetaIndex:
    """Assemble a :class:`MetaIndex` from precomputed reps + assignments.

    The meta-HNSW construction lives here so the in-memory
    :func:`build_meta` and the streaming loader (which computes
    ``assignments`` chunk-by-chunk) share one code path bit-for-bit.
    """
    reps = np.asarray(reps, np.float32)
    p = params or HNSWParams(M=8, M0=16, ef_construction=64, seed=seed)
    h = HNSW(reps.shape[1], p)
    # force levels so the meta graph is exactly `meta_levels` deep: node 0
    # spans all layers (fixed entry point, paper: "fixed entry point in L2")
    for i, row in enumerate(reps):
        lvl = meta_levels - 1 if i == 0 else min(h._draw_level(), meta_levels - 1)
        h.insert(row, level=lvl)
    graph = h.export(max_levels=meta_levels)
    return MetaIndex(reps=reps, rep_ids=np.asarray(rep_ids),
                     graph=graph,
                     assignments=np.asarray(assignments, np.int32))


def build_meta(data: np.ndarray, n_rep: int = 500, *, seed: int = 0,
               meta_levels: int = 3,
               params: Optional[HNSWParams] = None) -> MetaIndex:
    """Sample reps uniformly, build the 3-layer meta-HNSW, assign vectors.

    Assignment is *exact* nearest-representative (the classifier role the
    paper gives meta-HNSW): with only ~500 reps a brute-force pass is
    cheaper and noise-free; query-time routing still goes through the
    graph (that is what we cache and traverse on device).
    """
    data = np.asarray(data, np.float32)
    rep_ids = rep_sample_ids(data.shape[0], n_rep, seed=seed)
    reps = data[rep_ids].copy()
    _, nn = brute_force_knn(reps, data, 1)
    assignments = nn[:, 0].astype(np.int32)
    return build_meta_from_parts(reps, rep_ids, assignments, seed=seed,
                                 meta_levels=meta_levels, params=params)


def balance_stats(meta: MetaIndex) -> dict:
    sizes = np.bincount(meta.assignments, minlength=meta.n_partitions)
    return {
        "n_partitions": int(meta.n_partitions),
        "min": int(sizes.min()), "max": int(sizes.max()),
        "mean": float(sizes.mean()), "p99": float(np.percentile(sizes, 99)),
        "empty": int((sizes == 0).sum()),
    }
