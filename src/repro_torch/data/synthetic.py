"""Synthetic datasets: SIFT/GIST-like clustered vectors + LM token streams.

The paper evaluates on SIFT1M (128d) and GIST1M (960d).  We generate
clustered Gaussians with matching dimensionality and realistic cluster
structure (ANN benchmarks are only interesting when data is clustered —
uniform data makes every method look the same).  Sizes are CLI-tunable;
defaults fit this container.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VectorDataset:
    name: str
    data: np.ndarray       # (N, D) f32
    queries: np.ndarray    # (Q, D) f32
    gt_ids: np.ndarray     # (Q, k_gt) exact nearest ids
    gt_dists: np.ndarray


def clustered(n: int, dim: int, n_queries: int, *, n_clusters: int = 0,
              spread: float = 0.15, seed: int = 0, k_gt: int = 100,
              name: str = "synthetic") -> VectorDataset:
    """Gaussian mixture: cluster centers ~ U[0,1]^D, points ~ N(c, spread)."""
    from repro_torch.core.hnsw import brute_force_knn
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(8, n // 1000)
    centers = rng.random((n_clusters, dim), dtype=np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    data = (centers[assign]
            + spread * rng.standard_normal((n, dim)).astype(np.float32))
    # queries: perturbed data points (realistic ANN workload)
    qsrc = rng.integers(0, n, size=n_queries)
    queries = (data[qsrc]
               + 0.5 * spread * rng.standard_normal((n_queries, dim))
               .astype(np.float32))
    k_gt = min(k_gt, n)
    gt_d, gt_i = brute_force_knn(data, queries, k_gt)
    return VectorDataset(name, data, queries, gt_i, gt_d)


def sift_like(n: int = 50_000, n_queries: int = 500, seed: int = 0,
              **kw) -> VectorDataset:
    """128-d (SIFT1M's dimensionality)."""
    return clustered(n, 128, n_queries, seed=seed, name="sift-like", **kw)


def gist_like(n: int = 10_000, n_queries: int = 200, seed: int = 0,
              **kw) -> VectorDataset:
    """960-d (GIST1M's dimensionality) — higher-D, fewer rows (paper:
    GIST latency is dominated by per-vector distance cost)."""
    return clustered(n, 960, n_queries, seed=seed, name="gist-like", **kw)


def token_stream(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                 n_batches: int = 0):
    """Zipf-ish synthetic LM batches {tokens, labels} for train loops."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches <= 0 or i < n_batches:
        # zipf over a capped vocab, shifted into range
        raw = rng.zipf(1.3, size=(batch, seq + 1)) % vocab_size
        yield {"tokens": raw[:, :-1].astype(np.int32),
               "labels": raw[:, 1:].astype(np.int32)}
        i += 1
