"""Seeded vectors and query pools: the benchmark's own frozen generator.

Clustered Gaussians at the width of SIFT1M (128-d) or GIST1M (960-d),
centres uniform in [0, 1)^D, points N(centre, spread), queries base rows
perturbed by half the spread: a copy of the port's
``repro_torch/data/synthetic.py clustered`` without its ground truth.  The
rows ``make`` draws are bit-equal to the port's for the same seed; the
copy lives here so that no later change to the program can move the
yardstick.

A run's inputs (``make``) come from two seeds:

* the configuration's ``data_seed`` fixes the deployment's rows: the
  clusters, the rows and which cluster each row belongs to.  The program
  partitions the rows around representatives sampled uniformly, so how
  evenly the partitions come out, and with it the size every span is
  padded to, the bytes on the wire and the length of the walk, follows
  the rows.  Drawn anew from each run's seed they moved the bytes a query
  by 1.7x between seeds; fixed, every seed does the same work.
* the run's ``--seed`` draws the query pool: which rows the queries
  perturb and the noise.

``sources="uniform"`` draws the query sources uniformly over the rows;
``sources="zipf"`` by cluster popularity: clusters ranked in a seeded
order, rank r (from 1) chosen with weight 1 / r**s, then a row of that
cluster uniformly.
"""
from __future__ import annotations

import numpy as np

SOURCES = ("uniform", "zipf")


def rng_for(seed: int) -> np.random.Generator:
    """The stream of one seed: any whole number, negative or past 64 bits,
    maps onto numpy's seed range."""
    return np.random.default_rng(int(seed) % (1 << 64))


def geometry(rng: np.random.Generator, n: int, dim: int, *,
             n_clusters: int = 0, spread: float = 0.15):
    """(rows (n, dim) f32, cluster of each row (n,), n_clusters), drawn as
    the port's ``clustered`` draws them."""
    n_clusters = n_clusters or max(8, n // 1000)
    centers = rng.random((n_clusters, dim), dtype=np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    data = (centers[assign]
            + spread * rng.standard_normal((n, dim)).astype(np.float32))
    return data, assign, n_clusters


def query_sources(rng: np.random.Generator, assign: np.ndarray,
                  n_clusters: int, n_queries: int, *, sources: str,
                  zipf_s: float = 1.0) -> np.ndarray:
    """The row each query perturbs."""
    n = len(assign)
    if sources == "uniform":
        return rng.integers(0, n, size=n_queries)
    if sources != "zipf":
        raise ValueError(f"sources={sources!r} not in {SOURCES}")
    counts = np.bincount(assign, minlength=n_clusters)
    order = rng.permutation(n_clusters)
    order = order[counts[order] > 0]            # clusters that have rows
    w = 1.0 / np.arange(1, len(order) + 1, dtype=np.float64) ** zipf_s
    rank = rng.choice(len(order), size=n_queries, p=w / w.sum())
    cluster = order[rank]
    members = np.argsort(assign, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    off = (rng.random(n_queries) * counts[cluster]).astype(np.int64)
    return members[start[cluster] + off]


def perturb(rng: np.random.Generator, data: np.ndarray, src: np.ndarray,
            spread: float) -> np.ndarray:
    return (data[src] + 0.5 * spread * rng.standard_normal(
        (len(src), data.shape[1])).astype(np.float32))


def make(config: dict, traffic: dict, seed: int):
    """The rows of a configuration and the query pool of a traffic mix for
    one run: (data (n, dim) f32, queries (pool, dim) f32)."""
    d = config["data"]
    spread = d.get("spread", 0.15)
    data, assign, n_clusters = geometry(
        rng_for(d["data_seed"]), d["n"], d["dim"],
        n_clusters=d.get("n_clusters", 0), spread=spread)
    rng = rng_for(seed)
    src = query_sources(rng, assign, n_clusters, traffic["pool"],
                        sources=traffic.get("sources", "uniform"),
                        zipf_s=traffic.get("zipf_s", 1.0))
    return data, perturb(rng, data, src, spread)
