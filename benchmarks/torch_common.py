"""Shared scaffolding of the port's benchmarks: presets, datasets, CSV
emit.  The port of the parts of ``benchmarks/common.py`` they use; it
imports ``repro_torch`` and numpy, never the JAX package.

Scale presets (env ``REPRO_BENCH_SCALE``), the reference's sift sizes:
  quick — CI-sized (default): sift 20k, batch 256
  full  — paper-shaped: sift 100k, batch 2000
"""
from __future__ import annotations

import functools
import os

import numpy as np

from repro_torch.data.synthetic import sift_like

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")

PRESETS = {
    "quick": dict(sift_n=20_000, n_queries=256, batch=256, n_rep=128),
    "full": dict(sift_n=100_000, n_queries=2_000, batch=2_000, n_rep=256),
}
P = PRESETS[SCALE]


def dataset(preset: dict | None = None):
    """The benchmark's sift dataset at ``preset`` (default ``P``), made
    from seed 0."""
    p = P if preset is None else preset
    return _dataset(p["sift_n"], p["n_queries"])


@functools.lru_cache(maxsize=None)
def _dataset(sift_n: int, n_queries: int):
    return sift_like(n=sift_n, n_queries=n_queries, seed=0)


def emit(row: dict) -> None:
    """One CSV line: name,us_per_call,extra key=val pairs."""
    name = row.pop("name")
    us = row.pop("us_per_call", "")
    rest = " ".join(f"{k}={v}" for k, v in row.items())
    print(f"{name},{us},{rest}", flush=True)


def batched_queries(ds, batch):
    """``batch`` queries: the dataset's, repeated when it has fewer."""
    q = ds.queries
    if len(q) < batch:
        reps = -(-batch // len(q))
        q = np.concatenate([q] * reps)[:batch]
    return q[:batch]
