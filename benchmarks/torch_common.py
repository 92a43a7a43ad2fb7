"""Shared scaffolding of the port's benchmarks: presets, datasets, engine
builds, CSV emit.  The port of ``benchmarks/common.py``; it imports
``repro_torch`` and numpy, never the JAX package.

Scale presets (env ``REPRO_BENCH_SCALE``), the reference's sizes:
  quick — CI-sized (default): sift 20k / gist 4k, batch 256
  full  — paper-shaped: sift 100k / gist 20k, batch 2000

``engine`` keeps one engine per (dataset, mode, search mode, fabric, b,
preset, device), as the reference's ``lru_cache`` does, so an engine's
LRU span cache carries from one sweep to the next exactly as there.
Each dataset's index is built once (``index``) and every engine serves
it through ``adopt_built``: ``ComputeClient.build`` reads no ``mode``, so
the counted rows are those of an engine's own build.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G, TPU_ICI
from repro_torch.data.synthetic import gist_like, sift_like

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")

PRESETS = {
    "quick": dict(sift_n=20_000, gist_n=4_000, n_queries=256, batch=256,
                  n_rep=128, efs=(1, 2, 4, 8, 16, 32, 48)),
    "full": dict(sift_n=100_000, gist_n=20_000, n_queries=2_000, batch=2_000,
                 n_rep=256, efs=(1, 2, 4, 8, 16, 32, 48)),
}
P = PRESETS[SCALE]

# (name, rows, queries) -> dataset; (dataset key) -> (meta, store, data,
# build s); engine key -> engine
_DATA: dict = {}
_INDEX: dict = {}
_ENGINES: dict = {}


def _key(name: str, p: dict) -> tuple:
    """The dataset's (name, rows, queries, partitions) at preset ``p``."""
    if name == "sift":
        n, nq = p["sift_n"], p["n_queries"]
    elif name == "gist":
        n, nq = p["gist_n"], max(p["n_queries"] // 4, 64)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    return name, n, nq, min(p["n_rep"], n // 16)


def dataset(name: str = "sift", preset: dict | None = None):
    """The benchmark's ``sift`` or ``gist`` dataset at ``preset`` (default
    ``P``), made from seed 0."""
    key = _key(name, P if preset is None else preset)[:3]
    if key not in _DATA:
        make = sift_like if name == "sift" else gist_like
        _DATA[key] = make(n=key[1], n_queries=key[2], seed=0)
    return _DATA[key]


def index(name: str, preset: dict | None = None):
    """The dataset's meta-HNSW and region, built once on the host as
    ``DHNSWEngine.build`` builds them: (meta, store, data, build s)."""
    key = _key(name, P if preset is None else preset)
    if key not in _INDEX:
        ds = dataset(name, preset)
        t0 = time.perf_counter()
        eng = DHNSWEngine(EngineConfig(n_rep=key[3], seed=0),
                          device="cpu").build(ds.data)
        _INDEX[key] = (eng.meta, eng.store, ds.data,
                       time.perf_counter() - t0)
    return _INDEX[key]


def adopt_index(name: str, ds, meta, store,
                preset: dict | None = None) -> None:
    """Serve the dataset at ``preset`` from ``ds`` and an index built from
    it elsewhere, as ``index`` builds it (its build s is not known):
    ``ds`` must be that dataset, made from seed 0."""
    key = _key(name, P if preset is None else preset)
    if (ds.data.shape[0], len(ds.queries)) != key[1:3]:
        raise ValueError(f"{name} at this preset has {key[1]} rows and "
                         f"{key[2]} queries, not {ds.data.shape[0]} and "
                         f"{len(ds.queries)}")
    if meta.n_partitions != key[3]:
        raise ValueError(f"index has {meta.n_partitions} partitions, the "
                         f"preset asks for {key[3]}")
    _DATA[key[:3]] = ds
    _INDEX[key] = (meta, store, ds.data, None)


def engine(name: str, mode: str, search_mode: str = "graph",
           fabric: str = "rdma", b: int = 4, *, preset: dict | None = None,
           device="cuda") -> DHNSWEngine:
    """The reference's engine configuration (``benchmarks/common.py``),
    with the CUDA doorbell gather, on ``device``: built once per key."""
    p = P if preset is None else preset
    key = (_key(name, p), mode, search_mode, fabric, b, str(device))
    if key not in _ENGINES:
        meta, store, data, _ = index(name, p)
        cfg = EngineConfig(
            mode=mode, search_mode=search_mode, b=b, ef=48, n_rep=key[0][3],
            cache_frac=0.10, doorbell=16,
            fabric=RDMA_100G if fabric == "rdma" else TPU_ICI,
            use_gather_kernel=True, seed=0)
        _ENGINES[key] = DHNSWEngine(cfg, device=device).adopt_built(
            meta, dataclasses.replace(store), data)
    return _ENGINES[key]


def clear() -> None:
    """Drop every cached engine, index and dataset (and the device memory
    they hold, once nothing else refers to them)."""
    _ENGINES.clear()
    _INDEX.clear()
    _DATA.clear()


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
