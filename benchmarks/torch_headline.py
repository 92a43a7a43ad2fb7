"""Paper-geometry headline run through the PyTorch/CUDA port (the port of
``benchmarks/headline_full.py``): 100k x 128d clustered vectors, 256
partitions, batch 2000, b=4, ef=48, RDMA fabric, the three schemes.

    PYTHONPATH=src python -m benchmarks.torch_headline [--device cpu]

The reference's docstring reports, from the JAX package on a CPU,
recall@10 ~0.86, rtpq 4.0 -> 0.01 and a naive/full net ratio ~32x.  The
index is built once (or handed in as ``index``) and each scheme serves
it from a fresh engine (``adopt_built``: the build reads no ``mode``), so
a line's ``build`` is that engine's set-up.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from benchmarks.torch_latency_recall import MODES
from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G
from repro_torch.core.hnsw import recall_at_k
from repro_torch.data.synthetic import sift_like

N_REP = 256


def config(mode: str) -> EngineConfig:
    return EngineConfig(mode=mode, search_mode="graph", b=4, ef=48,
                        n_rep=N_REP, cache_frac=0.10, doorbell=16,
                        fabric=RDMA_100G, use_gather_kernel=True, seed=0)


def run(n: int = 100_000, n_queries: int = 2000, index=None, *, ds=None,
        device="cuda") -> dict:
    """Each scheme's first batch of all the queries at k=10 on a fresh
    engine; prints the reference's lines.  ``index``: (meta, store) built
    from ``ds`` (default ``sift_like(n, n_queries, seed=0)``) with 256
    partitions.  Returns mode -> {"d", "g", "stats", "recall", "wall"}."""
    ds = sift_like(n=n, n_queries=n_queries, seed=0) if ds is None else ds
    B = len(ds.queries)
    if index is None:
        t0 = time.time()
        built = DHNSWEngine(config("full"), device=device).build(ds.data)
        index = (built.meta, built.store)
        print(f"index build {time.time() - t0:.0f}s", flush=True)
    meta, store = index
    if meta.n_partitions != N_REP:
        raise ValueError(f"index has {meta.n_partitions} partitions, the "
                         f"headline geometry {N_REP}")
    res = {}
    for mode in MODES:
        t0 = time.time()
        eng = DHNSWEngine(config(mode), device=device).adopt_built(
            meta, dataclasses.replace(store), ds.data)
        tb = time.time() - t0
        t0 = time.perf_counter()
        d, g, st = eng.search(ds.queries, k=10, ef=48)
        wall = time.perf_counter() - t0
        rec = recall_at_k(g, ds.gt_ids[:, :10])
        res[mode] = dict(d=d, g=g, stats=st, recall=rec, wall=wall)
        print(f"{mode:12s} build {tb:.0f}s recall@10 {rec:.4f} "
              f"net_us_q {st['net']['latency_s'] / B * 1e6:.2f} "
              f"rtpq {st['round_trips_per_query']:.5f} "
              f"bytes_q {st['net']['bytes'] / B:.0f}", flush=True)
    n_, f = res["naive"]["stats"], res["full"]["stats"]
    print(f"HEADLINE naive/full net ratio @batch{B}: "
          f"{n_['net']['latency_s'] / f['net']['latency_s']:.1f}x "
          f"(trips {n_['net']['round_trips']:.0f} vs "
          f"{f['net']['round_trips']:.0f})", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
