"""Dynamic insertion through the PyTorch/CUDA port (the port of
``benchmarks/insert.py``, the paper's §3.2 overflow design):

  * per-insert latency (host mirror + device scatter + modeled WRITE);
  * recall immediately after insert (no repack) — overflow vectors must
    be served from the shared region by the very next fetch;
  * a burst of ``ov_cap + 8`` near copies of one row that fills its
    group's overflow region and forces a repack.

    PYTHONPATH=src python -m benchmarks.torch_insert [--device cpu]

``n``, ``net``, ``hit`` and ``self_recall`` are counted and equal the
reference's; ``us_per_call`` is this device's host clock.  Runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks.torch_common import P, dataset, emit
from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G

ROWS = ("insert/latency", "insert/self-recall@1", "insert/burst-with-repack")


def run(*, preset=None, device="cuda") -> list[dict]:
    """The three rows (also printed as CSV lines)."""
    p = P if preset is None else preset
    rows = []
    ds = dataset("sift", p)
    n0 = ds.data.shape[0] * 3 // 4
    eng = DHNSWEngine(EngineConfig(
        mode="full", search_mode="scan", b=4, ef=48,
        n_rep=min(p["n_rep"], n0 // 16), cache_frac=0.10,
        doorbell=16, fabric=RDMA_100G, use_gather_kernel=True, seed=0),
        device=device).build(ds.data[:n0])

    # baseline search on held-in queries (warms the cache as the
    # reference's does)
    eng.search(ds.queries, k=10)

    new = ds.data[n0:n0 + 256]
    t0 = time.perf_counter()
    gids = eng.insert(new)
    dt = time.perf_counter() - t0
    row = dict(name=ROWS[0], us_per_call=round(dt / len(new) * 1e6, 1),
               n=len(new), net=eng._last_insert_net["latency_s"])
    rows.append(row)
    emit(dict(row))

    # inserted vectors are immediately searchable
    _, gi, _ = eng.search(new[:64], k=1)
    hit = float(np.mean([gids[i] in gi[i] for i in range(64)]))
    row = dict(name=ROWS[1], us_per_call="", hit=hit)
    rows.append(row)
    emit(dict(row))

    # stress one partition to force repacks
    target = ds.data[5]
    burst = target[None] + 0.0005 * np.random.default_rng(1).standard_normal(
        (eng.store.spec.ov_cap + 8, eng.store.spec.dim)).astype(np.float32)
    t0 = time.perf_counter()
    bg = eng.insert(burst)
    dt = time.perf_counter() - t0
    _, gb, _ = eng.search(burst[:32], k=1)
    hit2 = float(np.mean([bg[i] in gb[i] for i in range(32)]))
    row = dict(name=ROWS[2], us_per_call=round(dt / len(burst) * 1e6, 1),
               self_recall=hit2)
    rows.append(row)
    emit(dict(row))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
