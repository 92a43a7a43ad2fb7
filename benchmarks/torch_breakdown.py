"""Tables 1-2 through the PyTorch/CUDA port (the port of
``benchmarks/breakdown.py``): the per-query latency breakdown at
efSearch=48, top-1 — network / sub-HNSW / meta-HNSW, round trips and
bytes per query, recall.

    PYTHONPATH=src python -m benchmarks.torch_breakdown [--device cpu]

``sub_us_q`` is host time per round with the final copy of the results
to the host in it, so on the card it also holds the fetches' device time
— the reference's own accounting.  Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import time

from benchmarks.torch_common import P, batched_queries, dataset, emit, engine
from benchmarks.torch_latency_recall import MODES
from repro_torch.core.hnsw import recall_at_k


def cells(datasets=("sift", "gist")):
    """(dataset, mode, row name) of each row, in the run's order."""
    for name in datasets:
        for mode in MODES:
            yield name, mode, f"table/{name}@1/{mode}"


def run(datasets=("sift", "gist"), *, preset=None, device="cuda",
        observe=None) -> list[dict]:
    """Every row (also printed as CSV lines).  ``observe(row, d, g,
    stats, wall s)`` is called after each measured search."""
    p = P if preset is None else preset
    rows = []
    for name, mode, row_name in cells(datasets):
        ds = dataset(name, p)
        queries = batched_queries(ds, p["batch"])
        eng = engine(name, mode, preset=p, device=device)
        # steady state: warm once, then measure
        eng.search(queries, k=1, ef=48)
        t0 = time.perf_counter()
        d, g, st = eng.search(queries, k=1, ef=48)
        wall = time.perf_counter() - t0
        B = len(queries)
        n = min(B, len(ds.queries))
        row = dict(
            name=row_name,
            us_per_call=round(
                (st["net"]["latency_s"] + st["sub_s"] + st["meta_s"])
                / B * 1e6, 2),
            net_us_q=round(st["net"]["latency_s"] / B * 1e6, 3),
            sub_us_q=round(st["sub_s"] / B * 1e6, 2),
            meta_us_q=round(st["meta_s"] / B * 1e6, 2),
            rtpq=round(st["round_trips_per_query"], 5),
            bytes_q=int(st["net"]["bytes"] / B),
            recall=round(recall_at_k(g[:n], ds.gt_ids[:n, :1]), 4))
        rows.append(row)
        emit(dict(row))
        if observe is not None:
            observe(row, d, g, st, wall)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
