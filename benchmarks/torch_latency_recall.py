"""Fig. 6 through the PyTorch/CUDA port (the port of
``benchmarks/latency_recall.py``): latency-recall curves, 3 schemes x 2
datasets x top-{10,1}, efSearch over ``P["efs"]``.

    PYTHONPATH=src python -m benchmarks.torch_latency_recall [--device cpu]

Latency per query = network (cost model, RDMA fabric) + measured
sub-HNSW + meta-HNSW compute, / batch.  The rows and their fields are the
reference's; the network term, round trips and recall are counted and
equal the reference's, the compute terms are this device's clock.  Runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from benchmarks.torch_common import P, batched_queries, dataset, emit, engine
from repro_torch.core.hnsw import recall_at_k

MODES = ("naive", "no_doorbell", "full")


def cells(datasets=("sift", "gist"), topks=(10, 1), preset=None):
    """(dataset, topk, mode, ef, row name) of each row, in the run's
    order."""
    p = P if preset is None else preset
    for name in datasets:
        for topk in topks:
            for mode in MODES:
                for ef in p["efs"]:
                    yield (name, topk, mode, ef,
                           f"fig6/{name}@top{topk}/{mode}/ef{ef}")


def run(datasets=("sift", "gist"), topks=(10, 1), *, preset=None,
        device="cuda", observe=None) -> list[dict]:
    """Every row (also printed as CSV lines), then the headline rows.
    ``observe(row, d, g, stats, wall s)`` is called after each search."""
    p = P if preset is None else preset
    rows = []
    for name, topk, mode, ef, row_name in cells(datasets, topks, p):
        ds = dataset(name, p)
        queries = batched_queries(ds, p["batch"])
        # the cache persists across points, as in the paper's
        # steady-state serving loop
        eng = engine(name, mode, preset=p, device=device)
        t0 = time.perf_counter()
        d, g, st = eng.search(queries, k=topk, ef=ef)
        wall = time.perf_counter() - t0
        n = min(len(g), len(ds.queries))
        rec = recall_at_k(g[:n], ds.gt_ids[:n, :topk])
        net_s = st["net"]["latency_s"]
        total = net_s + st["sub_s"] + st["meta_s"]
        row = dict(
            name=row_name,
            us_per_call=round(total / len(queries) * 1e6, 2),
            recall=round(rec, 4),
            net_us_q=round(net_s / len(queries) * 1e6, 3),
            sub_us_q=round(st["sub_s"] / len(queries) * 1e6, 1),
            meta_us_q=round(st["meta_s"] / len(queries) * 1e6, 1),
            rtpq=round(st["round_trips_per_query"], 5))
        rows.append(row)
        emit(dict(row))
        if observe is not None:
            observe(row, d, g, st, wall)
    # the headline ratios (ef=48, top-10): the linear-model network ratio
    # (no NIC queueing, so a lower bound on the paper's 117x) and the
    # total-latency ratio
    by = {r["name"]: r for r in rows}
    for name in datasets:
        n = by.get(f"fig6/{name}@top10/naive/ef48")
        f = by.get(f"fig6/{name}@top10/full/ef48")
        nd = by.get(f"fig6/{name}@top10/no_doorbell/ef48")
        if n and f:
            row = dict(name=f"fig6/{name}/headline", us_per_call="",
                       naive_over_full_net=round(
                           n["net_us_q"] / max(f["net_us_q"], 1e-9), 1),
                       nodoorbell_over_full_net=round(
                           nd["net_us_q"] / max(f["net_us_q"], 1e-9), 2),
                       naive_over_full_total=round(
                           n["us_per_call"] / max(f["us_per_call"], 1e-9), 1),
                       recall_at_ef48=f["recall"])
            rows.append(row)
            emit(dict(row))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
