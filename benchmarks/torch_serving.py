"""Offered-load sweep through the PyTorch/CUDA port (the port of
``benchmarks/serving.py``): serial per-request submission vs
micro-batched.

For each scheme and concurrency level C, C single-query requests at a
time go to the port's engine:

  * ``serial``  — every request is its own ``engine.search`` call (the
                  engine is single-writer, so a lock serializes them): no
                  partition dedup across users, fixed route/plan/dispatch
                  costs paid per request.
  * ``batched`` — requests go through ``serve.MicroBatcher``; concurrent
                  requests fuse into one engine batch, so dedup, doorbell
                  grouping and cache reuse amortize across requesters.

Two passes per (mode, C):

  * the counted pass (the ``counted`` table): one submitter issues waves
    of exactly C requests against a batcher with ``max_batch=C`` and an
    effectively infinite window, so every fused window is exactly the
    wave.  Round trips, descriptors and KB a query come from the
    ``NetLedger``, ``mean_fused_batch`` from the batcher: no clock, and at
    ``--smoke`` they equal ``benchmarks/baselines/BENCH_serving.json``'s
    ``counted`` table.
  * the wall-clock sweep (the ``rows`` table): closed-loop client
    threads, throughput and latency percentiles on this machine's clock;
    never compared with anything.

``--trace FILE`` records the wall-clock sweep through the port's tracer
(phase-tagged serial/batched sections, one ``request`` span a request)
and writes Chrome-trace JSON to FILE for
``python -m repro_torch.obs.report FILE``.

    PYTHONPATH=src python benchmarks/torch_serving.py --smoke [--device cpu]

Writes ``BENCH_torch_serving.json``.  Runs on the card unless
``--device cpu``. Every engine reads its spans through the
port's doorbell gather kernel (``use_gather_kernel``; on CPU tensors its
plain version).
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G
from repro_torch.data.synthetic import sift_like
from repro_torch.obs.trace import TRACER
from repro_torch.serve.batcher import BatchPolicy, MicroBatcher


def build_engine(mode: str, data: np.ndarray, n_rep: int, seed: int = 0,
                 device="cuda") -> DHNSWEngine:
    cfg = EngineConfig(mode=mode, search_mode="scan", b=3, ef=32,
                       n_rep=n_rep, cache_frac=0.15, doorbell=16,
                       fabric=RDMA_100G, seed=seed, use_gather_kernel=True)
    return DHNSWEngine(cfg, device=device).build(data)


def _percentiles(lat: list[float]) -> dict:
    arr = np.asarray(lat, np.float64) * 1e3
    return {f"p{p}_ms": round(float(np.percentile(arr, p)), 3)
            for p in (50, 95, 99)}


def _per_q(tot: dict, nq: int) -> dict:
    """Ledger totals -> the counted per-query metrics."""
    return {"round_trips_per_q": round(tot["round_trips"] / nq, 4),
            "descriptors_per_q": round(tot["descriptors"] / nq, 4),
            "kb_per_q": round(tot["bytes"] / nq / 1024.0, 4)}


def counted_pass(mode: str, data, queries, *, n_rep: int, C: int, k: int,
                 waves: int, seed: int, device="cuda") -> list[dict]:
    """Serial vs batched at concurrency C, on the counted clock only.

    Both impls see the same request stream (``waves`` waves of C
    single-query requests, queries cycled in submission order) on a fresh
    engine each.  The batcher is pinned to ``max_batch=C`` with a huge
    window, so every wave fuses into exactly one engine call and
    ``mean_fused_batch == C`` by construction."""
    nq = C * waves

    eng = build_engine(mode, data, n_rep, seed=seed, device=device)
    tot = {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}
    for i in range(nq):
        _, _, st = eng.search(queries[i % len(queries)][None], k=k)
        for key in tot:
            tot[key] += float(st["net"][key])
    rows = [{"impl": "serial", **_per_q(tot, nq), "mean_fused_batch": 1.0}]

    eng = build_engine(mode, data, n_rep, seed=seed, device=device)
    with MicroBatcher(eng, BatchPolicy(max_batch=C,
                                       max_wait_s=30.0)) as mb:
        for w in range(waves):
            futs = [mb.submit_search(queries[(w * C + i) % len(queries)],
                                     k=k) for i in range(C)]
            for f in futs:
                f.result()
        snap = mb.metrics.snapshot()
    net = snap["net"]
    rows.append({"impl": "batched",
                 **_per_q({"round_trips": net["round_trips"],
                           "descriptors": net["descriptors"],
                           "bytes": net["bytes_fetched"]}, nq),
                 "mean_fused_batch":
                     round(float(snap["mean_fused_batch"]), 2)})
    return rows


def run_clients(n_clients: int, per_client: int, queries: np.ndarray,
                call) -> dict:
    """Closed loop: each client thread issues its requests back to back."""
    lat: list[list[float]] = [[] for _ in range(n_clients)]
    errs: list[BaseException] = []

    def client(cid: int):
        rng = np.random.default_rng(cid)
        try:
            for _ in range(per_client):
                q = queries[rng.integers(0, len(queries))]
                t0 = time.perf_counter()
                call(q)
                lat[cid].append(time.perf_counter() - t0)
        except BaseException as e:      # surface, don't hang the join
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    flat = [x for one in lat for x in one]
    return {"qps": round(len(flat) / wall, 1), "wall_s": round(wall, 3),
            **_percentiles(flat)}


def sweep(mode: str, data, queries, *, n_rep: int, clients: tuple[int, ...],
          per_client: int, k: int, seed: int = 0,
          device="cuda") -> list[dict]:
    eng = build_engine(mode, data, n_rep, seed=seed, device=device)
    lock = threading.Lock()

    def serial_call(q):
        with TRACER.span("request", tier="bench", impl="serial"):
            with lock:
                eng.search(q[None], k=k)

    rows = []
    warm = max(2, per_client // 3)
    for C in clients:
        # warm both paths at every batch shape the measured window sees
        TRACER.set_phase("warmup")
        run_clients(C, warm, queries, serial_call)
        TRACER.set_phase("serial")
        serial = run_clients(C, per_client, queries, serial_call)
        with MicroBatcher(eng, BatchPolicy(max_batch=max(64, 2 * C),
                                           max_wait_s=4e-3)) as mb:
            def batched_call(q):
                with TRACER.span("request", tier="bench", impl="batched"):
                    mb.search(q, k=k)

            TRACER.set_phase("warmup")
            run_clients(C, 2 * warm, queries, batched_call)
            TRACER.set_phase("batched")
            batched = run_clients(C, per_client, queries, batched_call)
            fused = mb.metrics.snapshot()["mean_fused_batch"]
        TRACER.set_phase(None)
        speedup = round(batched["qps"] / max(serial["qps"], 1e-9), 2)
        for impl, res in (("serial", serial), ("batched", batched)):
            rows.append({"mode": mode, "clients": C, "impl": impl, **res})
        # observed fusion under wall-clock timing, informational only
        rows[-1]["fused_batch_obs"] = round(fused, 2)
        rows[-1]["speedup_vs_serial"] = speedup
        print(f"{mode:12s} C={C:3d}  serial {serial['qps']:8.1f} qps "
              f"(p95 {serial['p95_ms']:7.1f} ms) | batched "
              f"{batched['qps']:8.1f} qps (p95 {batched['p95_ms']:7.1f} ms) "
              f"| fused~{fused:.1f}  speedup x{speedup}", flush=True)
    return rows


def run(*, smoke: bool = False, out: str = "BENCH_torch_serving.json",
        modes=("naive", "no_doorbell", "full"), seed: int = 0,
        trace_out: str | None = None, skip_wallclock: bool = False,
        device="cuda") -> dict:
    if smoke:
        n, n_rep, clients, per_client, waves = 2000, 16, (1, 4), 4, 2
        modes = ["full"]
    else:
        n, n_rep, clients, per_client, waves = (20_000, 64, (1, 4, 8, 16),
                                                25, 3)
    ds = sift_like(n=n, n_queries=64, seed=seed)

    counted = []
    for mode in modes:
        for C in clients:
            for row in counted_pass(mode, ds.data, ds.queries, n_rep=n_rep,
                                    C=C, k=10, waves=waves, seed=seed,
                                    device=device):
                counted.append({"mode": mode, "clients": C, **row})
            b, s = counted[-1], counted[-2]
            print(f"counted {mode:12s} C={C:3d}  trips/q "
                  f"{s['round_trips_per_q']:7.2f} -> "
                  f"{b['round_trips_per_q']:7.2f}  KB/q "
                  f"{s['kb_per_q']:8.2f} -> {b['kb_per_q']:8.2f}  "
                  f"fused {b['mean_fused_batch']:.2f}", flush=True)

    if trace_out:
        TRACER.configure()
    rows = []
    if not skip_wallclock:
        for mode in modes:
            rows.extend(sweep(mode, ds.data, ds.queries, n_rep=n_rep,
                              clients=clients, per_client=per_client, k=10,
                              seed=seed, device=device))
    if trace_out:
        n_spans = TRACER.save(trace_out)
        TRACER.disable()
        print(f"wrote {trace_out} ({n_spans} spans) — inspect with "
              f"`python -m repro_torch.obs.report {trace_out}`")

    dev = torch.device(device)
    blob = {"bench": "serving", "smoke": smoke, "n": n, "seed": seed,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "clients": list(clients), "per_client": per_client,
            "waves": waves, "counted": counted, "rows": rows}
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out} ({len(counted)} counted + {len(rows)} rows)")
    return blob


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny CI config")
    ap.add_argument("--out", default="BENCH_torch_serving.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record the wall-clock sweep with repro_torch.obs "
                         "and write Chrome-trace JSON to FILE")
    ap.add_argument("--modes", nargs="*",
                    default=["naive", "no_doorbell", "full"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    args = ap.parse_args()
    run(smoke=args.smoke, out=args.out, modes=args.modes, seed=args.seed,
        trace_out=args.trace, device=args.device)


if __name__ == "__main__":
    main()
