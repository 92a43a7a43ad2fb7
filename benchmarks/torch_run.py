"""Benchmark harness of the PyTorch/CUDA port (the port of
``benchmarks/run.py``) — one function per paper table/figure.

    PYTHONPATH=src python -m benchmarks.torch_run [--device cpu] [suite ...]

Suites: fig6 (latency-recall), tables (breakdown), throughput, insert,
serving (offered-load sweep -> BENCH_torch_serving.json), quant
(recall-vs-bytes tier-split sweep -> BENCH_torch_quant.json), pool
(modeled latency vs simulated network parameters ->
BENCH_torch_pool.json).  Default: all.  The reference's ``roofline``
suite reads the output of its XLA dry run, which the port does not have
yet, so it is left out.  Prints ``name,us_per_call,key=val...`` CSV.
Scale via REPRO_BENCH_SCALE={quick,full} (see benchmarks/torch_common.py);
a failed suite makes the run exit non-zero.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

SUITES = ["fig6", "tables", "throughput", "insert", "serving", "quant",
          "pool"]


def _suite(suite: str, device: str) -> None:
    smoke = os.environ.get("REPRO_BENCH_SCALE", "quick") == "quick"
    if suite == "fig6":
        from benchmarks.torch_latency_recall import run
        run(device=device)
    elif suite == "tables":
        from benchmarks.torch_breakdown import run
        run(device=device)
    elif suite == "throughput":
        from benchmarks.torch_throughput import run
        run(device=device)
    elif suite == "insert":
        from benchmarks.torch_insert import run
        run(device=device)
    elif suite == "serving":
        from benchmarks.torch_serving import run
        run(smoke=smoke, device=device)
    elif suite == "quant":
        from benchmarks.torch_quant import run
        run(smoke=smoke, device=device)
    elif suite == "pool":
        from benchmarks.torch_pool import run
        run(smoke=smoke, device=device)
    else:
        raise ValueError(f"unknown suite {suite}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    ap.add_argument("suites", nargs="*", default=SUITES, metavar="suite",
                    help=f"any of {SUITES} (default: all)")
    args = ap.parse_args(argv)
    print(f"# benchmark run: suites={args.suites}", flush=True)
    failures = []
    for suite in args.suites:
        t0 = time.time()
        print(f"# --- {suite} ---", flush=True)
        try:
            _suite(suite, args.device)
        except Exception:
            failures.append(suite)
            print(f"# SUITE FAILED: {suite}")
            traceback.print_exc()
        print(f"# --- {suite} done in {time.time() - t0:.1f}s ---",
              flush=True)
    if failures:
        sys.exit(f"failed suites: {failures}")


if __name__ == "__main__":
    main()
