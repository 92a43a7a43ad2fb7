"""Live-ingest demo on the PyTorch/CUDA port: concurrent appends and
queries on one engine.

    python examples/torch_live_ingest.py [--pool sharded] [--device cuda|cpu]

The twin of ``examples/live_ingest.py`` through ``repro_torch``: the
same CLI, phases and printed lines; the engine runs on ``--device``.

Builds a d-HNSW engine over the first part of a synthetic SIFT-like
dataset, then runs three measured phases:

* **before** — queries only, against the initial index;
* **during** — a writer thread streams the held-out tail through
  ``engine.insert`` (the pool's one-sided WRITE verb: overflow appends,
  repacks when a group fills) while query threads keep serving;
* **after**  — queries only, with every insert folded in.

Each phase reports recall@k (before/during against the initial rows'
ground truth — the index legitimately grows mid-phase — after against
the full dataset's) and the query latency p50/p99, so the printout
shows what live ingestion costs the read path and that the inserted
vectors are actually found afterwards.

``--pool`` picks the transport exactly like ``torch_online_serving.py``
(``sharded`` shows appends fanning to the owning shard's replicas;
``remote`` serves through forked pool-server processes).  The engine is
guarded by one lock — requests interleave rather than race — matching
the serial-call discipline of the other demos.
"""
import argparse
import contextlib
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core.hnsw import brute_force_knn  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402


def recall_at_k(got_gids: np.ndarray, true_gids: np.ndarray) -> float:
    hits = sum(len(set(g.tolist()) & set(t.tolist()))
               for g, t in zip(got_gids, true_gids))
    return hits / float(true_gids.size)


def query_phase(eng, lock, queries, true_gids, *, k: int, seconds: float,
                stop: threading.Event = None):
    """Closed-loop single-query reads for ``seconds`` (or until ``stop``);
    returns (recall@k, p50 ms, p99 ms, queries served)."""
    lat, got = [], {}
    rng = np.random.default_rng(0)
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end and not (stop and stop.is_set()):
        qi = int(rng.integers(0, len(queries)))
        t0 = time.perf_counter()
        with lock:
            _, gids, _ = eng.search(queries[qi][None], k=k)
        lat.append(time.perf_counter() - t0)
        got[qi] = np.asarray(gids)[0]
    qis = sorted(got)
    rec = recall_at_k(np.stack([got[q] for q in qis]),
                      np.stack([true_gids[q] for q in qis]))
    arr = np.asarray(lat) * 1e3
    return (rec, float(np.percentile(arr, 50)),
            float(np.percentile(arr, 99)), len(lat))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12_000,
                    help="initially indexed rows")
    ap.add_argument("--ingest", type=int, default=1_500,
                    help="rows appended live during the middle phase")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="measured duration of each query phase")
    ap.add_argument("--pool", default="local",
                    choices=("local", "sim_rdma", "sharded", "remote"))
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--quant", action="store_true",
                    help="serve through the int8 quantized tier")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    total = args.n + args.ingest
    ds = sift_like(n=total, n_queries=64, seed=0)
    base, tail = ds.data[:args.n], ds.data[args.n:]
    print(f"indexing {args.n} rows ({args.ingest} held out for live "
          f"ingest)...")

    with contextlib.ExitStack() as stack:
        endpoints = None
        if args.pool == "remote":
            from repro_torch.net import spawn_pool_servers
            print(f"forking {args.shards} loopback pool servers...")
            endpoints = tuple(stack.enter_context(
                spawn_pool_servers(args.shards)))
        eng = DHNSWEngine(EngineConfig(
            mode="full", search_mode="scan", b=3, ef=32, n_rep=48,
            cache_frac=0.15, doorbell=16,
            quant="int8" if args.quant else "none",
            pool=args.pool, n_shards=args.shards,
            endpoints=endpoints), device=args.device).build(base)

        k, lock = args.k, threading.Lock()
        # ground truth: initial rows for before/during, everything after
        _, gt_base = brute_force_knn(base, ds.queries, k)
        _, gt_full = brute_force_knn(ds.data, ds.queries, k)
        eng.search(ds.queries[:1], k=k)      # warm the jit caches

        rec, p50, p99, nq = query_phase(eng, lock, ds.queries, gt_base,
                                        k=k, seconds=args.seconds)
        print(f"\nbefore ingest: recall@{k} {rec:.3f}   p50 {p50:6.1f} ms"
              f"   p99 {p99:6.1f} ms   ({nq} queries)")

        done = threading.Event()
        appended = [0]

        def writer():
            for s in range(0, len(tail), 32):
                with lock:
                    eng.insert(tail[s:s + 32])
                appended[0] += len(tail[s:s + 32])
            done.set()

        wt = threading.Thread(target=writer)
        t0 = time.perf_counter()
        wt.start()
        # keep querying as long as the writer runs (at least one pass)
        rec, p50, p99, nq = query_phase(eng, lock, ds.queries, gt_base,
                                        k=k, seconds=args.seconds,
                                        stop=done)
        wt.join()
        ingest_s = time.perf_counter() - t0
        print(f"during ingest: recall@{k} {rec:.3f}   p50 {p50:6.1f} ms"
              f"   p99 {p99:6.1f} ms   ({nq} queries, {appended[0]} "
              f"appends in {ingest_s:.1f}s)")

        rec, p50, p99, nq = query_phase(eng, lock, ds.queries, gt_full,
                                        k=k, seconds=args.seconds)
        print(f"after ingest:  recall@{k} {rec:.3f}   p50 {p50:6.1f} ms"
              f"   p99 {p99:6.1f} ms   ({nq} queries, ground truth now "
              f"includes the {args.ingest} inserted rows)")

        net = eng._last_insert_net
        if net:
            print(f"\ninsert wire: {net['bytes'] / 1e3:.1f} kB over "
                  f"{net['round_trips']:.0f} one-sided WRITEs "
                  f"(last batch)")
        snap = eng.pool.snapshot()
        if snap.get("kind") == "sharded":
            stg = snap.get("staging")
            print(f"sharded pool: {snap['n_shards']} nodes, "
                  f"{snap['migration']['n']} migrations, "
                  f"replication fan-out "
                  f"{snap['replication_io']['fanout_writes']} writes")
            if stg:
                mb = [b / 1e6 for b in stg["device_bytes_by_shard"]]
                print("  staged device MB by shard: "
                      + ", ".join(f"{x:.2f}" for x in mb)
                      + f"  (restaged blocks: {stg['restaged_blocks']})")


if __name__ == "__main__":
    main()
