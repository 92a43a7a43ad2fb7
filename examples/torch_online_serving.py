"""Online serving demo on the PyTorch/CUDA port: concurrent clients
through the micro-batcher.

    python examples/torch_online_serving.py [--clients 8] [--device cuda|cpu]

The twin of ``examples/online_serving.py`` through ``repro_torch``: the
same CLI, steps and printed lines; the engine runs on ``--device``.

Builds a d-HNSW engine over synthetic SIFT-like vectors, stands up a
``SearchServer`` (micro-batching front-end), and fires closed-loop
client threads at it.  Concurrent requests coalesce into fused engine
batches — the paper's §3.3 batched query-aware loading assembled across
requesters — and the demo prints the resulting throughput, latency
percentiles, and stage breakdown, next to the same offered load served
one request at a time.

``--pool remote`` serves through REAL memory-node processes: pass
``--endpoints host:port,host:port`` to use running ``repro_torch.net.server``
instances, or pass nothing and the demo forks ``--shards`` loopback
servers itself.  The summary then includes a per-endpoint verb/byte
table with the *measured* wire traffic next to the modeled ledger.

``--replication 2`` (sharded/remote pools) keeps every group on two
distinct memory nodes: reads are served from the best live replica and
the fleet survives a node death mid-traffic (see docs/operations.md
for the failure semantics and the snapshot fields this demo prints).

``--trace FILE`` records the whole demo through ``repro_torch.obs`` (serve /
compute / pool / net spans; with ``--pool remote`` also the harvested
server-side service times), writes Chrome-trace JSON to FILE, and
prints the per-stage breakdown report at the end — see
docs/observability.md.

``--slo "p99<5ms"`` attaches a latency SLO to the serving tier
(``repro_torch.obs.slo``): the batched run then scores every request against
it and the summary ends with the SLO attainment / burn-rate table and
the straggler detector's verdicts over the pool's per-(verb, shard)
latency histograms — see docs/observability.md.
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
from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.serve.batcher import BatchPolicy  # noqa: E402
from repro_torch.serve.server import SearchServer  # noqa: E402


def closed_loop(n_clients, per_client, queries, call):
    lat = []
    lock = threading.Lock()

    def client(cid):
        rng = np.random.default_rng(cid)
        mine = []
        for _ in range(per_client):
            q = queries[rng.integers(0, len(queries))]
            t0 = time.perf_counter()
            call(q)
            mine.append(time.perf_counter() - t0)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    arr = np.asarray(lat) * 1e3
    return (len(lat) / wall, float(np.percentile(arr, 50)),
            float(np.percentile(arr, 95)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=20,
                    help="requests per client")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--quant", action="store_true",
                    help="serve through the int8 quantized tier "
                         "(staged search; watch net.bytes_saved)")
    ap.add_argument("--pool", default="local",
                    choices=("local", "sim_rdma", "sharded", "remote"),
                    help="memory-pool transport; 'sharded' splits the "
                         "region across --shards memory nodes; 'remote' "
                         "serves through TCP pool-server processes")
    ap.add_argument("--shards", type=int, default=2,
                    help="memory nodes under --pool sharded / remote")
    ap.add_argument("--placement", default="round_robin",
                    choices=("round_robin", "size_balanced", "freq"),
                    help="group placement policy under --pool sharded")
    ap.add_argument("--replication", type=int, default=1,
                    help="replicas of every group across distinct "
                         "memory nodes (sharded/remote pools; >= 2 "
                         "survives a node death with transparent "
                         "failover, see docs/operations.md)")
    ap.add_argument("--endpoints", default="",
                    help="comma-separated host:port pool servers for "
                         "--pool remote (empty = fork --shards loopback "
                         "servers)")
    ap.add_argument("--trace", default="", metavar="FILE",
                    help="record spans with repro_torch.obs, write "
                         "Chrome-trace JSON to FILE, and print the "
                         "stage breakdown report")
    ap.add_argument("--slo", default="", metavar="SPEC",
                    help='latency SLO like "p99<5ms" (units us/ms/s) '
                         "scored per request by the micro-batcher; the "
                         "summary ends with the attainment/burn-rate "
                         "table and straggler verdicts")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.trace:
        from repro_torch.obs.trace import TRACER
        TRACER.configure()

    endpoints = tuple(e for e in args.endpoints.split(",") if e) or None
    with contextlib.ExitStack() as stack:
        if args.pool == "remote" and endpoints is None:
            from repro_torch.net import spawn_pool_servers
            print(f"forking {args.shards} loopback pool servers...")
            endpoints = tuple(stack.enter_context(
                spawn_pool_servers(args.shards)))
            print("  endpoints:", ", ".join(endpoints))

        print(f"indexing {args.n} vectors...")
        ds = sift_like(n=args.n, n_queries=64, seed=0)
        eng = DHNSWEngine(EngineConfig(mode="full", search_mode="scan", b=3,
                                       ef=32, n_rep=64, cache_frac=0.15,
                                       doorbell=16,
                                       quant="int8" if args.quant else "none",
                                       pool=args.pool, n_shards=args.shards,
                                       placement=args.placement,
                                       endpoints=endpoints,
                                       replication=args.replication),
                          device=args.device).build(ds.data)
        run_demo(args, ds, eng)


def print_slo_table(slo_report, straggler_report, straggler_stats):
    """SLO attainment / burn-rate table + straggler verdicts at exit."""
    print("\n  SLO attainment (burn = violation rate / error budget; "
          "short+long window min):")
    print(f"    {'tier':>6s} {'key':>6s} {'objective':>12s} {'n':>6s} "
          f"{'attain':>8s} {'burn':>6s} {'met':>4s}")
    for tier in sorted(slo_report):
        for key, r in sorted(slo_report[tier].items()):
            print(f"    {tier:>6s} {key:>6s} {r['slo']:>12s} {r['n']:>6d} "
                  f"{100 * r['attainment']:7.2f}% {r['burn']:6.2f} "
                  f"{'yes' if r['met'] else 'NO':>4s}")
    if straggler_report is None:
        return
    flagged = straggler_report.get("flagged", {})
    if not flagged:
        print(f"    stragglers: none flagged "
              f"({straggler_stats.get('checks', 0)} detector checks)")
        return
    for shard, info in sorted(flagged.items()):
        print(f"    STRAGGLER shard {shard}: {info['verb']} tail "
              f"{info['shard_q_s'] * 1e6:.1f} us vs fleet "
              f"{info['fleet_q_s'] * 1e6:.1f} us (x{info['ratio']:.1f}, "
              f"+{info['excess_s'] * 1e6:.1f} us penalty on reads)")


def print_endpoint_table(pool_snap):
    """Per-endpoint verb/byte table for remote transports: the measured
    wire traffic of each pool-server process."""
    shards = (pool_snap.get("shards", [])
              if pool_snap.get("kind") == "sharded" else [pool_snap])
    remote = [s for s in shards if s.get("kind") == "remote"]
    if not remote:
        return
    print(f"\n  remote endpoints (measured wire traffic):")
    print(f"    {'endpoint':>21s} {'frames':>7s} {'MB->srv':>8s} "
          f"{'MB<-srv':>8s} {'span rds':>8s} {'row rds':>8s} "
          f"{'appends':>7s} {'wire==model':>11s}")
    for s in remote:
        w, verbs = s["wire"], s["verbs"]
        spans = sum(v for k, v in verbs.items()
                    if k.startswith("read_spans"))
        rows = verbs.get("read_rows", 0) + verbs.get("read_quant_rows", 0)
        wvm = s.get("wire_vs_model", {})
        span_ok = all(
            v["measured"] == v["modeled"]
            for k, v in wvm.items() if k.startswith("read_spans")) \
            if wvm else True
        print(f"    {s['endpoint']:>21s} {w['frames_tx']:7d} "
              f"{w['bytes_tx'] / 1e6:8.2f} {w['bytes_rx'] / 1e6:8.2f} "
              f"{spans:8d} {rows:8d} {verbs.get('append', 0):7d} "
              f"{'yes' if span_ok else 'NO':>11s}")


def run_demo(args, ds, eng):
    # warm the pow2 batch shapes the batcher will produce
    b = 1
    while b <= 2 * args.clients:
        eng.search(ds.queries[:min(b, len(ds.queries))], k=10)
        b *= 2

    lock = threading.Lock()

    def serial_call(q):
        with lock:
            eng.search(q[None], k=10)

    warm = max(4, args.requests // 2)
    print(f"\n{args.clients} clients x {args.requests} requests, "
          f"one request per engine call (no batching):")
    closed_loop(args.clients, warm, ds.queries, serial_call)
    qps, p50, p95 = closed_loop(args.clients, args.requests, ds.queries,
                                serial_call)
    print(f"  {qps:8.1f} qps   p50 {p50:7.1f} ms   p95 {p95:7.1f} ms")

    print(f"\nsame load through the micro-batcher:")
    with SearchServer(eng, BatchPolicy(max_batch=64, max_wait_s=4e-3,
                                       slo=args.slo or None)) as srv:
        # warm the fused-shape jit caches like a long-running server
        closed_loop(args.clients, 2 * warm, ds.queries,
                    lambda q: srv.search(q, k=10))
        qps_b, p50_b, p95_b = closed_loop(args.clients, args.requests,
                                          ds.queries,
                                          lambda q: srv.search(q, k=10))
        snap = srv.stats()
        if args.trace:
            n_spans = srv.dump_trace(args.trace)
    print(f"  {qps_b:8.1f} qps   p50 {p50_b:7.1f} ms   p95 {p95_b:7.1f} ms")
    print(f"\n  speedup x{qps_b / qps:.2f}   mean fused batch "
          f"{snap['mean_fused_batch']:.1f}  over {snap['n_fused_calls']} "
          f"engine calls")
    bd = snap["breakdown_s"]
    total = sum(bd.values()) or 1.0
    print("  stage breakdown (share of request-seconds): " + "  ".join(
        f"{key[:-2]} {100 * v / total:.0f}%" for key, v in bd.items()))
    net = snap["net"]
    print(f"  network: {net['bytes_fetched'] / 1e6:.2f} MB fetched over "
          f"{net['round_trips']:.0f} round trips"
          + (f", {net['bytes_saved'] / 1e6:.2f} MB saved by the int8 tier"
             if net["bytes_saved"] else ""))
    if "wire_frames" in net:
        print(f"  wire (measured): {net['wire_bytes_rx'] / 1e6:.2f} MB "
              f"from servers / {net['wire_bytes_tx'] / 1e6:.2f} MB to "
              f"servers over {net['wire_frames']} frames")
    pool = snap.get("pool")
    if pool:
        print_endpoint_table(pool)
    if pool and pool.get("kind") == "sharded":
        print(f"\n  sharded pool: {pool['n_shards']} memory nodes, "
              f"placement={pool['placement']}, "
              f"replication={pool.get('replication', 1)}, "
              f"{pool['migration']['n']} migrations")
        fo = pool.get("failover", {})
        if fo.get("deaths") or fo.get("lost_groups"):
            print(f"    failover: {fo['deaths']} deaths, "
                  f"{fo['read_retries']} read retries, "
                  f"{fo['rereplicated_groups']} groups re-replicated, "
                  f"{fo['lost_groups']} lost")
        for i, sh in enumerate(pool["shards"]):
            tot = sh["totals"]
            verbs = sum(v for k, v in sh["verbs"].items()
                        if k.startswith(("read_spans", "append")))
            print(f"    shard {i}: {pool['groups_by_shard'][i]:3d} groups"
                  f"  {tot['bytes'] / 1e6:8.2f} MB"
                  f"  {tot['round_trips']:6.0f} trips"
                  f"  {verbs:5.0f} span/append verbs")

    if args.slo and snap.get("slo"):
        strag = strag_stats = None
        if hasattr(eng.pool, "check_stragglers"):
            strag = eng.pool.check_stragglers()
            strag_stats = eng.pool.straggler_stats
        print_slo_table(snap["slo"], strag, strag_stats)

    if args.trace:
        from repro_torch.obs import report
        from repro_torch.obs.trace import TRACER
        print(f"\n  wrote {args.trace} ({n_spans} spans) — open in "
              f"https://ui.perfetto.dev or chrome://tracing")
        print()
        print(report.render(TRACER.snapshot(), top=12))
        TRACER.disable()


if __name__ == "__main__":
    main()
