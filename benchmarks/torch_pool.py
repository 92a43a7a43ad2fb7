"""Memory-pool transport sweep through the PyTorch/CUDA port (the port of
``benchmarks/pool.py``): modeled latency vs network parameters, shard
count x placement, and straggler chaos.

* ``rows`` — the same workload through ``SimulatedRDMAPool`` across a
  grid of fabric calibrations (round-trip time and bandwidth scaled
  around the paper's ConnectX-6 testbed): counted verbs (round trips,
  doorbell descriptors, bytes a query) and the pool's modeled wire time a
  query with its per-verb breakdown.
* ``shard_rows`` (``--shards`` runs only these) — a zipf-skewed workload
  through ``ShardedPool`` across shard count x placement policy, the last
  shard a deliberate straggler (8x slower fabric): modeled us a query,
  per-shard wire bytes and their imbalance, migrations, and each shard's
  1/N staged device footprint.  ``freq`` must beat ``round_robin``.
* ``chaos_latency`` (``--chaos-latency`` runs only this) — a seeded
  ``WRInjector`` degrades every WR post on one shard of a 3-shard
  ``replication=2`` sim-RDMA pool; on the modeled clock the straggler
  detector must flag exactly that shard, replica-ranked reads route
  around it, the tail sampler keeps the slow batches, the SLO burn spikes
  and recovers, and every batch stays bit-identical to ``LocalPool``.

* ``transport_rows`` (``--transport`` runs only these) — the same
  workload through ``LocalPool``, ``SimulatedRDMAPool`` and a
  ``RemotePool`` over each bearer: loopback (an in-process
  ``HostRegion``) and tcp (one forked ``python -m repro_torch.net.server``
  process).  Beside the ledger's modeled bytes each remote row reports the
  measured wire payload and frames, and asserts span parity (measured ==
  modeled).
* ``chaos`` (``--chaos`` runs only this) — the failover gate:
  ``replication=2`` over three forked servers, one killed with SIGKILL
  mid-run; no error reaches the caller, every batch stays bit-identical to
  ``LocalPool``, and the failover counters and per-batch wall percentiles
  are reported.

    PYTHONPATH=src python benchmarks/torch_pool.py --smoke [--device cpu]

Writes ``BENCH_torch_pool.json``.  Every gated field of ``--smoke``
(counted verbs, the modeled clock, measured wire bytes and frames, the
failover counters) equals ``benchmarks/baselines/BENCH_pool.json``'s.
Runs on the card unless ``--device cpu``.  Every in-process engine reads
its spans through the port's doorbell gather kernel
(``use_gather_kernel``; on CPU tensors its plain version); a remote
engine's spans arrive over the wire and are uploaded to the device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G, Fabric
from repro_torch.data.synthetic import sift_like
from repro_torch.pool.placement import FrequencyAwarePlacement

def fabric_grid(smoke: bool) -> list[Fabric]:
    base = RDMA_100G
    grid = [base]
    rtt_scales = (5.0,) if smoke else (5.0, 25.0)
    bw_scales = (0.25,) if smoke else (0.25, 0.0625)
    for s in rtt_scales:
        grid.append(Fabric(f"rtt-x{s:g}", rtt_s=base.rtt_s * s,
                           bw_Bps=base.bw_Bps, per_op_s=base.per_op_s * s,
                           max_doorbell=base.max_doorbell))
    for s in bw_scales:
        grid.append(Fabric(f"bw-x{s:g}", rtt_s=base.rtt_s,
                           bw_Bps=base.bw_Bps * s, per_op_s=base.per_op_s,
                           max_doorbell=base.max_doorbell))
    return grid


def run_cell(data, queries, *, mode: str, quant: str, fabric: Fabric,
             n_rep: int, n_batches: int, device="cuda") -> dict:
    cfg = EngineConfig(mode=mode, search_mode="scan", b=4, ef=48,
                       n_rep=n_rep, cache_frac=0.25, doorbell=16,
                       fabric=fabric, seed=0, quant=quant, pool="sim_rdma",
                       use_gather_kernel=True)
    eng = DHNSWEngine(cfg, device=device).build(data)
    per = max(len(queries) // n_batches, 1)
    nq = 0
    t0 = time.perf_counter()
    for i in range(n_batches):
        qb = queries[i * per:(i + 1) * per]
        eng.search(qb, k=10)
        nq += len(qb)
    wall = time.perf_counter() - t0
    snap = eng.pool.snapshot()
    tot = snap["totals"]
    return {"mode": mode, "quant": quant, "fabric": fabric.name,
            "fabric_params": snap["fabric"],
            "rtt_us": fabric.rtt_s * 1e6,
            "bw_GBps": fabric.bw_Bps / 1e9,
            "round_trips_per_q": round(tot["round_trips"] / nq, 3),
            "descriptors_per_q": round(tot["descriptors"] / nq, 3),
            "kb_per_q": round(tot["bytes"] / nq / 1e3, 2),
            "sim_us_per_q": round(snap["sim_total_s"] / nq * 1e6, 3),
            "sim_breakdown_us": {v: round(s * 1e6, 2)
                                 for v, s in snap["sim_s"].items()},
            "wall_s": round(wall, 2)}


def straggler_fabrics(n_shards: int, slowdown: float = 8.0) -> tuple:
    """n_shards fabrics, the last one ``slowdown``x worse on every term."""
    base = RDMA_100G
    slow = Fabric(f"straggler-x{slowdown:g}", rtt_s=base.rtt_s * slowdown,
                  bw_Bps=base.bw_Bps / slowdown,
                  per_op_s=base.per_op_s * slowdown,
                  max_doorbell=base.max_doorbell)
    return (base,) * (n_shards - 1) + (slow,)


def shard_config(*, n_shards: int, placement: str, n_rep: int,
                 migrate_every: int, **kw) -> EngineConfig:
    """One shard cell's engine: sim-RDMA children over
    ``straggler_fabrics``; ``placement="freq"`` is the frequency-aware
    policy migrating every ``migrate_every`` charged span reads (``kw``
    overrides any field)."""
    pol = (FrequencyAwarePlacement(migrate_every=migrate_every,
                                   max_moves=4)
           if placement == "freq" else placement)
    cfg = dict(mode="full", search_mode="scan", b=3, ef=48, n_rep=n_rep,
               cache_frac=0.1, doorbell=16, fabric=RDMA_100G, seed=0,
               pool="sharded", n_shards=n_shards,
               shard_transport="sim_rdma",
               shard_fabrics=straggler_fabrics(n_shards), placement=pol,
               use_gather_kernel=True)
    cfg.update(kw)
    return EngineConfig(**cfg)


def zipf_batches(n_queries: int, n_batches: int, per_batch: int):
    """The shard cells' zipf-skewed closed workload: ``n_batches`` draws
    of ``per_batch`` query indices (rng seed 0, p ~ 1/rank), so a few hot
    queries, and so a few hot groups, dominate the wire."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, n_queries + 1)
    p /= p.sum()
    for _ in range(n_batches):
        yield rng.choice(n_queries, size=per_batch, p=p)


def shard_row(snap: dict, *, n_shards: int, placement: str, nq: int,
              wall: float) -> dict:
    """A shard cell's row from the pool snapshot after ``nq`` queries."""
    by_shard = [s["totals"]["bytes"] for s in snap["shards"]]
    mean_b = max(sum(by_shard) / len(by_shard), 1.0)
    # 1/N block-compacted staging: each child's device region holds only
    # its owned groups, so the per-shard staged footprint is a
    # deterministic function of placement
    stg = snap.get("staging", {})
    staged_mb = [round(b / 1e6, 3)
                 for b in stg.get("device_bytes_by_shard", [])]
    return {"n_shards": n_shards, "placement": placement,
            "staged_mb_by_shard": staged_mb,
            "staged_mb_max": max(staged_mb) if staged_mb else 0.0,
            "restaged_blocks": stg.get("restaged_blocks", 0),
            "sim_us_per_q": round(snap["sim_total_s"] / nq * 1e6, 3),
            "round_trips_per_q": round(
                snap["totals"]["round_trips"] / nq, 3),
            "kb_per_q": round(snap["totals"]["bytes"] / nq / 1e3, 2),
            "bytes_by_shard_mb": [round(b / 1e6, 3) for b in by_shard],
            "byte_imbalance": round(max(by_shard) / mean_b, 3),
            "migrations": snap["migration"]["n"],
            "groups_by_shard": snap["groups_by_shard"],
            "wall_s": round(wall, 2)}


def run_shard_cell(data, queries, *, n_shards: int, placement: str,
                   n_rep: int, n_batches: int, per_batch: int,
                   migrate_every: int, device="cuda") -> dict:
    cfg = shard_config(n_shards=n_shards, placement=placement, n_rep=n_rep,
                       migrate_every=migrate_every)
    eng = DHNSWEngine(cfg, device=device).build(data)
    nq = 0
    t0 = time.perf_counter()
    for idx in zipf_batches(len(queries), n_batches, per_batch):
        eng.search(queries[idx], k=10)
        nq += per_batch
    wall = time.perf_counter() - t0
    return shard_row(eng.pool.snapshot(), n_shards=n_shards,
                     placement=placement, nq=nq, wall=wall)


def run_shards(*, smoke: bool = False, device="cuda") -> list[dict]:
    """Shard count x placement sweep on the skewed straggler workload."""
    if smoke:
        n, n_rep, n_batches, per_batch, migrate_every = 1500, 12, 12, 32, 32
        counts = (2,)
        placements = ("round_robin", "freq")
    else:
        n, n_rep, n_batches, per_batch, migrate_every = (20_000, 64, 16,
                                                         64, 64)
        counts = (2, 4)
        placements = ("round_robin", "size_balanced", "freq")
    ds = sift_like(n=n, n_queries=64, seed=0)
    rows = []
    print(f"{'shards':>6s} {'placement':>13s} {'sim us/q':>9s} "
          f"{'imb':>6s} {'moves':>5s} {'staged MB':>18s}")
    for n_shards in counts:
        for placement in placements:
            row = run_shard_cell(ds.data, ds.queries, n_shards=n_shards,
                                 placement=placement, n_rep=n_rep,
                                 n_batches=n_batches, per_batch=per_batch,
                                 migrate_every=migrate_every, device=device)
            rows.append(row)
            staged = "/".join(f"{x:.1f}" for x in row["staged_mb_by_shard"])
            print(f"{n_shards:6d} {placement:>13s} "
                  f"{row['sim_us_per_q']:9.3f} "
                  f"{row['byte_imbalance']:6.3f} "
                  f"{row['migrations']:5d} {staged:>18s}", flush=True)
    return rows


def run_transport_cell(data, queries, *, transport: str, n_rep: int,
                       n_batches: int, endpoint=None, bearer: str = "tcp",
                       device="cuda") -> dict:
    """One workload through one transport; modeled ledger numbers next
    to (for remote) the measured wire traffic.  ``bearer`` picks the
    remote QP bearer: ``tcp`` frames WRs to a forked ``PoolServer``,
    ``loopback`` runs the identical verbs path against an in-process
    ``HostRegion`` — same frames, no sockets."""
    cfg = EngineConfig(mode="full", search_mode="scan", b=4, ef=48,
                       n_rep=n_rep, cache_frac=0.25, doorbell=16,
                       fabric=RDMA_100G, seed=0, quant="none",
                       pool=transport, bearer=bearer,
                       endpoints=(endpoint,) if endpoint else None,
                       use_gather_kernel=True)
    eng = DHNSWEngine(cfg, device=device).build(data)
    per = max(len(queries) // n_batches, 1)
    nq = 0
    t0 = time.perf_counter()
    for i in range(n_batches):
        qb = queries[i * per:(i + 1) * per]
        eng.search(qb, k=10)
        nq += len(qb)
    wall = time.perf_counter() - t0
    snap = eng.pool.snapshot()
    tot = snap["totals"]
    row = {"transport": transport,
           "round_trips_per_q": round(tot["round_trips"] / nq, 3),
           "descriptors_per_q": round(tot["descriptors"] / nq, 3),
           "model_kb_per_q": round(tot["bytes"] / nq / 1e3, 2),
           "wall_s": round(wall, 2)}
    if transport == "remote":
        wire = snap["wire"]
        wvm = snap["wire_vs_model"]["read_spans"]
        # the ledger's modeled span bytes must equal what actually
        # crossed the bearer (socket payload for tcp, HostRegion frames
        # for loopback)
        assert wvm["measured"] == wvm["modeled"], wvm
        row.update({
            "bearer": snap["bearer"],
            "endpoint": snap.get("endpoint"),
            "wire_kb_per_q": round(
                wire["payload_by_verb"]["read_spans"] / nq / 1e3, 2),
            "wire_frames": wire["frames_tx"],
            "wire_frame_overhead_kb": round(
                (wire["bytes_rx"] + wire["bytes_tx"]
                 - sum(wire["payload_by_verb"].values())) / 1e3, 2),
            "inflight_peak": wire["inflight_peak"],
            "span_wire_vs_model": wvm["ratio"]})
    elif transport == "sim_rdma":
        row["sim_us_per_q"] = round(snap["sim_total_s"] / nq * 1e6, 3)
        row["fabric"] = snap["fabric"]
    return row


def run_transports(*, smoke: bool = False, device="cuda") -> list[dict]:
    """LocalPool vs SimulatedRDMAPool vs a RemotePool over each QP
    bearer — loopback (in-process HostRegion) and tcp (one forked
    server process) — on the same workload."""
    from repro_torch.net import spawn_pool_servers
    n, n_rep, n_batches = (1500, 12, 2) if smoke else (20_000, 64, 4)
    ds = sift_like(n=n, n_queries=128 if smoke else 256, seed=0)
    cells = (("local", "tcp"), ("sim_rdma", "tcp"),
             ("remote", "loopback"), ("remote", "tcp"))
    rows = []
    print(f"{'transport':>15s} {'rt/q':>7s} {'model KB/q':>11s} "
          f"{'wire KB/q':>10s} {'wall s':>7s}")
    with spawn_pool_servers(1) as endpoints:
        for transport, bearer in cells:
            remote_tcp = transport == "remote" and bearer == "tcp"
            row = run_transport_cell(
                ds.data, ds.queries, transport=transport, n_rep=n_rep,
                n_batches=n_batches, bearer=bearer,
                endpoint=endpoints[0] if remote_tcp else None,
                device=device)
            rows.append(row)
            label = (f"{transport}/{bearer}" if transport == "remote"
                     else transport)
            print(f"{label:>15s} {row['round_trips_per_q']:7.3f} "
                  f"{row['model_kb_per_q']:11.2f} "
                  f"{row.get('wire_kb_per_q', float('nan')):10.2f} "
                  f"{row['wall_s']:7.2f}", flush=True)
    return rows


def run_chaos(*, smoke: bool = False, device="cuda") -> dict:
    """Kill -9 one of three replicated pool servers mid-run.

    The same batch stream is driven through a ``replication=2`` remote
    pool and a ``LocalPool`` reference in lockstep (same call index, so
    compute-side caches warm identically).  Halfway through, one
    ``PoolServer`` gets SIGKILL.  Asserts the failover contract — no
    error surfaces, results stay bit-identical — and reports per-batch
    latency percentiles plus the failover counters.
    """
    from repro_torch.net import spawn_pool_servers
    n, n_rep, n_batches = (1500, 12, 8) if smoke else (8_000, 32, 16)
    ds = sift_like(n=n, n_queries=64, seed=0)
    kw = dict(mode="full", search_mode="scan", b=3, ef=32, n_rep=n_rep,
              cache_frac=0.25, doorbell=16, fabric=RDMA_100G, seed=0,
              use_gather_kernel=True)
    ref = DHNSWEngine(EngineConfig(pool="local", **kw),
                      device=device).build(ds.data)
    per = max(len(ds.queries) // n_batches, 1)
    kill_at = n_batches // 2
    lat, mismatches = [], 0
    # 3 servers so R=2 does NOT fully replicate: the kill strips one
    # replica from ~2/3 of the groups and forces real re-replication
    with spawn_pool_servers(3, with_procs=True) as (eps, procs):
        eng = DHNSWEngine(EngineConfig(pool="remote", endpoints=tuple(eps),
                                       replication=2, **kw),
                          device=device).build(ds.data)
        for i in range(n_batches):
            qb = ds.queries[i * per:(i + 1) * per]
            if i == kill_at:
                procs[0].kill()
                procs[0].wait(timeout=10)
            t0 = time.perf_counter()
            d, g, _ = eng.search(qb, k=10)
            lat.append(time.perf_counter() - t0)
            dr, gr, _ = ref.search(qb, k=10)
            if not (np.array_equal(d, dr) and np.array_equal(g, gr)):
                mismatches += 1
        snap = eng.pool.snapshot()
    assert mismatches == 0, \
        f"{mismatches} post-kill batches diverged from LocalPool"
    fo = snap["failover"]
    assert fo["deaths"] == 1 and fo["lost_groups"] == 0, fo
    arr = np.asarray(lat, np.float64) * 1e3
    # bounded p99: every batch completed (no hang on the dead socket);
    # the kill batch pays dead-socket detection + re-replication once
    assert np.all(np.isfinite(arr)) and float(arr.max()) < 60_000.0, arr
    row = {"replication": 2, "n_batches": n_batches,
           "kill_batch": kill_at, "deaths": fo["deaths"],
           "read_retries": fo["read_retries"],
           "rereplicated_groups": fo["rereplicated_groups"],
           "rereplicate_mb": round(fo["rereplicate_bytes"] / 1e6, 3),
           "lost_groups": fo["lost_groups"],
           "bit_identical_to_local": True,
           "p50_ms": round(float(np.percentile(arr, 50)), 3),
           "p99_ms": round(float(np.percentile(arr, 99)), 3),
           "kill_batch_ms": round(float(arr[kill_at]), 3)}
    print(f"chaos: kill -9 at batch {kill_at}/{n_batches}, "
          f"rereplicated {row['rereplicated_groups']} groups "
          f"({row['rereplicate_mb']} MB), p50 {row['p50_ms']} ms, "
          f"p99 {row['p99_ms']} ms, kill batch {row['kill_batch_ms']} ms, "
          f"bit-identical to local", flush=True)
    return row


def run_chaos_latency(*, smoke: bool = False, device="cuda") -> dict:
    """Seeded WR-latency chaos on one shard of a replicated sharded pool.

    A ``WRInjector`` degrades every WR post on shard 1 of a 3-shard
    ``replication=2`` sim-RDMA pool.  Two engines run the same batch
    stream: one with the straggler detector on (``straggler_check_every``),
    one with it off.  Asserted on the modeled clock (injection lands in
    the observed histograms, never in the cost model): the detector flags
    exactly the injected shard and reads route around it; the
    post-detection modeled p99 is cut vs the detection-off twin; the tail
    sampler keeps the slow batches; the SLO burn spikes above 1 and
    recovers; every batch is bit-identical to a ``LocalPool`` reference.
    """
    from repro_torch.obs.hist import StragglerDetector
    from repro_torch.obs.slo import SLO, SLOTracker
    from repro_torch.obs.trace import TRACER
    from repro_torch.rdma.inject import WRInjector

    n, n_rep = (1500, 12) if smoke else (8_000, 32)
    warm, injected, post = (8, 6, 6) if smoke else (10, 8, 8)
    n_batches = warm + injected + post
    per = 8
    ds = sift_like(n=n, n_queries=64, seed=0)
    base = dict(mode="full", search_mode="scan", b=3, ef=32, n_rep=n_rep,
                cache_frac=0.25, doorbell=16, fabric=RDMA_100G, seed=0,
                use_gather_kernel=True)
    ref = DHNSWEngine(EngineConfig(pool="local", **base),
                      device=device).build(ds.data)
    shard_kw = dict(base, pool="sharded", shard_transport="sim_rdma",
                    n_shards=3, replication=2)
    eng_on = DHNSWEngine(EngineConfig(**shard_kw, straggler_check_every=1),
                         device=device).build(ds.data)
    eng_off = DHNSWEngine(EngineConfig(**shard_kw),
                          device=device).build(ds.data)
    # small workload: fewer samples per (verb, shard) than the detector's
    # production default before it may judge a shard
    eng_on.pool.straggler = StragglerDetector(min_count=4,
                                              min_excess_s=2e-4)
    inj_on = WRInjector(seed=7, delay_s=2e-3)
    inj_off = WRInjector(seed=7, delay_s=2e-3)

    TRACER.configure(trace_id=71, tail=True, tail_quantile=0.95,
                     tail_window=64)
    slo = SLOTracker(SLO(0.99, 0.0, name="p99<model"), short_window=4,
                     long_window=64)
    dts_on, dts_off, burns = [], [], []
    mismatches = 0
    reroute_batch = -1
    for i in range(n_batches):
        if i == warm:
            # SLO threshold: 2x the worst healthy (warm) modeled batch
            thr = 2.0 * max(dts_on)
            slo.slos["serve"] = SLO(0.99, thr, name="p99<model")
            eng_on.pool.children[1].set_injector(inj_on)
            eng_off.pool.children[1].set_injector(inj_off)
            TRACER.set_phase("injected")
        elif i == warm + injected:
            eng_on.pool.children[1].set_injector(None)
            eng_off.pool.children[1].set_injector(None)
            TRACER.set_phase("post")
        elif i == 0:
            TRACER.set_phase("warm")
        s = i % (len(ds.queries) // per)
        qb = ds.queries[s * per:(s + 1) * per]
        # one root per batch: engine spans become children, and the
        # keep/drop decision runs on the deterministic modeled seconds
        with TRACER.span("bench.batch", tier="bench", batch=i) as sp:
            t_on = eng_on.pool.sim_total_s
            d1, g1, _ = eng_on.search(qb, k=10)
            dt_on = eng_on.pool.sim_total_s - t_on
            t_off = eng_off.pool.sim_total_s
            d2, g2, _ = eng_off.search(qb, k=10)
            dt_off = eng_off.pool.sim_total_s - t_off
            dr, gr, _ = ref.search(qb, k=10)
            sp.set(model_s=dt_on)
        for d, g in ((d1, g1), (d2, g2)):
            if not (np.array_equal(d, dr) and np.array_equal(g, gr)):
                mismatches += 1
        dts_on.append(dt_on)
        dts_off.append(dt_off)
        if i >= warm:
            slo.record("serve", "bench", dt_on)
            burns.append(slo.report()["serve"]["bench"]["burn"])
        if reroute_batch < 0 and not np.any(eng_on.pool._serve == 1):
            reroute_batch = i
    TRACER.set_phase(None)

    assert mismatches == 0, \
        f"{mismatches} chaos batches diverged from LocalPool"
    strag = eng_on.pool.snapshot()["stragglers"]
    assert set(strag["flagged"]) == {"1"}, strag
    assert warm <= reroute_batch < warm + injected, reroute_batch
    assert np.any(eng_off.pool._serve == 1)   # detection off: no reroute
    assert inj_on.posts > 0 and inj_off.posts > inj_on.posts

    # modeled p99 over the post-detection injected window: the rerouted
    # engine no longer pays the injected delay, its twin still does
    win = [b for b in range(warm, warm + injected) if b > reroute_batch]
    assert win, "reroute left no post-detection injected batches"
    p99_on = float(np.percentile(np.asarray(dts_on)[win], 99))
    p99_off = float(np.percentile(np.asarray(dts_off)[win], 99))
    assert p99_on < p99_off, (p99_on, p99_off)

    burn_peak = max(burns)
    burn_final = burns[-1]
    assert burn_peak > 1.0, burns
    assert burn_final < 1.0, burns

    spans = TRACER.snapshot()
    slow = [s for s in spans if s["name"] == "bench.batch"
            and s["attrs"].get("why_kept") == "latency"
            and s["attrs"].get("phase") == "injected"]
    assert slow, "tail sampler kept no injected slow-batch traces"
    health = TRACER.health()
    TRACER.disable()

    row = {"n_shards": 3, "replication": 2, "injected_shard": 1,
           "flagged_shard": 1, "delay_us": 2000,
           "n_batches": n_batches, "warm_batches": warm,
           "mismatches": mismatches, "bit_identical_to_local": True,
           "eng_off_serves_injected_shard": True, "burn_recovered": True,
           "reroute_batch": reroute_batch,
           "checks": strag["checks"],
           "moved_groups": strag["moved_groups"],
           "detector_flags": strag["flagged_now"],
           "injected_posts": inj_on.posts,
           "p99_on_us": round(p99_on * 1e6, 3),
           "p99_off_us": round(p99_off * 1e6, 3),
           "p99_cut_ratio": round(p99_on / p99_off, 4),
           "burn_peak": round(burn_peak, 3),
           "kept_traces": health["kept"],
           "discarded_traces": health["discarded"],
           "why_kept_latency": len(slow),
           "ring_dropped": health["dropped"]}
    print(f"chaos-latency: injected shard 1 ({row['delay_us']} us/post), "
          f"flagged at batch {reroute_batch}, moved "
          f"{row['moved_groups']} groups, p99 {row['p99_off_us']} -> "
          f"{row['p99_on_us']} modeled us (x{row['p99_cut_ratio']}), "
          f"burn peak {row['burn_peak']} -> {round(burn_final, 3)}, "
          f"{row['why_kept_latency']} slow traces kept", flush=True)
    return row


def _load_blob(out: str, fallback: dict) -> dict:
    """Partial sweeps refresh only their table: keep any previously
    written rows (and their metadata)."""
    try:
        with open(out) as f:
            return json.load(f)
    except (OSError, ValueError):
        return fallback


def _one_table(out: str, smoke: bool, meta: dict, table: str, fn) -> dict:
    """A partial sweep: refresh ``table`` in ``out``, keep the rest."""
    blob = _load_blob(out, {"bench": "pool", "smoke": smoke, "rows": []})
    blob.update(meta)
    blob[table] = fn()
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out} ({table})")
    return blob


def run(*, smoke: bool = False, out: str = "BENCH_torch_pool.json",
        device="cuda", shards_only: bool = False,
        transport_only: bool = False, chaos_only: bool = False,
        chaos_latency_only: bool = False) -> dict:
    if smoke:
        n, n_rep, n_batches = 1500, 12, 2
        modes = ("full",)
        quants = ("none", "int8")
    else:
        n, n_rep, n_batches = 20_000, 64, 4
        modes = ("naive", "no_doorbell", "full")
        quants = ("none", "int8")
    dev = torch.device(device)
    meta = {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}
    if transport_only:
        return _one_table(out, smoke, meta, "transport_rows",
                          lambda: run_transports(smoke=smoke, device=device))
    if chaos_only:
        return _one_table(out, smoke, meta, "chaos",
                          lambda: run_chaos(smoke=smoke, device=device))
    if chaos_latency_only:
        return _one_table(out, smoke, meta, "chaos_latency",
                          lambda: run_chaos_latency(smoke=smoke,
                                                    device=device))
    rows = []
    if not shards_only:
        ds = sift_like(n=n, n_queries=256, seed=0)
        print(f"{'fabric':>10s} {'mode':>12s} {'quant':>5s} {'rt/q':>7s} "
              f"{'KB/q':>9s} {'sim us/q':>9s}")
        for fabric in fabric_grid(smoke):
            for mode in modes:
                for quant in quants:
                    row = run_cell(ds.data, ds.queries, mode=mode,
                                   quant=quant, fabric=fabric, n_rep=n_rep,
                                   n_batches=n_batches, device=device)
                    rows.append(row)
                    print(f"{row['fabric']:>10s} {mode:>12s} {quant:>5s} "
                          f"{row['round_trips_per_q']:7.3f} "
                          f"{row['kb_per_q']:9.2f} "
                          f"{row['sim_us_per_q']:9.3f}", flush=True)

    shard_rows = run_shards(smoke=smoke, device=device)
    if shards_only:
        blob = _load_blob(out, {"bench": "pool", "smoke": smoke,
                                "rows": rows})
        blob.update(meta)
        blob["shard_rows"] = shard_rows
    else:
        blob = {"bench": "pool", "smoke": smoke, "n": n, "n_rep": n_rep,
                "n_batches": n_batches, **meta, "rows": rows,
                "shard_rows": shard_rows}
        blob["transport_rows"] = run_transports(smoke=smoke, device=device)
        blob["chaos"] = run_chaos(smoke=smoke, device=device)
        blob["chaos_latency"] = run_chaos_latency(smoke=smoke, device=device)
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out} ({len(blob['rows'])} + {len(shard_rows)} shard "
          f"+ {len(blob.get('transport_rows', []))} transport rows)")
    return blob


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny CI config")
    ap.add_argument("--shards", action="store_true",
                    help="run only the shard count x placement sweep")
    ap.add_argument("--transport", action="store_true",
                    help="run only the transport comparison (local vs "
                         "sim_rdma vs remote over loopback and tcp; spawns "
                         "a server)")
    ap.add_argument("--chaos", action="store_true",
                    help="run only the failover chaos gate (replication=2 "
                         "over three servers, kill -9 one mid-run)")
    ap.add_argument("--chaos-latency", action="store_true",
                    help="run only the straggler chaos gate (seeded WR "
                         "latency injection on one shard)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    ap.add_argument("--out", default="BENCH_torch_pool.json")
    args = ap.parse_args()
    run(smoke=args.smoke, out=args.out, device=args.device,
        shards_only=args.shards, transport_only=args.transport,
        chaos_only=args.chaos, chaos_latency_only=args.chaos_latency)


if __name__ == "__main__":
    main()
