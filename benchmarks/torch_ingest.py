"""Ingestion bench through the PyTorch/CUDA port (the port of
``benchmarks/ingest.py``): the out-of-core bulk load, and crash recovery
of a durable memory node.

* ``load_rows`` — the streaming ``BulkLoader`` (``repro_torch.ingest``)
  builds the meta and the region from chunks of 1/8 of the dataset; the
  row asserts that both are bit-identical to ``build_meta`` +
  ``build_store`` on the whole data and reports the builder-memory story: ``peak_builder_mb`` beside the
  chunk and dataset bytes, and the group-shipping verbs the loader would
  put on the wire.  Like the reference's, this half is host work only
  (the loader and the region builder import no framework);
  ``chip_smoke.py`` phase 11 serves a streamed build on the card.
* ``recovery`` — one durable ``python -m repro_torch.net.server
  --data-dir`` process takes appends through a ``RemotePool`` beside an
  uninterrupted ``LocalPool`` twin on ``--device``, gets SIGKILL,
  restarts from its directory, and a client with ``attach="auto"`` must
  re-attach through the fingerprint handshake (WAL replay, not a region
  re-upload) and read spans bit-identical to the twin's.  The WAL and
  checkpoint byte counters are deterministic functions of the workload.

    PYTHONPATH=src python benchmarks/torch_ingest.py --smoke [--device cpu]

Writes ``BENCH_torch_ingest.json``.  ``--smoke`` is the reference's tiny
config, whose counted fields (``load_rows``: rows, chunks, failed chunks,
bit-identity, verbs issued, groups shipped; ``recovery``: every field but
the wall clock) equal ``benchmarks/baselines/BENCH_ingest.json``'s.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.hnsw import HNSWParams
from repro_torch.core.layout import build_store
from repro_torch.core.meta import build_meta
from repro_torch.data.synthetic import sift_like
from repro_torch.ingest import BulkLoader, chunked_source
from repro_torch.pool import LocalPool


class _ShipCounter:
    """Counts ``refresh_blocks`` verbs the loader would put on the wire."""

    def __init__(self):
        self.calls = 0
        self.blocks = 0

    def refresh_blocks(self, ids) -> None:
        self.calls += 1
        self.blocks += int(np.asarray(ids).size)


def run_load(*, smoke: bool = False) -> list[dict]:
    """Stream-build vs in-memory build: bit-identity + bounded memory."""
    n, n_rep = (1600, 12) if smoke else (20_000, 64)
    ds = sift_like(n=n, n_queries=8, seed=0)
    data = ds.data
    chunk_rows = n // 8
    p = HNSWParams(M=8, M0=16, ef_construction=80)

    meta0 = build_meta(data, n_rep, seed=0)
    store0 = build_store(data, meta0, sub_params=p)

    ship = _ShipCounter()
    t0 = time.perf_counter()
    ld = BulkLoader(n_rep=n_rep, chunk_rows=chunk_rows, seed=0,
                    sub_params=p)
    ld.add_chunks(chunked_source(data, chunk_rows))
    meta, store, rep = ld.finalize(into_pool=ship)
    ld.close()
    wall = time.perf_counter() - t0

    identical = (np.array_equal(store.graph_buf, store0.graph_buf)
                 and np.array_equal(store.vec_buf, store0.vec_buf)
                 and np.array_equal(store.meta_table, store0.meta_table)
                 and np.array_equal(meta.graph.adjacency,
                                    meta0.graph.adjacency))
    assert identical, "streamed region diverged from the in-memory build"
    assert rep.peak_builder_bytes < rep.dataset_bytes / 2, rep
    assert ship.calls == rep.verbs_issued
    row = {"rows": rep.rows, "dim": rep.dim, "chunk_rows": chunk_rows,
           "chunks": rep.chunks_total, "chunks_failed": rep.chunks_failed,
           "bit_identical": identical,
           "chunk_mb": round(rep.chunk_bytes / 1e6, 3),
           "dataset_mb": round(rep.dataset_bytes / 1e6, 3),
           "peak_builder_mb": round(rep.peak_builder_bytes / 1e6, 3),
           "verbs_issued": rep.verbs_issued,
           "groups_shipped": rep.groups_shipped,
           "wall_s": round(wall, 2)}
    print(f"load: {rep.rows} rows in {rep.chunks_total} chunks, peak "
          f"builder {row['peak_builder_mb']} MB vs dataset "
          f"{row['dataset_mb']} MB, {rep.groups_shipped} groups shipped, "
          f"bit-identical", flush=True)
    return [row]


def run_recovery(*, smoke: bool = False, device="cuda") -> dict:
    """Kill -9 a durable server mid-ingest; recover from its data-dir."""
    from repro_torch.net import RemotePool, spawn_pool_servers
    n, n_appends = (1500, 12) if smoke else (8_000, 64)
    ds = sift_like(n=n, n_queries=4, seed=0)
    meta = build_meta(ds.data, 8, seed=0, meta_levels=2)

    def mk_store():
        return build_store(ds.data, meta, ov_cap=max(n_appends, 8),
                           sub_params=HNSWParams(M=4, M0=8,
                                                 ef_construction=40))

    mirror = mk_store()         # the uninterrupted-run twin
    twin = LocalPool(mirror, device=device)
    with tempfile.TemporaryDirectory(prefix="repro_bench_ingest_") as ddir:
        with spawn_pool_servers(1, data_dirs=[ddir],
                                with_procs=True) as (eps, procs):
            pool = RemotePool(mk_store(), eps[0], device=device)
            for i in range(n_appends):
                vec = ds.data[0] + 0.01 * (i + 1)
                pid = i % mirror.spec.n_partitions
                gid = 1_000_000 + i
                assert pool.append(vec, gid, pid, ledger=None) >= 0
                twin.append(vec, gid, pid, ledger=None)
            pre = pool.server_stats()["ingest"]
            os.kill(procs[0].pid, signal.SIGKILL)
            procs[0].wait(timeout=10)

        t0 = time.perf_counter()
        with spawn_pool_servers(1, data_dirs=[ddir]) as eps2:
            pool2 = RemotePool(mirror, eps2[0], device=device,
                               attach="auto")
            wall = time.perf_counter() - t0
            assert pool2.attached_via == "recovered", \
                "recovery must come from the WAL, not a region re-upload"
            ing = pool2.server_stats()["ingest"]
            a = pool2.read_spans(np.arange(4), ledger=None)
        b = twin.read_spans(np.arange(4), ledger=None)
        for x, y in zip(a, b):
            assert torch.equal(x, y), \
                "recovered region diverged from the uninterrupted twin"

    row = {"n_appends": n_appends, "attached_via": "recovered",
           "wal_records": pre["wal_records"],
           "wal_kb": round(pre["wal_bytes"] / 1e3, 2),
           "replayed_records": ing["replayed_records"],
           "checkpoint_kb": round(ing["checkpoint_bytes"] / 1e3, 2),
           "recover_wall_s": round(wall, 2)}
    print(f"recovery: {row['wal_records']} WAL records "
          f"({row['wal_kb']} KB) -> kill -9 -> replayed "
          f"{row['replayed_records']}, re-attach via fingerprint "
          f"handshake in {row['recover_wall_s']} s, region bit-identical",
          flush=True)
    return row


def run(*, smoke: bool = False, out: str = "BENCH_torch_ingest.json",
        device="cuda") -> dict:
    blob = {"bench": "torch_ingest", "smoke": smoke,
            "load_rows": run_load(smoke=smoke),
            "recovery": run_recovery(smoke=smoke, device=device)}
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out}")
    return blob


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny CI config; asserts still run")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the twin and the remote pools "
                         "(default: the card)")
    ap.add_argument("--out", default="BENCH_torch_ingest.json")
    args = ap.parse_args()
    run(smoke=args.smoke, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
