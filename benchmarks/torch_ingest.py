"""Ingestion bench through the PyTorch/CUDA port (the ``load_rows`` half
of ``benchmarks/ingest.py``): the out-of-core bulk load against an
in-memory build of the same dataset.

The streaming ``BulkLoader`` (``repro_torch.ingest``) builds the meta and
the region from chunks of 1/8 of the dataset; the row asserts that both
are bit-identical to ``build_meta`` + ``build_store`` on the whole data
and reports the builder-memory story: ``peak_builder_mb`` beside the
chunk and dataset bytes, and the group-shipping verbs the loader would
put on the wire.  Like the reference's, this half is host work only (the
loader and the region builder import no framework); ``chip_smoke.py``
phase 11 serves a streamed build on the card.

    PYTHONPATH=src python benchmarks/torch_ingest.py --smoke

Writes ``BENCH_torch_ingest.json``.  ``--smoke`` is the reference's tiny
config, whose counted row (rows, chunks, failed chunks, bit-identity,
verbs issued, groups shipped) equals ``benchmarks/baselines/
BENCH_ingest.json``'s ``load_rows``.  The ``recovery`` half needs the
port's write-ahead log and pool server, which are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.hnsw import HNSWParams
from repro_torch.core.layout import build_store
from repro_torch.core.meta import build_meta
from repro_torch.data.synthetic import sift_like
from repro_torch.ingest import BulkLoader, chunked_source


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


def run(*, smoke: bool = False, out: str = "BENCH_torch_ingest.json") -> dict:
    blob = {"bench": "torch_ingest", "smoke": smoke,
            "load_rows": run_load(smoke=smoke)}
    with open(out, "w") as f:
        json.dump(blob, f, indent=2)
    print(f"wrote {out}")
    return blob


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny CI config; asserts still run")
    ap.add_argument("--out", default="BENCH_torch_ingest.json")
    args = ap.parse_args()
    run(smoke=args.smoke, out=args.out)


if __name__ == "__main__":
    main()
