"""The port's bulk loading and compaction (``repro_torch.ingest``) on the
CPU: twins of the reference's loader, ``build_streaming``, mutation-hook,
compactor and metrics tests, the port's ``BulkLoader`` against the
reference's on the same seeded chunks (bit-identical meta, region, int8
mirror and report), and ``benchmarks/torch_ingest.py --smoke`` against
the counted ``load_rows`` of ``benchmarks/baselines/BENCH_ingest.json``.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core.hnsw import HNSWParams  # noqa: E402
from repro_torch.core.layout import MT_OV_A, MT_OV_B, build_store  # noqa: E402
from repro_torch.core.meta import build_meta  # noqa: E402
from repro_torch.ingest import (BulkLoader, CompactionPolicy,  # noqa: E402
                                Compactor, chunked_source)
from repro_torch.pool.local import LocalPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _tiny_store(data, ov_cap=0):
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    return build_store(data, meta, ov_cap=ov_cap,
                       sub_params=HNSWParams(M=4, M0=8, ef_construction=40))


# --------------------------------------------------------- bulk loading

def test_bulk_loader_bit_identical_bounded_memory(sift_small):
    """Streaming with a chunk budget of 1/8 of the dataset reproduces the
    in-memory meta + region bit for bit, with O(chunk) peak builder
    memory."""
    data = sift_small.data[:1600]
    n, dim = data.shape
    chunk_rows = n // 8
    p = HNSWParams(M=4, M0=8, ef_construction=40)
    meta0 = build_meta(data, 12, seed=3, meta_levels=3)
    store0 = build_store(data, meta0, sub_params=p)
    ld = BulkLoader(n_rep=12, chunk_rows=chunk_rows, seed=3, meta_levels=3,
                    sub_params=p)
    ld.add_chunks(chunked_source(data, chunk_rows))
    meta, store, rep = ld.finalize()
    ld.close()
    assert np.array_equal(meta.graph.vectors, meta0.graph.vectors)
    assert np.array_equal(meta.graph.adjacency, meta0.graph.adjacency)
    assert meta.graph.entry == meta0.graph.entry
    assert np.array_equal(meta.assignments, meta0.assignments)
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        assert np.array_equal(getattr(store, a), getattr(store0, a)), a
    assert store.spec == store0.spec
    assert rep.rows == n and rep.chunks_ok == 8 and rep.chunks_failed == 0
    assert rep.dataset_bytes == n * dim * 4
    assert rep.peak_builder_bytes < rep.dataset_bytes / 2
    assert rep.peak_builder_bytes <= 4 * rep.chunk_bytes + 12 * dim * 4


def test_bulk_loader_error_queue_and_retry():
    """Bad chunks land in the retryable error queue instead of aborting;
    ``retry_failed`` with a fix recovers them."""
    rng = np.random.default_rng(0)
    good = rng.standard_normal((300, 16)).astype(np.float32)
    nan_chunk = good[:50].copy()
    nan_chunk[3, 2] = np.nan
    ld = BulkLoader(n_rep=6, chunk_rows=100, seed=0, meta_levels=2,
                    sub_params=HNSWParams(M=4, M0=8, ef_construction=40))
    ld.add_chunks([good[:100], nan_chunk, "not an array", good[100:200],
                   good[:10, None, :]])          # 3-D: wrong rank
    assert ld.report.chunks_total == 5
    assert ld.report.chunks_ok == 2 and ld.report.chunks_failed == 3
    assert {fc.index for fc in ld.error_queue} == {1, 2, 4}

    def fix(chunk):
        arr = np.asarray(chunk, np.float32) if not isinstance(chunk, str) \
            else good[200:250]
        arr = arr.reshape(-1, 16) if arr.ndim == 3 else arr
        return np.nan_to_num(arr)

    assert ld.retry_failed(fix=fix) == 3
    assert not ld.error_queue and ld.report.chunks_retried == 3
    meta, store, rep = ld.finalize()
    ld.close()
    assert rep.rows == 100 + 50 + 50 + 100 + 10
    assert store.n_base.sum() == rep.rows
    ld2 = BulkLoader(n_rep=4, chunk_rows=50, seed=0, meta_levels=2)
    ld2.add_chunks([good[:50], "junk"])
    assert ld2.retry_failed() == 0
    assert ld2.error_queue[0].retries == 1 and ld2.error_queue[0].reason
    ld2.close()


def test_bulk_loader_ships_groups_through_pool_verb():
    """``finalize(into_pool=...)`` ships every finished group through
    ``refresh_blocks`` of a port ``LocalPool`` staged with the empty
    region: one verb per group, and the pool ends with the loaded
    region on its device."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal((500, 16)).astype(np.float32)
    p = HNSWParams(M=4, M0=8, ef_construction=40)
    ld = BulkLoader(n_rep=8, chunk_rows=100, seed=0, meta_levels=2,
                    sub_params=p)
    ld.add_chunks(chunked_source(data, 100))

    calls = []

    class _Ship:
        pool = None

        def refresh_blocks(self, ids):
            calls.append(np.asarray(ids))

    meta, store, rep = ld.finalize(into_pool=_Ship())
    ld.close()
    n_groups = store.spec.n_groups
    assert rep.verbs_issued == rep.groups_shipped == n_groups == len(calls)
    gb = store.spec.group_blocks
    assert np.array_equal(np.sort(np.concatenate(calls)),
                          np.arange(n_groups * gb))
    # the same blocks through a pool's verb land on its device copy
    from repro_torch.core import layout as LA
    empty = LA.empty_store(store.spec)
    pool = LocalPool(empty, device="cpu", owned_groups=[])
    empty.graph_buf[:] = store.graph_buf
    empty.vec_buf[:] = store.vec_buf
    for ids in calls:
        pool.refresh_blocks(ids)
    assert pool.staging["blocks_staged"] == store.spec.n_blocks
    rows = pool._staged_ids
    assert np.array_equal(pool._g_dev.numpy(), store.graph_buf[rows])
    assert np.array_equal(pool._v_dev.numpy(), store.vec_buf[rows])


def test_chunked_source_covers_everything():
    data = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    chunks = list(chunked_source(data, 10))
    assert [len(c) for c in chunks] == [10, 10, 3]
    assert np.array_equal(np.concatenate(chunks), data)


def test_engine_build_streaming_bit_identical(sift_small):
    """``DHNSWEngine.build_streaming`` searches bit-identically to
    ``build``, reports bounded builder memory, and inserts through the
    disk-backed view; on the CPU both take the plain stage 1."""
    data = sift_small.data[:1500]
    queries = sift_small.queries[:16]
    common = dict(mode="full", search_mode="scan", n_rep=16, b=3, ef=32,
                  cache_frac=4.0, seed=3, quant="int8", quant_kernel="auto")
    mem = DHNSWEngine(EngineConfig(**common), device="cpu").build(data)
    stream = DHNSWEngine(EngineConfig(**common),
                         device="cpu").build_streaming(
        chunked_source(data, 200), chunk_rows=200)
    for a in ("graph_buf", "vec_buf", "meta_table", "qvec_buf",
              "qscale_buf"):
        assert np.array_equal(getattr(mem.store, a),
                              getattr(stream.store, a)), a
    d0, g0, st0 = mem.search(queries, k=10)
    d1, g1, st1 = stream.search(queries, k=10)
    assert np.array_equal(d0, d1) and np.array_equal(g0, g1)
    assert st0["stage1_impl"] == st1["stage1_impl"] == "ref"
    rep = stream.last_load_report
    assert rep.peak_builder_bytes < rep.dataset_bytes / 2
    new = queries[:2] + 0.001
    assert np.array_equal(mem.insert(new), stream.insert(new))
    da, ga, _ = mem.search(queries[:8], k=10)
    db, gb, _ = stream.search(queries[:8], k=10)
    assert np.array_equal(da, db) and np.array_equal(ga, gb)


# ----------------------------------------------------------- compaction

def _overflow_pool(data, ov_cap=8):
    store = _tiny_store(data, ov_cap=ov_cap)
    return LocalPool(store, device="cpu"), store


def test_mutation_hooks_fire_on_append_and_repack(sift_small):
    data = sift_small.data[:600]
    pool, store = _overflow_pool(data)
    events = []
    pool.register_mutation_hook(lambda verb, **kw: events.append((verb, kw)))
    assert pool.append(data[0] + 0.5, 90_000, 1, ledger=None) >= 0
    assert events and events[-1][0] == "append"
    assert events[-1][1]["group"] == 0 and events[-1][1]["pid"] == 1
    pool.repack(0, lambda gids: np.stack(
        [data[g] if g < len(data) else data[0] + 0.5 for g in gids]))
    assert events[-1][0] == "repack" and events[-1][1]["group"] == 0
    assert [v for v, _ in events] == ["append", "repack"]


def test_compactor_repacks_dirty_groups_under_budget(sift_small):
    """Appends past the threshold mark groups dirty via the mutation
    hook; a tick repacks worst-first under the rate budget and the
    overflow ratio drops back to zero."""
    data = sift_small.data[:600]
    pool, store = _overflow_pool(data, ov_cap=8)
    extra = {}

    def lookup(gids):
        return np.stack([data[g] if g < len(data) else extra[g]
                         for g in (int(x) for x in gids)])

    comp = Compactor(pool, lookup,
                     CompactionPolicy(threshold=0.25,
                                      max_repacks_per_tick=1))
    assert comp.tick() == 0
    gid = 90_000
    for pid in (1, 1, 1, 3, 3, 3):
        vec = data[pid] + 0.01 * (gid - 90_000 + 1)
        extra[gid] = vec
        assert pool.append(vec, gid, pid, ledger=None) >= 0
        gid += 1
    ratios = comp.overflow_ratios()
    assert ratios[0] > 0.25 and ratios[1] > 0.25
    assert comp.dirty == {0, 1}
    assert comp.tick() == 1 and comp.skipped_budget >= 1
    assert comp.tick() == 1
    after = comp.overflow_ratios()
    assert after[0] == 0.0 and after[1] == 0.0
    assert comp.dirty == set()
    assert pool.verbs["repack"] >= 2
    st = comp.stats()
    assert st["groups_compacted"] == 2 and st["ticks"] == 3
    mt = pool.read_meta().numpy()
    assert mt[1][MT_OV_A] == 0 and mt[1][MT_OV_B] == 0
    assert int(store.n_base[1]) > 0


def test_compactor_thread_start_stop(sift_small):
    data = sift_small.data[:600]
    pool, _ = _overflow_pool(data)
    comp = Compactor(pool, lambda gids: data[np.asarray(gids, np.int64)],
                     CompactionPolicy(interval_s=0.01))
    comp.start()
    assert comp.start() is comp
    import time
    time.sleep(0.05)
    comp.stop()
    comp.stop()
    assert comp.ticks >= 1


def test_ingest_metrics_render(sift_small):
    from repro_torch.obs.metrics import render_ingest, render_pool_server
    ld = BulkLoader(n_rep=6, chunk_rows=100, seed=0, meta_levels=2)
    ld.add_chunks(chunked_source(sift_small.data[:300], 100))
    _, _, rep = ld.finalize()
    ld.close()
    txt = render_ingest(dataclasses.asdict(rep),
                        compactor={"ticks": 3, "groups_compacted": 1})
    assert 'repro_ingest_load{what="rows"} 300' in txt
    assert 'repro_ingest_load{what="peak_builder_bytes"}' in txt
    assert 'repro_ingest_compactor_total{what="ticks"} 3' in txt
    txt = render_pool_server({"verbs": {"append": 2}, "service_s": {},
                              "ingest": {"applied": 5, "wal_records": 5}})
    assert 'repro_poolserver_ingest_total{what="applied"} 5' in txt


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("quant_group", [0, 32])
def test_bulk_loader_matches_reference(sift_small, quant_group):
    """The port's loader and the reference's, fed the same seeded chunks
    (one of them bad, then retried), give the same meta, region, int8
    mirror and report, and ``render_ingest`` renders the same text."""
    pytest.importorskip("jax")
    from repro.core.hnsw import HNSWParams as RParams
    from repro.ingest import BulkLoader as RLoader
    from repro.obs.metrics import render_ingest as r_render

    from repro_torch.obs.metrics import render_ingest
    data = sift_small.data[:900].copy()
    bad = data[:40].copy()
    bad[5, 7] = np.inf
    chunks = [data[:300], bad, data[300:600], data[600:900]]
    out = []
    for Loader, Params in ((BulkLoader, HNSWParams), (RLoader, RParams)):
        ld = Loader(n_rep=10, chunk_rows=300, seed=5, meta_levels=2,
                    sub_params=Params(M=4, M0=8, ef_construction=40),
                    quant_group=quant_group)
        ld.add_chunks(iter(chunks))
        ld.retry_failed(fix=lambda c: np.nan_to_num(
            np.asarray(c, np.float32), posinf=0.0))
        meta, store, rep = ld.finalize()
        ld.close()
        out.append((meta, store, dataclasses.asdict(rep)))
    (tm, ts, tr), (rm, rs, rr) = out
    for a in ("reps", "rep_ids", "assignments"):
        assert np.array_equal(getattr(tm, a), getattr(rm, a)), a
    for a in ("vectors", "adjacency", "node_level"):
        assert getattr(tm.graph, a).tobytes() == getattr(rm.graph, a).tobytes()
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(rs.spec)
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base", "qvec_buf",
              "qscale_buf"):
        x, y = getattr(ts, a), getattr(rs, a)
        assert (x is None) == (y is None) == (a.startswith("q")
                                              and not quant_group)
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), a
    # each loader spills to a directory of its own
    assert tr.pop("spill_path") != rr.pop("spill_path")
    assert tr == rr and tr["chunks_retried"] == 1
    assert render_ingest(tr, {"ticks": 2}) == r_render(rr, {"ticks": 2})


def test_torch_ingest_smoke_reproduces_the_baseline(tmp_path):
    """``benchmarks/torch_ingest.py --smoke`` gives the counted row of
    ``BENCH_ingest.json``'s ``load_rows``."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import torch_ingest
    finally:
        sys.path.remove(str(ROOT))
    out = tmp_path / "BENCH_torch_ingest.json"
    blob = torch_ingest.run(smoke=True, out=str(out))
    assert json.loads(out.read_text()) == blob
    base = json.loads((ROOT / "benchmarks/baselines/BENCH_ingest.json")
                      .read_text())["load_rows"]
    counted = ("rows", "dim", "chunk_rows", "chunks", "chunks_failed",
               "bit_identical", "chunk_mb", "dataset_mb", "peak_builder_mb",
               "verbs_issued", "groups_shipped")
    assert len(blob["load_rows"]) == len(base) == 1
    got, want = blob["load_rows"][0], base[0]
    assert {k: got[k] for k in counted} == {k: want[k] for k in counted}
    assert (got["rows"], got["chunks"], got["chunks_failed"],
            got["verbs_issued"], got["groups_shipped"]) == (1600, 8, 0, 6, 6)
    assert got["bit_identical"] is True
