"""The port's ingestion and durability (``repro_torch.ingest``) on the
CPU: twins of ``tests/test_ingest.py`` — WAL framing and torn tails,
checkpoints, the ``Durability`` cadence, crash recovery of a killed
``PoolServer`` from its WAL (and from a checkpoint plus a tail), a killed
shard rejoining mid-ingest, the loader, ``build_streaming``, the mutation
hooks, the compactor and its metrics — each against the reference's on
the same inputs where the reference has a counterpart (equal WAL and
checkpoint bytes, recovery counters, failover counters, results), the
port's ``BulkLoader`` against the reference's on the same seeded chunks,
and ``benchmarks/torch_ingest.py --smoke`` against the counted
``load_rows`` and ``recovery`` of ``benchmarks/baselines/
BENCH_ingest.json``.
"""
import copy
import dataclasses
import json
import os
import signal
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
                                Compactor, Durability, chunked_source,
                                encode_record, iter_records, load_checkpoint,
                                read_wal, save_checkpoint)
from repro_torch.ingest.wal import _HDR, MAX_BODY  # noqa: E402
from repro_torch.net import wire as W  # noqa: E402
from repro_torch.pool.local import LocalPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(mode="full", search_mode="scan", n_rep=12, b=3, ef=32,
           cache_frac=0.25, seed=3)


def _tiny_store(data, ov_cap=0):
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    return build_store(data, meta, ov_cap=ov_cap,
                       sub_params=HNSWParams(M=4, M0=8, ef_construction=40))


class Overtime(BaseException):
    """A test ran past its time limit (not an ``OSError``: no transport
    may swallow it)."""


@pytest.fixture()
def time_limit():
    """Fails a test that spawns servers after 120 s."""
    def boom(*_):
        raise Overtime("test ran past 120 s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def ref_ingest():
    pytest.importorskip("jax")
    import repro.ingest as RI
    return RI


# ------------------------------------------------------------ WAL framing

def test_wal_record_roundtrip_and_validation(ref_ingest):
    rec = encode_record(7, 0x1234, b"payload bytes")
    assert rec == ref_ingest.encode_record(7, 0x1234, b"payload bytes")
    [out] = list(iter_records(rec))
    assert (out.op, out.flags, out.payload) == (7, 0x1234, b"payload bytes")
    [out] = list(iter_records(encode_record(1, 0, b"")))
    assert out.payload == b""
    for args in ((256, 0, b""), (-1, 0, b""), (0, 0x1_0000, b"")):
        with pytest.raises(ValueError):
            encode_record(*args)
        with pytest.raises(ValueError):
            ref_ingest.encode_record(*args)


def test_wal_torn_tail_variants_stop_cleanly(ref_ingest):
    """Every way a crash can tear the tail reads as a clean end-of-log,
    record for record as the reference reads it."""
    good = encode_record(2, 0, b"aaaa") + encode_record(3, 1, b"bb")
    torn = [good + b"\x05", good + _HDR.pack(100, 0),
            good + _HDR.pack(MAX_BODY + 1, 0) + b"x" * 64,
            good + encode_record(4, 0, b"cc")[:-1]]
    bad = bytearray(good + encode_record(4, 0, b"cc"))
    bad[-1] ^= 0xFF
    torn.append(bytes(bad))
    for buf in torn:
        recs = [(r.op, r.payload) for r in iter_records(buf)]
        assert recs == [(2, b"aaaa"), (3, b"bb")]
        assert recs == [(r.op, r.payload)
                        for r in ref_ingest.iter_records(buf)]


def test_read_wal_reports_torn_bytes(tmp_path, ref_ingest):
    p = str(tmp_path / "w.log")
    full = encode_record(9, 0, b"x" * 10)
    with open(p, "wb") as f:
        f.write(full + full[: len(full) // 2])
    recs, torn = read_wal(p)
    assert len(recs) == 1 and torn == len(full) // 2
    rrecs, rtorn = ref_ingest.read_wal(p)
    assert [(r.op, r.flags, r.payload) for r in rrecs] == [
        (r.op, r.flags, r.payload) for r in recs] and rtorn == torn
    assert read_wal(str(tmp_path / "absent.log")) == ([], 0)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # bare containers
    given = None

if given is not None:
    @given(ops=st.lists(st.tuples(st.integers(0, 255),
                                  st.integers(0, 0xFFFF),
                                  st.binary(max_size=200)), max_size=20),
           cut=st.integers(0, 50))
    @settings(max_examples=60, deadline=None)
    def test_wal_roundtrip_property(ops, cut):
        """Any record sequence round-trips to the reference's bytes;
        truncating the log anywhere yields a committed prefix."""
        pytest.importorskip("jax")
        from repro.ingest import encode_record as ref_encode
        buf = b"".join(encode_record(o, f, p) for o, f, p in ops)
        assert buf == b"".join(ref_encode(o, f, p) for o, f, p in ops)
        assert [(r.op, r.flags, r.payload) for r in iter_records(buf)] == ops
        cropped = [(r.op, r.flags, r.payload)
                   for r in iter_records(buf[:max(0, len(buf) - cut)])]
        assert cropped == ops[:len(cropped)]


# ----------------------------------------------------------- checkpoints

def _ref_tiny_store(data, ov_cap=0):
    from repro.core import build_meta as rmeta
    from repro.core import build_store as rstore
    from repro.core.hnsw import HNSWParams as RP
    meta = rmeta(data, 8, seed=0, meta_levels=2)
    return rstore(data, meta, ov_cap=ov_cap,
                  sub_params=RP(M=4, M0=8, ef_construction=40))


def test_checkpoint_roundtrip_and_corruption(tmp_path, sift_small,
                                             ref_ingest):
    """The port's checkpoint file is the reference's, byte for byte; it
    loads back exactly, corruption surfaces as IOError, and a fresh
    directory has none."""
    data = sift_small.data[:600]
    store = _tiny_store(data, ov_cap=4)
    d, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(d)
    os.makedirs(rd)
    n = save_checkpoint(d, store, applied=17)
    assert n == ref_ingest.save_checkpoint(rd, _ref_tiny_store(data, 4),
                                           applied=17) > 0
    p = os.path.join(d, "checkpoint.bin")
    assert open(p, "rb").read() == open(os.path.join(rd, "checkpoint.bin"),
                                        "rb").read()
    assert not os.path.exists(p + ".tmp")
    back, applied = load_checkpoint(d)
    assert applied == 17 and back.spec == store.spec
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        assert np.array_equal(getattr(back, a), getattr(store, a)), a
    blob = bytearray(open(p, "rb").read())
    blob[-1] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        load_checkpoint(d)
    assert load_checkpoint(str(tmp_path / "fresh")) is None


def test_durability_cadence_rotation_and_recovery(tmp_path, sift_small,
                                                  ref_ingest):
    """Log -> cadence checkpoint -> WAL rotation -> recover replays exactly
    the un-checkpointed tail once; replay never re-logs; the stats and the
    directory's files equal the reference's after the same calls."""
    data = sift_small.data[:600]
    store = _tiny_store(data)
    d, rd = str(tmp_path / "srv"), str(tmp_path / "ref")
    dur = Durability(d, checkpoint_every=4)
    rdur = ref_ingest.Durability(rd, checkpoint_every=4)
    assert dur.recover() == (None, []) == rdur.recover()
    for i in range(6):
        dur.log(W.OP_APPEND, 0, b"m%d" % i)
        rdur.log(W.OP_APPEND, 0, b"m%d" % i)
        fired = dur.maybe_checkpoint(store)
        assert fired == (i == 3)
        assert rdur.maybe_checkpoint(store) == fired
    st = dur.stats()
    assert st["applied"] == 6 and st["checkpoints"] == 1
    assert st["wal_records"] == 2
    rst = rdur.stats()
    for key in ("applied", "checkpoints", "wal_records", "wal_bytes",
                "checkpoint_bytes"):
        assert st[key] == rst[key], key
    assert sorted(os.listdir(d)) == sorted(os.listdir(rd))
    assert os.path.exists(os.path.join(d, "wal.000000000004.log"))
    assert not os.path.exists(os.path.join(d, "wal.000000000000.log"))
    dur.close()
    rdur.close()
    dur2 = Durability(d, checkpoint_every=4)
    store2, tail = dur2.recover()
    assert store2 is not None and np.array_equal(store2.vec_buf,
                                                 store.vec_buf)
    assert [(r.op, r.payload) for r in tail] == [(W.OP_APPEND, b"m4"),
                                                 (W.OP_APPEND, b"m5")]
    assert dur2.applied == 6 and dur2.stats()["recovered"]
    with dur2.replay_guard():
        dur2.log(W.OP_APPEND, 0, b"replayed")
    assert dur2.stats()["wal_records"] == 0
    dur2.checkpoint_every = 0
    assert not dur2.maybe_checkpoint(store)
    dur2.close()


# -------------------------------------------------------- crash recovery

def _recover(spawn, remote, make_store, local_pool, data, ddir, *,
             checkpoint_every=0, n=6, pid=1, row=0, gid0=50_000,
             torn=b""):
    """Append ``n`` rows through a durable server and an uninterrupted
    LocalPool twin, SIGKILL the server, optionally tear the WAL tail,
    restart on the same directory and re-attach with ``attach="auto"``.
    Returns (the recovered pool, the twin, the server's ingest stats
    before the kill and after the recovery)."""
    ctl = local_pool(make_store())
    with spawn(1, data_dirs=[ddir], with_procs=True,
               checkpoint_every=checkpoint_every) as (eps, procs):
        rp = remote(make_store(), eps[0])
        for i in range(n):
            v = data[row] + 0.01 * (i + 1)
            assert ctl.append(v, gid0 + i, pid, ledger=None) \
                == rp.append(v, gid0 + i, pid, ledger=None) >= 0
        pre = rp.server_stats()["ingest"]
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=10)
    if torn:
        [wal] = [f for f in os.listdir(ddir) if f.startswith("wal.")]
        with open(os.path.join(ddir, wal), "ab") as f:
            f.write(torn)
    spawned = spawn(1, data_dirs=[ddir])
    eps2 = spawned.__enter__()
    pool = remote(ctl.store, eps2[0], attach="auto")
    return pool, ctl, pre, pool.server_stats()["ingest"], spawned


def _both_recover(tmp_path, data, **kw):
    """``_recover`` through the port (device ``cpu``) and the reference."""
    pytest.importorskip("jax")
    from repro.net import RemotePool as RRemote
    from repro.net import spawn_pool_servers as rspawn
    from repro.pool import LocalPool as RLocal

    from repro_torch.net import RemotePool, spawn_pool_servers
    out = {}
    for name, spawn, remote, make, local in (
            ("repro_torch", spawn_pool_servers,
             lambda st, ep, **k: RemotePool(st, ep, device="cpu", **k),
             lambda: _tiny_store(data, ov_cap=8),
             lambda st: LocalPool(st, device="cpu")),
            ("repro", rspawn, RRemote, lambda: _ref_tiny_store(data, 8),
             RLocal)):
        out[name] = _recover(spawn, remote, make, local, data,
                             str(tmp_path / name), **kw)
    return out


def _close(runs):
    for run in runs.values():
        run[-1].__exit__(None, None, None)


def test_poolserver_kill9_recovers_from_wal(tmp_path, sift_small,
                                            time_limit):
    """kill -9 a durable server mid-ingest, restart it on the same
    directory: the ``attach="auto"`` fingerprint handshake finds the
    recovered region (no re-upload), WAL replay counts every record, a
    torn garbage tail is skipped, and span reads and the server's meta
    equal the uninterrupted twin's; the ingest counters equal the
    reference's."""
    data = sift_small.data[:600]
    runs = _both_recover(tmp_path, data, torn=b"\xde\xad\xbe\xef\x00")
    try:
        pool, ctl, pre, ing, _ = runs["repro_torch"]
        assert pool.attached_via == "recovered"
        assert ing["recovered"] and ing["replayed_records"] >= 1 + 6
        assert ing["torn_bytes"] == 5
        for x, y in zip(ctl.read_spans(np.arange(4), ledger=None),
                        pool.read_spans(np.arange(4), ledger=None)):
            assert torch.equal(x, y)
        server_meta, n_base = pool.server_meta()
        assert np.array_equal(server_meta, ctl.store.meta_table)
        assert np.array_equal(n_base, ctl.store.n_base)
        rpool, _, rpre, ring, _ = runs["repro"]
        assert rpool.attached_via == "recovered"
        for key in ("wal_records", "wal_bytes", "applied"):
            assert pre[key] == rpre[key], key
        for key in ("replayed_records", "torn_bytes", "checkpoint_bytes",
                    "applied", "recovered"):
            assert ing[key] == ring[key], key
    finally:
        _close(runs)


def test_poolserver_checkpoint_plus_tail_recovery(tmp_path, sift_small,
                                                  time_limit):
    """With a checkpoint every 4 mutations the restart recovers snapshot +
    a short tail (attach + 5 appends: one checkpoint, a 2-record tail),
    as the reference's does."""
    data = sift_small.data[:600]
    runs = _both_recover(tmp_path, data, checkpoint_every=4, n=5, pid=3,
                         row=1, gid0=60_000)
    try:
        pool, ctl, pre, ing, _ = runs["repro_torch"]
        assert os.path.exists(tmp_path / "repro_torch" / "checkpoint.bin")
        assert pool.attached_via == "recovered" and ing["recovered"]
        assert 0 < ing["replayed_records"] < 1 + 5
        for x, y in zip(ctl.read_spans(np.arange(4), ledger=None),
                        pool.read_spans(np.arange(4), ledger=None)):
            assert torch.equal(x, y)
        _, _, rpre, ring, _ = runs["repro"]
        assert pre == rpre
        for key in ("replayed_records", "checkpoint_bytes", "applied"):
            assert ing[key] == ring[key], key
    finally:
        _close(runs)


def test_engine_kill9_mid_ingest_recovered_shard_rejoins(tmp_path,
                                                         sift_small,
                                                         time_limit):
    """An engine over two durable replicated servers; kill -9 one
    mid-ingest: searches stay bit-identical to LocalPool with no lost
    group; the restarted server recovers from its WAL and
    ``recover_shard`` rejoins it through the fingerprint handshake, after
    which inserts and searches still match.  The failover counters equal
    the reference engine's under the same kill."""
    pytest.importorskip("jax")
    from repro.core import DHNSWEngine as RE
    from repro.core import EngineConfig as RC
    from repro.net import RemotePool as RRemote
    from repro.net import spawn_pool_servers as rspawn

    from repro_torch import convert
    from repro_torch.net import RemotePool, spawn_pool_servers
    data = sift_small.data[:1200]
    queries = sift_small.queries[:16]
    ref_built = RE(RC(**CFG)).build(data)
    base = DHNSWEngine(EngineConfig(**CFG), device="cpu")
    base.client.adopt_built(*convert.state_from_numpy(
        *convert.numpy_state(ref_built.meta, ref_built.store)), data)
    res = {}
    for name in ("repro_torch", "repro"):
        d0, d1 = (str(tmp_path / f"{name}{i}") for i in (0, 1))
        spawn = spawn_pool_servers if name == "repro_torch" else rspawn
        with spawn(2, data_dirs=[d0, d1], with_procs=True) as (eps, procs):
            kw = dict(CFG, pool="remote", endpoints=tuple(eps),
                      replication=2)
            if name == "repro_torch":
                eng = DHNSWEngine(EngineConfig(**kw), device="cpu")
                eng.client.adopt_built(*convert.state_from_numpy(
                    *convert.numpy_state(ref_built.meta, ref_built.store)),
                    data)
                remote = lambda st, ep: RemotePool(  # noqa: E731
                    st, ep, device="cpu", attach="auto")
            else:
                eng = RE(RC(**kw))
                eng.client.adopt_built(copy.deepcopy(ref_built.meta),
                                       copy.deepcopy(ref_built.store), data)
                remote = lambda st, ep: RRemote(  # noqa: E731
                    st, ep, attach="auto")
            out = {"gids1": eng.insert(queries[:3] + 0.001),
                   "s1": eng.search(queries, k=10)}
            os.kill(procs[0].pid, signal.SIGKILL)
            procs[0].wait(timeout=10)
            out["s2"] = eng.search(queries, k=10)
            with spawn(1, data_dirs=[d0]) as eps2:
                eng.pool.recover_shard(
                    0, lambda store, ep=eps2[0]: remote(store, ep))
                child = eng.pool.children[0]
                out["via"] = child.attached_via
                out["ingest"] = child.server_stats()["ingest"]
                out["snap"] = eng.pool.snapshot()
                out["gids2"] = eng.insert(queries[3:6] + 0.002)
                out["s3"] = eng.search(queries[:8], k=10)
        res[name] = out
    t, r = res["repro_torch"], res["repro"]
    assert np.array_equal(base.insert(queries[:3] + 0.001), t["gids1"])
    want = base.search(queries, k=10)
    for key in ("s1", "s2"):
        assert np.array_equal(t[key][0], want[0])
        assert np.array_equal(t[key][1], want[1])
    assert t["s2"][2]["pool"]["failover"]["deaths"] == 1
    assert t["via"] == "recovered"
    assert t["ingest"]["recovered"] and t["ingest"]["replayed_records"] > 0
    fo = t["snap"]["failover"]
    assert fo["recovered_shards"] == 1 and fo["recovered_groups"] > 0
    assert fo["lost_groups"] == 0 and t["snap"]["alive"] == [True, True]
    assert np.array_equal(base.insert(queries[3:6] + 0.002), t["gids2"])
    want = base.search(queries[:8], k=10)
    assert np.array_equal(t["s3"][0], want[0])
    assert np.array_equal(t["s3"][1], want[1])
    assert fo == r["snap"]["failover"] and r["via"] == "recovered"
    assert t["ingest"]["replayed_records"] == r["ingest"][
        "replayed_records"]
    for key in ("gids1", "gids2"):
        assert np.array_equal(t[key], r[key])
    for key in ("s1", "s2", "s3"):
        assert np.array_equal(t[key][1], r[key][1])
        np.testing.assert_allclose(t[key][0], r[key][0], rtol=1e-5,
                                   atol=1e-4)
        assert t[key][2]["net"] == r[key][2]["net"]


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


def test_torch_ingest_smoke_reproduces_the_baseline(tmp_path, time_limit):
    """``benchmarks/torch_ingest.py --smoke`` on the CPU gives the counted
    row of ``BENCH_ingest.json``'s ``load_rows`` and every field of its
    ``recovery`` row but the wall clock."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import torch_ingest
    finally:
        sys.path.remove(str(ROOT))
    out = tmp_path / "BENCH_torch_ingest.json"
    blob = torch_ingest.run(smoke=True, out=str(out), device="cpu")
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
    want = json.loads((ROOT / "benchmarks/baselines/BENCH_ingest.json")
                      .read_text())["recovery"]
    got = blob["recovery"]
    assert set(got) == set(want)
    assert {k: got[k] for k in want if k != "recover_wall_s"} == {
        k: want[k] for k in want if k != "recover_wall_s"}
