"""The port's remote transport on the CPU: twins of ``tests/test_net.py``
and the wire between the two packages.

``repro_torch.net.wire`` and ``server.py`` are copies of the reference's
(``tests/test_torch_serve.py`` holds their text to the originals); the
port's ``RemotePool`` decodes responses on the host and uploads them to
its device.  Against the port's ``LocalPool`` a remote engine must give
bit-identical gids and distances and an equal counted ``net``; against the
JAX package's ``RemotePool`` on the same index, equal gids, distances
within rtol 1e-5 / atol 1e-4 (the two sides sum squares in a different
order), an equal ``net`` and equal measured wire payload bytes per verb.
The frames are the same bytes both ways: a port client against a
reference server and a reference client against a port server serve the
same results with the same wire counts.

Each module-scoped fixture spawns its servers once and every engine
re-ATTACHes (one region per server at a time); every test runs under a
time limit of its own, so one stuck socket cannot eat the suite's clock.
Last, ``chip_smoke.py``'s phase 14 runs here at a tiny size.
"""
import copy
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-4
CFG = dict(mode="full", search_mode="scan", n_rep=12, b=3, ef=32,
           cache_frac=0.25, seed=3)
LIMIT_S = 120


class Overtime(BaseException):
    """A test ran past ``LIMIT_S`` (not an ``OSError``: no transport may
    swallow it)."""


@pytest.fixture(autouse=True)
def time_limit():
    def boom(*_):
        raise Overtime(f"test ran past {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _pkg(name: str) -> types.SimpleNamespace:
    core = importlib.import_module(f"{name}.core.engine")
    cm = importlib.import_module(f"{name}.core.cost_model")
    pool = importlib.import_module(f"{name}.pool")
    net = importlib.import_module(f"{name}.net")
    P = types.SimpleNamespace(
        name=name, DHNSWEngine=core.DHNSWEngine,
        EngineConfig=core.EngineConfig, RDMA_100G=cm.RDMA_100G,
        Fabric=cm.Fabric, NetLedger=cm.NetLedger, LocalPool=pool.LocalPool,
        ShardedPool=pool.ShardedPool,
        Freq=importlib.import_module(
            f"{name}.pool.placement").FrequencyAwarePlacement,
        RemotePool=net.RemotePool, spawn=net.spawn_pool_servers,
        W=net.wire, PoolUnavailableError=net.PoolUnavailableError,
        dev={} if name == "repro" else {"device": "cpu"})
    if name == "repro":
        P.state = lambda m, s: (copy.deepcopy(m), copy.deepcopy(s))
    else:
        P.state = lambda m, s: convert.state_from_numpy(
            *convert.numpy_state(m, s))
    return P


@pytest.fixture(scope="module")
def pkgs():
    pytest.importorskip("jax")
    return _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(scope="module")
def servers(pkgs):
    """Two servers of each package: name -> endpoints."""
    R, T = pkgs
    with R.spawn(2) as reps, T.spawn(2) as teps:
        yield {"repro": reps, "repro_torch": teps}


@pytest.fixture(scope="module")
def pds(sift_small):
    return sift_small.data[:1200], sift_small.queries[:24]


@pytest.fixture(scope="module")
def built(pkgs, pds):
    """One index over ``pds`` built by the JAX package at ``CFG``."""
    R, _ = pkgs
    return R.DHNSWEngine(R.EngineConfig(**CFG)).build(pds[0])


@pytest.fixture(scope="module")
def tiny(pkgs, pds):
    """``tests/test_net.py``'s tiny store (and an ``ov_cap=8`` twin),
    built once by the JAX package."""
    from repro.core.hnsw import HNSWParams
    from repro.core.layout import build_store
    from repro.core.meta import build_meta
    data, _ = pds
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    p = HNSWParams(M=4, M0=8, ef_construction=40)
    return {ov: (meta, build_store(data, meta, ov_cap=ov, sub_params=p))
            for ov in (0, 8)}


def _store(P, tiny, ov_cap=0):
    """A fresh copy of the tiny store in ``P``'s package."""
    return P.state(*tiny[ov_cap])[1]


def _engine(P, built, data, pool: str, **over):
    eng = P.DHNSWEngine(P.EngineConfig(**{**CFG, "fabric": P.RDMA_100G,
                                          **over, "pool": pool}), **P.dev)
    eng.client.adopt_built(*P.state(built.meta, built.store), data)
    return eng


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bit_equal(a, b) -> None:
    """Two search results (d, g, ...) are bit-identical."""
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _same(ref_out, port_out) -> None:
    """The port's search result against the reference's."""
    (dr, gr, sr), (dt, gt, st) = ref_out, port_out
    assert np.array_equal(gt, gr)
    np.testing.assert_allclose(dt, dr, rtol=RTOL, atol=ATOL)
    assert st["net"] == sr["net"]


def _wire_counts(pool) -> dict:
    """The measured wire tallies of a remote pool, its clock left out."""
    return {k: v for k, v in pool.wire.items() if k != "wire_s"}


# ------------------------------------------------------------ wire format

def test_frame_header_roundtrip(pkgs):
    """The copied framing packs the reference's bytes and rejects what
    the reference rejects."""
    R, T = pkgs
    W = T.W
    buf = W.pack_frame(W.OP_READ_SPANS, b"abc", flags=W.FLAG_QUANT, seq=7)
    assert buf == R.W.pack_frame(R.W.OP_READ_SPANS, b"abc",
                                 flags=R.W.FLAG_QUANT, seq=7)
    assert W.unpack_header(buf[:W.HEADER_BYTES]) == (
        W.OP_READ_SPANS, W.FLAG_QUANT, 7, 3)
    assert buf[W.HEADER_BYTES:] == b"abc"
    assert W.unpack_header(W.pack_frame(W.OP_PING, b"", seq=0))[3] == 0
    for bad in (b"XXXX" + bytes(W.HEADER_BYTES - 4), b"short"):
        with pytest.raises(W.WireError):
            W.unpack_header(bad)


def test_wire_attach_and_span_frames_roundtrip(pkgs, tiny):
    """The port's region encodes to the reference's ATTACH bytes and
    decodes back; span responses, from the empty batch to every
    partition, are the same bytes and decode to what was gathered."""
    R, T = pkgs
    rs, ts = _store(R, tiny), _store(T, tiny)
    payload, flags = T.W.enc_attach(ts)
    assert (payload, flags) == R.W.enc_attach(rs)
    back = T.W.dec_attach(payload, flags)
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        assert np.array_equal(getattr(back, a), getattr(ts, a)), a
    assert back.spec == ts.spec
    spec = ts.spec
    for pids in (np.zeros(0, np.int64), np.arange(spec.n_partitions)):
        assert T.W.enc_pids(pids) == R.W.enc_pids(pids)
        m = len(pids)
        ids = (np.stack([ts.span_block_ids(int(p)) for p in pids])
               if m else np.zeros((0, spec.fetch_blocks), np.int64))
        g = ts.graph_buf[ids.reshape(-1)].reshape(m, spec.fetch_blocks,
                                                  spec.gblk)
        v = ts.vec_buf[ids.reshape(-1)].reshape(m, spec.fetch_blocks,
                                                spec.vblk)
        payload = T.W.enc_spans_resp(spec, quant=False, g=g, v=v)
        assert payload == R.W.enc_spans_resp(rs.spec, quant=False, g=g, v=v)
        assert len(payload) == m * spec.partition_bytes()
        g2, v2 = T.W.dec_spans_resp(spec, payload, m=m, quant=False)
        assert np.array_equal(g, g2) and np.array_equal(v, v2)


def test_wire_quant_frames_roundtrip(pkgs, tiny):
    """int8 payloads in both span layouts and the quant-row response:
    the reference's bytes, decoded back exactly."""
    R, T = pkgs
    import repro.core.layout as RL

    import repro_torch.core.layout as TL
    rs, ts = _store(R, tiny), _store(T, tiny)
    RL.attach_quant_mirror(rs, 32)
    TL.attach_quant_mirror(ts, 32)
    assert ts.qvec_buf.tobytes() == rs.qvec_buf.tobytes()
    spec, W = ts.spec, T.W
    pids = np.array([0, 3, 6])
    m = len(pids)
    ids = np.stack([ts.span_block_ids(int(p)) for p in pids]).reshape(-1)
    qv = ts.qvec_buf[ids].reshape(m, spec.fetch_blocks, -1)
    qs = ts.qscale_buf[ids].reshape(m, spec.fetch_blocks, -1)
    g = ts.graph_buf[ids].reshape(m, spec.fetch_blocks, -1)
    sides = W.span_sides(ts.meta_table, pids)
    payload = W.enc_spans_resp(spec, quant=True, graph=True, qv=qv, qs=qs,
                               g=g)
    assert payload == R.W.enc_spans_resp(rs.spec, quant=True, graph=True,
                                          qv=qv, qs=qs, g=g)
    assert len(payload) == m * spec.quant_partition_bytes(
        include_graph=True)
    for x, y in zip((qv, qs, g), W.dec_spans_resp(spec, payload, m=m,
                                                  quant=True, graph=True)):
        assert np.array_equal(x, y)
    tails = W.extract_gid_tails(spec, g, sides)
    payload = W.enc_spans_resp(spec, quant=True, graph=False, qv=qv, qs=qs,
                               tails=tails)
    assert len(payload) == m * spec.quant_partition_bytes(
        include_graph=False)
    t2 = W.dec_spans_resp(spec, payload, m=m, quant=True, graph=False)[2]
    rebuilt = W.rebuild_quant_gspans(spec, t2, sides)
    assert np.array_equal(W.extract_gid_tails(spec, rebuilt, sides), tails)
    assert np.array_equal(rebuilt, R.W.rebuild_quant_gspans(
        rs.spec, t2, R.W.span_sides(rs.meta_table, pids)))
    rows = np.array([0, 5, 130], np.int64)
    codes = ts.qvec_buf.reshape(-1, spec.dim)[rows]
    scales = ts.qscale_buf.reshape(-1, spec.dim // 32)[rows]
    payload = W.enc_quant_rows_resp(codes, scales)
    c2, s2 = W.dec_quant_rows_resp(payload, len(rows), spec.dim, 32)
    assert np.array_equal(codes, c2) and np.array_equal(scales, s2)


def test_wire_append_and_write_blocks_roundtrip(pkgs, tiny, pds):
    """Append frames (with and without the int8 row), block WRITEs and
    the meta response: the reference's bytes, decoded back exactly."""
    R, T = pkgs
    import repro.core.layout as RL

    import repro_torch.core.layout as TL
    from repro_torch.quant.codec import quantize_groups
    data, _ = pds
    rs, ts = _store(R, tiny), _store(T, tiny)
    spec, W = ts.spec, T.W
    vec = data[0] + 0.25
    payload, flags = W.enc_append(vec, 42, 3)
    assert (payload, flags) == R.W.enc_append(vec, 42, 3)
    v2, gid, pid, codes, scales = W.dec_append(payload, flags, spec.dim, 1)
    assert np.array_equal(np.asarray(vec, np.float32), v2)
    assert (gid, pid, codes, scales) == (42, 3, None, None)
    assert len(payload) == spec.dim * 4 + 8 + 8
    RL.attach_quant_mirror(rs, 32)
    TL.attach_quant_mirror(ts, 32)
    codes, scales = quantize_groups(np.asarray(vec, np.float32), 32)
    payload, flags = W.enc_append(vec, 42, 3, codes, scales)
    assert (payload, flags) == R.W.enc_append(vec, 42, 3, codes, scales)
    assert flags & W.FLAG_QUANT
    _, _, _, c2, s2 = W.dec_append(payload, flags, spec.dim, 32)
    assert np.array_equal(codes, c2) and np.array_equal(scales, s2)
    ids = np.arange(ts.spec.group_blocks)
    payload, flags = W.enc_write_blocks(ts, ids)
    assert (payload, flags) == R.W.enc_write_blocks(rs, ids)
    upd = W.dec_write_blocks(payload, flags, ts.spec)
    assert np.array_equal(upd["ids"], ids)
    for key, a in (("g", "graph_buf"), ("v", "vec_buf"), ("qv", "qvec_buf")):
        assert np.array_equal(upd[key], getattr(ts, a)[ids]), key
    assert np.array_equal(upd["meta"], ts.meta_table)
    assert W.enc_meta_resp(ts) == R.W.enc_meta_resp(rs)
    meta, n_base = W.dec_meta_resp(W.enc_meta_resp(ts), spec.n_partitions)
    assert np.array_equal(meta, ts.meta_table)
    assert np.array_equal(n_base, ts.n_base)


# ------------------------------------------------------------ conformance

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["naive", "full"])
def test_remote_bit_identical_search_insert(pkgs, servers, built, pds, mode,
                                            quant):
    """A remote engine — one server, and a ShardedPool over two server
    processes — gives the port LocalPool's results bit for bit before and
    after inserts, with an equal ``net`` on one node; the measured span
    bytes equal the model; against the reference's remote engine, results,
    ``net`` and the wire payload of every verb agree."""
    data, queries = pds
    R, T = pkgs
    teps = servers["repro_torch"]
    kw = dict(mode=mode, quant=quant)
    base = _engine(T, built, data, "local", **kw)
    out0 = base.search(queries, k=10)
    new = queries[:3] + 0.001
    gids0 = base.insert(new)
    out1 = base.search(queries[:8], k=10)

    ref = _engine(R, built, data, "remote", endpoints=(servers["repro"][0],),
                  **kw)
    rem = _engine(T, built, data, "remote", endpoints=(teps[0],), **kw)
    r, t = ref.search(queries, k=10), rem.search(queries, k=10)
    _bit_equal(t, out0)
    assert t[2]["net"] == out0[2]["net"]
    _same(r, t)
    g_ref, g_rem = ref.insert(new), rem.insert(new)
    assert np.array_equal(gids0, g_rem) and np.array_equal(g_ref, g_rem)
    assert rem._last_insert_net == ref._last_insert_net
    r, t = ref.search(queries[:8], k=10), rem.search(queries[:8], k=10)
    _bit_equal(t, out1)
    _same(r, t)
    wvm = rem.pool.wire_vs_model()
    for verb in ("read_spans", "read_spans_quant"):
        if verb in wvm:
            assert wvm[verb]["measured"] == wvm[verb]["modeled"], wvm
    assert wvm == ref.pool.wire_vs_model()
    assert (rem.pool.wire["payload_by_verb"]
            == ref.pool.wire["payload_by_verb"])
    assert rem.pool.wire["frames_by_verb"] == ref.pool.wire["frames_by_verb"]

    sh = _engine(T, built, data, "remote", endpoints=tuple(teps), **kw)
    d, g, st = sh.search(queries, k=10)
    _bit_equal((d, g), out0)
    assert st["pool"]["kind"] == "sharded" and st["pool"]["n_shards"] == 2
    assert all(s["kind"] == "remote" for s in st["pool"]["shards"])
    assert all(c.device == torch.device("cpu") for c in sh.pool.children)
    assert np.array_equal(gids0, sh.insert(new))
    d, g, st = sh.search(queries[:8], k=10)
    _bit_equal((d, g), out1)
    assert st["pool"]["wire_total"]["bytes_rx"] > 0


def test_remote_wire_matches_ledger_accounting(pkgs, servers, tiny):
    """Measured wire bytes == the ledger, verb by verb, as the reference
    counts them: span frames carry the modeled span bytes (trips ==
    frames), a row fetch moves the charged rows, quant spans in both
    layouts, and an empty batch is frameless.  Every tally and every
    ledger equals the reference pool's on the same calls."""
    R, T = pkgs
    pools = {P.name: P.RemotePool(_store(P, tiny), servers[P.name][0],
                                  **P.dev) for P in (R, T)}
    leds = {P.name: P.NetLedger(P.RDMA_100G) for P in (R, T)}
    outs = {}
    for P in (R, T):
        pool, led = pools[P.name], leds[P.name]
        pids = np.array([0, 2, 3, 5, 6])
        outs[P.name] = [pool.read_spans(pids, ledger=led, doorbell=2)]
        assert pool.wire["frames_by_verb"]["read_spans"] == 3
        assert led.round_trips == 3
        wvm = pool.wire_vs_model()["read_spans"]
        assert wvm["measured"] == wvm["modeled"] == led.bytes
        before = led.bytes
        pool.post_row_reads([(0, 2), (2, 3)], ledger=led, doorbell=8)
        rows = np.array([0, 1, 130, 131, 132], np.int64)
        outs[P.name].append((pool.read_rows(rows),))
        assert (pool.wire["payload_by_verb"]["read_rows"]
                == led.bytes - before
                == len(rows) * pool.store.spec.row_bytes())
        pool.attach_quant(32)
        for graph in (True, False):
            lq = P.NetLedger(P.RDMA_100G)
            outs[P.name].append(pool.read_spans(
                pids, ledger=lq, doorbell=4, quant=True, quant_graph=graph))
            spec = pool.store.spec
            assert lq.bytes == len(pids) * spec.quant_partition_bytes(
                include_graph=graph)
        wvm = pool.wire_vs_model()["read_spans_quant"]
        assert wvm["measured"] == wvm["modeled"]
        before = dict(pool.wire["frames_by_verb"])
        g, _ = pool.read_spans(np.zeros(0, np.int64), ledger=led)
        assert g.shape[0] == 0
        assert pool.wire["frames_by_verb"] == before
    t = pools["repro_torch"]
    assert _wire_counts(t) == _wire_counts(pools["repro"])
    assert leds["repro_torch"].as_dict() == leds["repro"].as_dict()
    for ro, to in zip(outs["repro"], outs["repro_torch"]):
        for a, b in zip(ro, to):
            assert isinstance(b, torch.Tensor) and b.device == t.device
            assert b.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(np.float32): torch.float32,
                               np.dtype(np.int8): torch.int8}[
                np.asarray(a).dtype]
            assert np.array_equal(_np(b), np.asarray(a))


def test_remote_append_repack_keep_regions_coherent(pkgs, servers, tiny,
                                                    pds):
    """Writes land on both sides: appends fill the shared overflow until
    repack, and after the client-side repack + block WRITE the server's
    region equals the mirror, the port LocalPool's and the reference
    remote pool's bit for bit."""
    data, _ = pds
    R, T = pkgs
    extra = {}

    def lookup(gids):
        out = np.zeros((len(gids), data.shape[1]), np.float32)
        for i, g in enumerate(int(x) for x in gids):
            out[i] = data[g] if g < len(data) else extra[g]
        return out

    lp = T.LocalPool(_store(T, tiny, 8), device="cpu")
    rp = T.RemotePool(_store(T, tiny, 8), servers["repro_torch"][0],
                      device="cpu")
    jp = R.RemotePool(_store(R, tiny, 8), servers["repro"][0])
    for p in (lp, rp, jp):
        p.attach_quant(32)
    gid = 50_000
    while True:
        vec = data[0] + 0.01 * (gid - 50_000 + 1)
        extra[gid] = vec
        slots = [p.append(vec, gid, 1, ledger=None) for p in (lp, rp, jp)]
        assert slots[0] == slots[1] == slots[2]
        if slots[0] < 0:
            break
        gid += 1
    assert [p.repack(0, lookup) for p in (lp, rp, jp)] == [True] * 3
    for a in ("graph_buf", "vec_buf", "meta_table", "qvec_buf"):
        assert np.array_equal(getattr(lp.store, a), getattr(rp.store, a)), a
        assert np.array_equal(getattr(rp.store, a), getattr(jp.store, a)), a
    assert _wire_counts(rp) == _wire_counts(jp)
    server_meta, _ = rp.server_meta()
    assert np.array_equal(server_meta, rp.store.meta_table)
    for x, y in zip(lp.read_spans(np.arange(4), ledger=None),
                    rp.read_spans(np.arange(4), ledger=None)):
        assert torch.equal(x, y)


def test_remote_migration_restages_destination(pkgs, servers, tiny, pds):
    """Freq placement over two remote children with unequal fabrics
    migrates hot groups; the destination is re-staged over the wire and
    results stay bit-identical to LocalPool, before and after an append.
    Placement, migration tallies and every child's wire equal the
    reference's."""
    R, T = pkgs
    from repro_torch.pool.placement import FrequencyAwarePlacement
    lp = T.LocalPool(_store(T, tiny), device="cpu")
    pools = {}
    for P in (R, T):
        slow = P.Fabric("slow", rtt_s=100e-6, bw_Bps=0.5e9, per_op_s=5e-6,
                        max_doorbell=32)
        pools[P.name] = P.ShardedPool(
            _store(P, tiny),
            [lambda st, ep=ep, f=f, P=P: P.RemotePool(st, ep, fabric=f,
                                                      **P.dev)
             for ep, f in zip(servers[P.name], (P.RDMA_100G, slow))],
            placement=P.Freq(migrate_every=16, max_moves=2), **P.dev)
    sp = pools["repro_torch"]
    assert isinstance(sp.placement, FrequencyAwarePlacement)
    hot = np.array([2 * g for g in range(4) if sp.owner_of_group(g) == 1][:2])
    assert len(hot), "expected some groups on the slow shard"
    for P in (R, T):
        led = P.NetLedger(P.RDMA_100G)
        for _ in range(30):
            pools[P.name].read_spans(hot, ledger=led, doorbell=2)
    snaps = {n: p.snapshot() for n, p in pools.items()}
    snap = snaps["repro_torch"]
    assert snap["migration"]["n"] >= 1, "hot groups should migrate"
    assert any("migrate" in s["wire"]["payload_by_verb"]
               for s in snap["shards"])
    for key in ("migration", "groups_by_shard", "totals", "verbs"):
        assert snap[key] == snaps["repro"][key], key
    for a, b in zip(snap["shards"], snaps["repro"]["shards"]):
        assert ({k: v for k, v in a["wire"].items() if k != "wire_s"}
                == {k: v for k, v in b["wire"].items() if k != "wire_s"})
    for x, y in zip(lp.read_spans(np.arange(8), ledger=None),
                    sp.read_spans(np.arange(8), ledger=None)):
        assert torch.equal(x, y)
    vec = pds[0][5] + 0.5
    assert lp.append(vec, 77_000, int(hot[0]), ledger=None) \
        == sp.append(vec, 77_000, int(hot[0]), ledger=None) >= 0
    for x, y in zip(lp.read_spans(np.arange(8), ledger=None),
                    sp.read_spans(np.arange(8), ledger=None)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("parallel", [True, False])
def test_remote_children_parallel_and_serial_fanout(pkgs, built, pds,
                                                    parallel):
    """Twin of ``tests/test_pool.py``'s summed-ledger test over three
    remote children (loopback regions): pool totals == the sum of every
    ledger the engine charged, children sum to the pool on bytes and
    descriptors, trips reduce by max in parallel mode and sum in serial
    mode; results bit-identical to LocalPool, totals equal the
    reference's."""
    data, queries = pds
    R, T = pkgs
    kw = dict(pool="sharded", shard_transport="remote", bearer="loopback",
              n_shards=3, quant="int8", shard_parallel=parallel)
    local = _engine(T, built, data, "local", quant="int8")
    engs = {P.name: _engine(P, built, data, **kw) for P in (R, T)}
    totals = {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}
    for i in range(3):
        q = queries[i * 8:(i + 1) * 8]
        t = engs["repro_torch"].search(q, k=10)
        _bit_equal(t, local.search(q, k=10))
        _same(engs["repro"].search(q, k=10), t)
        for k in totals:
            totals[k] += t[2]["net"][k]
    new = queries[:2] + 0.001
    for e in engs.values():
        e.insert(new)
    eng = engs["repro_torch"]
    assert eng._last_insert_net == engs["repro"]._last_insert_net
    for k in totals:
        totals[k] += eng._last_insert_net[k]
    snap = eng.pool.snapshot()
    for k in totals:
        assert snap["totals"][k] == pytest.approx(totals[k]), k
    assert snap["totals"] == engs["repro"].pool.snapshot()["totals"]
    child = {k: sum(s["totals"][k] for s in snap["shards"]) for k in totals}
    assert child["bytes"] == pytest.approx(snap["totals"]["bytes"])
    assert child["descriptors"] == pytest.approx(
        snap["totals"]["descriptors"])
    if parallel:
        assert snap["totals"]["round_trips"] <= child["round_trips"]
    else:
        assert snap["totals"]["round_trips"] == pytest.approx(
            child["round_trips"])
    assert snap["verbs"]["append"] == 2


# ---------------------------------------------------------------- failure

def test_remote_verb_error_does_not_poison_connection(pkgs, servers, tiny):
    """A server-side verb error inside a pipelined doorbell batch is a
    RuntimeError for that call only; the connection keeps serving."""
    _, T = pkgs
    lp = T.LocalPool(_store(T, tiny), device="cpu")
    pool = T.RemotePool(_store(T, tiny), servers["repro_torch"][1],
                        device="cpu")
    with pytest.raises(RuntimeError, match="pool server error"):
        pool.read_spans(np.array([0, 999, 1, 2]), ledger=None, doorbell=2)
    for x, y in zip(lp.read_spans(np.arange(4), ledger=None),
                    pool.read_spans(np.arange(4), ledger=None)):
        assert torch.equal(x, y)


def test_remote_server_kill_raises_clean_error(pkgs, tiny):
    """A vanished server is a PoolUnavailableError at the next verb —
    bounded by the socket timeout, never a hang — and connecting to a
    dead endpoint fails the same way."""
    _, T = pkgs
    from repro_torch.net import parse_endpoint
    with T.spawn(1) as eps:
        pool = T.RemotePool(_store(T, tiny), eps[0], device="cpu",
                            timeout_s=5.0)
        pool.read_spans(np.arange(2), ledger=None)
        endpoint = parse_endpoint(eps[0])
    t0 = time.time()
    with pytest.raises(T.PoolUnavailableError):
        pool.read_spans(np.arange(2), ledger=None)
    assert time.time() - t0 < 10.0, "should fail fast, not hang"
    with pytest.raises(T.PoolUnavailableError):
        pool.read_rows(torch.tensor([0, 1]))
    with pytest.raises(T.PoolUnavailableError):
        T.RemotePool(_store(T, tiny), endpoint, device="cpu",
                     connect_timeout_s=2.0)


def test_replicated_remote_survives_kill9_mid_search(pkgs, built, pds):
    """Two servers behind a ``replication=2`` pool; SIGKILL one and keep
    searching: no error surfaces, results stay bit-identical to LocalPool,
    the dead shard's groups re-replicate onto the survivor, inserts land;
    the failover counters equal the reference's under the same kill."""
    data, queries = pds
    R, T = pkgs
    base = _engine(T, built, data, "local")
    out0 = base.search(queries, k=10)
    res = {}
    for P in (R, T):
        with P.spawn(2, with_procs=True) as (eps, procs):
            eng = _engine(P, built, data, "remote", endpoints=tuple(eps),
                          replication=2)
            first = eng.search(queries, k=10)
            procs[0].kill()
            procs[0].wait(timeout=10)
            second = eng.search(queries, k=10)
            fo = dict(second[2]["pool"]["failover"])
            alive = second[2]["pool"]["alive"]
            gids = eng.insert(queries[:2] + 0.001)
            after = eng.search(queries[:8], k=10)
            res[P.name] = (first, second, fo, alive, gids, after)
    first, second, fo, alive, gids, after = res["repro_torch"]
    _bit_equal(first, out0)
    _bit_equal(second, out0)
    assert first[2]["pool"]["replication"] == 2
    assert fo["deaths"] == 1 and fo["read_retries"] >= 1
    assert fo["lost_groups"] == 0 and alive == [False, True]
    assert np.array_equal(gids, base.insert(queries[:2] + 0.001))
    _bit_equal(after, base.search(queries[:8], k=10))
    rfirst, rsecond, rfo, ralive, rgids, rafter = res["repro"]
    assert fo == rfo and alive == ralive
    assert np.array_equal(gids, rgids)
    for r, t in ((rfirst, first), (rsecond, second), (rafter, after)):
        _same(r, t)


# ----------------------------------------------------- across the packages

def test_torch_client_against_reference_server(pkgs, servers, built, pds):
    """The port's RemotePool against ``python -m repro.net.server``: the
    port LocalPool's results bit for bit, and the same wire tallies as
    against the port's own server."""
    data, queries = pds
    _, T = pkgs
    local = _engine(T, built, data, "local", quant="int8")
    outs, wires = [], []
    for ep in (servers["repro"][0], servers["repro_torch"][0]):
        eng = _engine(T, built, data, "remote", endpoints=(ep,),
                      quant="int8")
        outs.append(eng.search(queries, k=10))
        eng.insert(queries[:2] + 0.001)
        outs.append(eng.search(queries[:8], k=10))
        wires.append(_wire_counts(eng.pool))
    _bit_equal(outs[0], local.search(queries, k=10))
    local.insert(queries[:2] + 0.001)
    _bit_equal(outs[1], local.search(queries[:8], k=10))
    for a, b in zip(outs[:2], outs[2:]):
        _bit_equal(a, b)
        assert a[2]["net"] == b[2]["net"]
    assert wires[0] == wires[1]
    assert wires[0]["payload_by_verb"]["read_spans_quant"] > 0


def test_reference_client_against_torch_server(pkgs, servers, built, pds):
    """The JAX package's RemotePool against ``python -m
    repro_torch.net.server``: the same results, ``net`` and wire tallies
    as against the reference's own server."""
    data, queries = pds
    R, _ = pkgs
    outs, wires = [], []
    for ep in (servers["repro_torch"][1], servers["repro"][1]):
        eng = _engine(R, built, data, "remote", endpoints=(ep,),
                      quant="int8")
        outs.append(eng.search(queries, k=10))
        eng.insert(queries[:2] + 0.001)
        outs.append(eng.search(queries[:8], k=10))
        wires.append(_wire_counts(eng.pool))
    for a, b in zip(outs[:2], outs[2:]):
        _bit_equal(a, b)
        assert a[2]["net"] == b[2]["net"]
    assert wires[0] == wires[1]


# runs ``python -m repro_torch.net.server`` and, as it exits, writes what
# it imported and whether torch had initialised CUDA to the file argv[1]
SERVE_AND_DUMP = """
import atexit, json, runpy, sys
dump = sys.argv[1]
def report():
    t = sys.modules.get("torch")
    with open(dump, "w") as f:
        json.dump({"modules": sorted(sys.modules),
                   "cuda_initialized": None if t is None
                   else bool(t.cuda.is_initialized())}, f)
atexit.register(report)
sys.argv = ["repro_torch.net.server", "--port", "0"]
runpy.run_module("repro_torch.net.server", run_name="__main__",
                 alter_sys=True)
"""


def test_spawned_server_never_touches_cuda_or_jax(pkgs, tiny, pds,
                                                  tmp_path, chip_smoke):
    """``python -m repro_torch.net.server`` serves verbs with numpy alone:
    its import list (``-X importtime``) holds no JAX, nothing of the JAX
    package, no kernel module and no Triton; while it serves, ``/proc``
    shows no ``/dev/nvidia*`` file open or mapped
    (``chip_smoke.cuda_marks``, which phase 14 also holds on the card);
    and as it exits, the torch it imported through the package has not
    initialised CUDA."""
    _, T = pkgs
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log, dump = tmp_path / "imports.log", tmp_path / "exit.json"
    with open(log, "w") as err:
        p = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-c", SERVE_AND_DUMP,
             str(dump)],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env)
        try:
            line = p.stdout.readline()
            assert line.startswith("POOLSERVER LISTENING"), line
            _, _, host, port = line.split()
            pool = T.RemotePool(_store(T, tiny), f"{host}:{port}",
                                device="cpu")
            pool.attach_quant(32)
            pool.read_spans(np.arange(3), ledger=None)
            pool.read_quant_rows(torch.tensor([0, 5, 9]))
            assert pool.append(pds[0][0] + 0.5, 9_999, 1, ledger=None) >= 0
            assert pool.server_stats()["attached"]
            assert p.poll() is None
            assert chip_smoke.cuda_marks(p.pid) == []
            p.send_signal(signal.SIGINT)      # a clean exit: atexit runs
            assert p.wait(timeout=30) == 0
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    mods = [ln.rsplit("|", 1)[1].strip() for ln in log.read_text()
            .splitlines() if ln.startswith("import time:") and "|" in ln]
    assert "numpy" in mods and "repro_torch.rdma.mr" in mods
    bad = sorted(m for m in mods
                 if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")
                 or m.startswith("repro_torch.kernels"))
    assert not bad, bad
    exit_state = json.loads(dump.read_text())
    assert "torch" in exit_state["modules"]
    assert exit_state["cuda_initialized"] is False


# ------------------------------------------------------------ chip_smoke

@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    return cs


def test_chip_smoke_remote_phases_on_cpu(chip_smoke, capsys):
    """Phase 14 (the remote memory pool) on the CPU at the pool phases'
    tiny geometry: one node over both bearers in the exact scan and int8
    flat configurations, three spawned nodes losing one to SIGKILL, a
    durable node recovered from its WAL, and the recovery table of the
    ingest smoke benchmark — every check of theirs runs, and no path
    leaves a kernel launch behind on the CPU."""
    signal.alarm(300)      # the whole phase at once: a longer limit
    cs = chip_smoke
    cpu = torch.device("cpu")
    ds, meta, store, qstore = cs.phase_index(1500, 64, 12)
    vec0 = store.vec_buf.copy()
    pools = cs.PathLog(cpu)
    cs.phase_remote(ds, meta, store, qstore, cpu, k=10, doorbell=16,
                    log_=pools)
    cs.phase_remote_chaos(ds, meta, store, cpu, k=10, doorbell=16,
                          log_=pools, **cs.CHAOS)
    cs.phase_remote_durable(cpu, k=10, doorbell=16, log_=pools,
                            n=1500, n_append=16, n_search=32)
    cs.phase_remote_bench(cpu, pools)
    assert np.array_equal(store.vec_buf, vec0)     # appends on copies
    out = capsys.readouterr().out
    for tag in ("[14a remote/loopback exact scan]",
                "[14a remote/tcp int8 flat]", "[14b chaos]",
                "[14c durable]", "[14d torch_ingest --smoke]"):
        assert tag in out, tag
    assert "attached via recovered" in out and "'deaths': 1" in out
    assert all(n == 0 for n in pools.launches.values())
    # a RemotePool stages no device buffer: phase 14 gathers no span
    assert pools.calls == []
