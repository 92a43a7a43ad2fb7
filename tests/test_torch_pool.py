"""The port's multi-node pools on the CPU: twins of ``tests/test_pool.py``
and of the straggler chaos tests of ``tests/test_obs.py``.

``SimulatedRDMAPool`` (``pool="sim_rdma"``) and ``ShardedPool``
(``pool="sharded"`` over ``local`` or ``sim_rdma`` children) must serve
results bit-identical to the port's ``LocalPool`` — the transport changes
how bytes move, never what the compute side sees.  Each twin also runs
the same configuration through the JAX package on the same index (built
once by the JAX package and carried across with ``repro_torch.convert``)
and holds the port to it: gids equal, distances within rtol 1e-5 /
atol 1e-4 (the two sides sum squares in a different order), and the
counted ``net``, the modeled clock (``sim_s``), placement
(``groups_by_shard``, ``replicas_by_shard``), staging, migration,
failover, replication and elastic tallies and the latency histograms
(``hist``) exactly equal.
"""
import copy
import importlib
import os
import subprocess
import sys
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
SNAP = ("totals", "verbs", "groups_by_shard", "replicas_by_shard",
        "staging", "migration", "sim_s", "sim_total_s", "failover",
        "replication_io", "elastic", "alive", "hist", "fabric", "qp",
        "stragglers", "n_shards", "replication")


class By:
    """An ``EngineConfig`` value made per package (fabrics and placement
    policies are each package's own objects; a policy holds state)."""

    def __init__(self, fn):
        self.fn = fn


def _pkg(name: str) -> types.SimpleNamespace:
    core = importlib.import_module(f"{name}.core.engine")
    cm = importlib.import_module(f"{name}.core.cost_model")
    pool = importlib.import_module(f"{name}.pool")
    placement = importlib.import_module(f"{name}.pool.placement")
    protocol = importlib.import_module(f"{name}.pool.protocol")
    P = types.SimpleNamespace(
        name=name, DHNSWEngine=core.DHNSWEngine,
        EngineConfig=core.EngineConfig, RDMA_100G=cm.RDMA_100G,
        TPU_ICI=cm.TPU_ICI, Fabric=cm.Fabric, NetLedger=cm.NetLedger,
        LocalPool=pool.LocalPool, SimulatedRDMAPool=pool.SimulatedRDMAPool,
        ShardedPool=pool.ShardedPool, PL=placement,
        PoolUnavailableError=protocol.PoolUnavailableError,
        dev={} if name == "repro" else {"device": "cpu"})
    P.slow = lambda **kw: P.Fabric("slow", max_doorbell=32, **kw)
    if name == "repro":
        P.state = lambda b: (copy.deepcopy(b.meta), copy.deepcopy(b.store))
        P.pool_kw = {}
    else:
        P.state = lambda b: convert.state_from_numpy(
            *convert.numpy_state(b.meta, b.store))
        P.pool_kw = {"device": "cpu"}
    return P


@pytest.fixture(scope="module")
def pkgs():
    pytest.importorskip("jax")
    return _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(scope="module")
def pds(sift_small):
    return sift_small.data[:1200], sift_small.queries[:24]


@pytest.fixture(scope="module")
def built(pkgs, pds):
    """One index over ``pds`` built by the JAX package at ``CFG``."""
    R, _ = pkgs
    return R.DHNSWEngine(R.EngineConfig(**CFG)).build(pds[0])


def _engine(P, built, data, pool: str, **over):
    cfg = {**CFG, "fabric": P.RDMA_100G, **over, "pool": pool}
    cfg = {k: v.fn(P) if isinstance(v, By) else v for k, v in cfg.items()}
    eng = P.DHNSWEngine(P.EngineConfig(**cfg), **P.dev)
    eng.client.adopt_built(*P.state(built), data)
    return eng


def _pair(pkgs, built, data, pool: str, **over):
    """(reference engine, port engine) over copies of one index."""
    return tuple(_engine(P, built, data, pool, **over) for P in pkgs)


def _same(ref_out, port_out) -> None:
    """The port's search result against the reference's."""
    (dr, gr, sr), (dt, gt, st) = ref_out, port_out
    assert np.array_equal(gt, gr)
    np.testing.assert_allclose(dt, dr, rtol=RTOL, atol=ATOL)
    assert st["net"] == sr["net"]


def _same_snap(ref_snap: dict, port_snap: dict, keys=SNAP) -> None:
    for key in keys:
        assert port_snap.get(key) == ref_snap.get(key), key
    for rs, ps in zip(ref_snap.get("shards", []), port_snap.get("shards", [])):
        _same_snap(rs, ps, ("kind", "totals", "verbs", "staging", "sim_s",
                            "hist", "qp"))


def _both(ref, eng, fn):
    """``fn`` on each engine: (reference result, port result)."""
    return fn(ref), fn(eng)


# ----------------------------------------------------------- conformance

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["naive", "full"])
def test_pools_bit_identical_search_insert(pkgs, built, pds, mode, quant):
    """sim_rdma serves the port's LocalPool results and counted network
    exactly, before and after inserts; against the reference's sim_rdma
    the results, net, modeled clock and histograms agree."""
    data, queries = pds
    _, T = pkgs
    local = _engine(T, built, data, "local", mode=mode, quant=quant)
    ref, eng = _pair(pkgs, built, data, "sim_rdma", mode=mode, quant=quant)
    d0, g0, st0 = local.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(g0, t[1]) and np.array_equal(d0, t[0])
    assert st0["net"] == t[2]["net"]
    _same(r, t)
    new = queries[:3] + 0.001
    gl = local.insert(new)
    gr, gt = _both(ref, eng, lambda e: e.insert(new))
    assert np.array_equal(gl, gt) and np.array_equal(gr, gt)
    assert eng._last_insert_net == ref._last_insert_net
    d1, g1, _ = local.search(queries[:8], k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries[:8], k=10))
    assert np.array_equal(g1, t[1]) and np.array_equal(d1, t[0])
    _same(r, t)
    assert t[2]["pool"]["sim_total_s"] > 0
    assert "sim_total_s" not in st0["pool"]
    _same_snap(ref.pool.snapshot(), eng.pool.snapshot())


@pytest.mark.parametrize("pool", ["local", "sim_rdma"])
def test_verb_counts_match_ledger(pkgs, built, pds, pool):
    """Pool-side running totals == the sum of every ledger the engine
    charged (searches and inserts), equal to the reference's."""
    data, queries = pds
    ref, eng = _pair(pkgs, built, data, pool, quant="int8")
    totals = {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}
    for i in range(3):
        q = queries[i * 8:(i + 1) * 8]
        r, t = _both(ref, eng, lambda e: e.search(q, k=10))
        _same(r, t)
        for k in totals:
            totals[k] += t[2]["net"][k]
    new = queries[:2] + 0.001
    _both(ref, eng, lambda e: e.insert(new))
    assert eng._last_insert_net == ref._last_insert_net
    for k in totals:
        totals[k] += eng._last_insert_net[k]
    snap = eng.pool.snapshot()
    for k in totals:
        assert snap["totals"][k] == pytest.approx(totals[k]), k
    assert snap["verbs"]["read_meta"] >= 3
    assert snap["verbs"]["append"] == 2
    _same_snap(ref.pool.snapshot(), snap)


# ---------------------------------------------------------- verb level

def _tiny_store(P, data):
    """``tests/test_pool.py``'s tiny store, built by the JAX package for
    the reference and carried across for the port."""
    from repro.core.hnsw import HNSWParams
    from repro.core.layout import build_store
    from repro.core.meta import build_meta
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    store = build_store(data, meta, sub_params=HNSWParams(
        M=4, M0=8, ef_construction=40))
    if P.name == "repro":
        return store
    return convert.state_from_numpy(*convert.numpy_state(meta, store))[1]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_raw_verbs_agree_across_transports(pkgs, pds):
    """Verb by verb: both port transports return identical data for
    identical descriptors and charge identical ledgers, equal to the
    reference's simulated transport, its modeled clock included."""
    data, _ = pds
    R, T = pkgs
    lp = T.LocalPool(_tiny_store(T, data), device="cpu")
    sp = T.SimulatedRDMAPool(_tiny_store(T, data), device="cpu",
                             fabric=T.RDMA_100G)
    rp = R.SimulatedRDMAPool(_tiny_store(R, data), fabric=R.RDMA_100G)
    led = {n: P.NetLedger(P.RDMA_100G)
           for n, P in (("l", T), ("s", T), ("r", R))}
    pids = np.array([0, 3, 5, 6])
    outs = {n: p.read_spans(pids, ledger=led[n], doorbell=2)
            for n, p in (("l", lp), ("s", sp), ("r", rp))}
    for a, b, c in zip(outs["l"], outs["s"], outs["r"]):
        assert np.array_equal(_np(a), _np(b))
        assert np.array_equal(_np(b), _np(c))
    assert led["l"].as_dict() == led["s"].as_dict() == led["r"].as_dict()
    assert lp.totals == sp.totals == rp.totals
    rows = np.array([[0, 5, 9], [2, -1, 7]], np.int32)
    assert np.array_equal(_np(lp.read_rows(torch.as_tensor(rows))),
                          _np(sp.read_rows(torch.as_tensor(rows))))
    assert np.array_equal(_np(sp.read_rows(torch.as_tensor(rows))),
                          _np(rp.read_rows(rows)))
    vec = data[0] + 0.5
    slots = [p.append(vec, 9999, 1, ledger=led[n])
             for n, p in (("l", lp), ("s", sp), ("r", rp))]
    assert slots[0] == slots[1] == slots[2] >= 0
    for a in ("vec_buf", "graph_buf", "meta_table"):
        assert np.array_equal(getattr(lp.store, a), getattr(sp.store, a))
        assert np.array_equal(getattr(sp.store, a), getattr(rp.store, a))
    assert led["l"].as_dict() == led["s"].as_dict() == led["r"].as_dict()
    assert set(sp.sim_s) == {"read_spans", "append"}
    assert sp.sim_s == rp.sim_s and sp.sim_total_s > 0
    assert sp.snapshot()["qp"] == rp.snapshot()["qp"]
    assert sp.snapshot()["hist"] == rp.snapshot()["hist"]


# ------------------------------------------------------------ sharded

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["naive", "full"])
def test_sharded_bit_identical_search_insert(pkgs, built, pds, mode, quant):
    """ShardedPool at 1, 2 and 4 shards gives the port LocalPool's results
    bit for bit, before and after inserts; against the reference's sharded
    pool, results, net, placement and staging agree."""
    data, queries = pds
    _, T = pkgs
    base = _engine(T, built, data, "local", mode=mode, quant=quant)
    d0, g0, _ = base.search(queries, k=10)
    new = queries[:3] + 0.001
    pairs = {ns: _pair(pkgs, built, data, "sharded", mode=mode, quant=quant,
                       n_shards=ns) for ns in (1, 2, 4)}
    for ns, (ref, eng) in pairs.items():
        r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
        assert np.array_equal(g0, t[1]), (ns, "gids")
        assert np.array_equal(d0, t[0]), (ns, "dists")
        _same(r, t)
        assert t[2]["pool"]["kind"] == "sharded"
        assert t[2]["pool"]["n_shards"] == ns
        assert sum(t[2]["pool"]["groups_by_shard"]) == base.store.spec.n_groups
    gids0 = base.insert(new)
    d1, g1, _ = base.search(queries[:8], k=10)
    for ns, (ref, eng) in pairs.items():
        gr, gt = _both(ref, eng, lambda e: e.insert(new))
        assert np.array_equal(gids0, gt) and np.array_equal(gr, gt), ns
        assert eng._last_insert_net == ref._last_insert_net
        r, t = _both(ref, eng, lambda e: e.search(queries[:8], k=10))
        assert np.array_equal(g1, t[1]), (ns, "post-insert gids")
        assert np.array_equal(d1, t[0]), (ns, "post-insert dists")
        _same(r, t)
        _same_snap(ref.pool.snapshot(), eng.pool.snapshot())


def test_sharded_one_shard_accounting_matches_local(pkgs, built, pds):
    """With one shard the fan-out reduces to the child: counted network
    equal to LocalPool's, and to the reference's."""
    data, queries = pds
    _, T = pkgs
    e0 = _engine(T, built, data, "local")
    ref, eng = _pair(pkgs, built, data, "sharded", n_shards=1)
    _, _, st0 = e0.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert st0["net"] == t[2]["net"]
    _same(r, t)


@pytest.mark.parametrize("parallel", [True, False])
def test_sharded_verb_parity_summed_ledgers(pkgs, built, pds, parallel):
    """Pool totals == the sum of the charged ledgers; children sum to the
    pool on bytes and descriptors; trips reduce by max in parallel mode
    and sum in serial mode — each equal to the reference's."""
    data, queries = pds
    ref, eng = _pair(pkgs, built, data, "sharded", quant="int8", n_shards=3,
                     shard_parallel=parallel)
    totals = {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}
    for i in range(3):
        q = queries[i * 8:(i + 1) * 8]
        r, t = _both(ref, eng, lambda e: e.search(q, k=10))
        _same(r, t)
        for k in totals:
            totals[k] += t[2]["net"][k]
    new = queries[:2] + 0.001
    _both(ref, eng, lambda e: e.insert(new))
    assert eng._last_insert_net == ref._last_insert_net
    for k in totals:
        totals[k] += eng._last_insert_net[k]
    snap = eng.pool.snapshot()
    for k in totals:
        assert snap["totals"][k] == pytest.approx(totals[k]), k
    child_sum = {k: sum(s["totals"][k] for s in snap["shards"])
                 for k in totals}
    assert child_sum["bytes"] == pytest.approx(snap["totals"]["bytes"])
    assert child_sum["descriptors"] == pytest.approx(
        snap["totals"]["descriptors"])
    if parallel:
        assert snap["totals"]["round_trips"] <= child_sum["round_trips"]
    else:
        assert snap["totals"]["round_trips"] == pytest.approx(
            child_sum["round_trips"])
    assert snap["verbs"]["append"] == 2
    _same_snap(ref.pool.snapshot(), snap)


def test_sharded_migration_keeps_results_identical(pkgs, built, pds):
    """Frequency-aware placement migrates hot groups under a skewed
    workload; results before and after (and after an insert) stay
    bit-identical to LocalPool, and the migrations, heat-driven moves and
    re-stages equal the reference's."""
    data, queries = pds
    _, T = pkgs
    kw = dict(cache_frac=0.1, n_shards=2, shard_transport="sim_rdma",
              shard_fabrics=By(lambda P: (P.RDMA_100G, P.slow(
                  rtt_s=100e-6, bw_Bps=0.5e9, per_op_s=5e-6))),
              placement=By(lambda P: P.PL.FrequencyAwarePlacement(
                  migrate_every=24, max_moves=4)))
    base = _engine(T, built, data, "local", cache_frac=0.1)
    ref, eng = _pair(pkgs, built, data, "sharded", **kw)
    hot = np.tile(queries[:4], (4, 1))
    for _ in range(8):
        r, t = _both(ref, eng, lambda e: e.search(hot, k=10))
        _same(r, t)
    dh0, gh0, _ = base.search(hot, k=10)
    assert np.array_equal(dh0, t[0]) and np.array_equal(gh0, t[1])
    assert t[2]["pool"]["migration"]["n"] >= 1, "skewed load should migrate"
    d0, g0, _ = base.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    _same(r, t)
    new = queries[:2] + 0.002
    base.insert(new)
    _both(ref, eng, lambda e: e.insert(new))
    d0, g0, _ = base.search(queries[:8], k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries[:8], k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    _same(r, t)
    _same_snap(ref.pool.snapshot(), eng.pool.snapshot())


def _hetero(P, data, parallel: bool):
    s = _tiny_store(P, data)
    slow = P.slow(rtt_s=200e-6, bw_Bps=0.125e9, per_op_s=25e-6)
    pool = P.ShardedPool(
        s, [lambda st: P.SimulatedRDMAPool(st, fabric=P.RDMA_100G,
                                           **P.pool_kw),
            lambda st: P.SimulatedRDMAPool(st, fabric=slow, **P.pool_kw)],
        placement=P.PL.RoundRobinPlacement(), parallel=parallel,
        **P.pool_kw)
    led = P.NetLedger(P.RDMA_100G)
    for _ in range(3):
        pool.read_spans(np.arange(8), ledger=led, doorbell=4)
    pool.post_row_reads([(p, 2) for p in range(8)], ledger=led, doorbell=4)
    return pool, led


def test_sharded_hetero_fabric_straggler_dominates(pkgs, pds):
    """Parallel fan-out over a fast and a straggler shard: the pool clock
    is the straggler's slices; serial sums every slice and doubles the
    trips — the clocks and ledgers equal the reference's."""
    data, _ = pds
    R, T = pkgs
    par, led_p = _hetero(T, data, True)
    ser, led_s = _hetero(T, data, False)
    fast_t = par.children[0].sim_total_s
    slow_t = par.children[1].sim_total_s
    assert slow_t > 10 * fast_t
    assert slow_t <= par.sim_total_s <= slow_t * 1.05
    assert ser.sim_total_s == pytest.approx(fast_t + slow_t)
    assert led_s.round_trips > led_p.round_trips
    assert led_s.bytes == led_p.bytes
    assert led_s.descriptors == led_p.descriptors
    for parallel, pool, led in ((True, par, led_p), (False, ser, led_s)):
        rpool, rled = _hetero(R, data, parallel)
        assert led.as_dict() == rled.as_dict()
        assert pool.sim_s == rpool.sim_s
        _same_snap(rpool.snapshot(), pool.snapshot())


def test_sharded_raw_row_verbs_match_local(pkgs, pds):
    """Row verbs fan out by owning shard and reassemble into what a single
    pool returns on the live lanes; every lane, the -1 lanes' placeholders
    included, equals the reference's sharded pool."""
    data, _ = pds
    R, T = pkgs
    lp = T.LocalPool(_tiny_store(T, data), device="cpu")
    sp = T.ShardedPool(_tiny_store(T, data),
                       [lambda st: T.LocalPool(st, device="cpu")] * 3,
                       device="cpu")
    rp = R.ShardedPool(_tiny_store(R, data), [lambda st: R.LocalPool(st)] * 3)
    rows = np.array([[0, 65, 130], [200, -1, 7]], np.int32)
    a = _np(lp.read_rows(torch.as_tensor(rows)))
    b = _np(sp.read_rows(torch.as_tensor(rows)))
    live = rows >= 0
    assert np.array_equal(a[live], b[live])
    assert np.array_equal(b, _np(rp.read_rows(rows)))


def test_restricted_children_row_fanout_placeholders(pkgs, pds):
    """Each child of a sharded pool is compacted to its own groups, so a
    child asked for another shard's rows maps them, like -1 lanes, to a
    placeholder (its compacted row 0).  The owner's lanes win the select:
    every live lane equals the fully staged pool's, and every lane —
    placeholders included — equals the reference's, for exact rows and
    for the int8 codes and scales the flat view reads."""
    data, _ = pds
    R, T = pkgs
    pools = {}
    for P in (R, T):
        st = _tiny_store(P, data)
        full = P.LocalPool(copy.deepcopy(st), **P.pool_kw)
        sp = P.ShardedPool(st, [lambda s, P=P: P.LocalPool(s, **P.pool_kw)]
                           * 4, **P.pool_kw)
        sp.attach_quant(8)
        full.attach_quant(8)
        pools[P.name] = (full, sp)
    full, sp = pools["repro_torch"]
    rfull, rsp = pools["repro"]
    spec = sp.spec
    assert all(c.staging["compacted"] for c in sp.children)
    sv = spec.slot_vecs
    # rows of every group, -1 lanes, and row 0 of each shard's first block
    groups = np.arange(spec.n_groups)
    rows = np.concatenate([groups * spec.group_blocks * sv + 3, [-1, -1],
                           groups * spec.group_blocks * sv]).astype(np.int32)
    rows = rows.reshape(2, -1)
    live = rows >= 0
    owners = {sp._owners_of_rows(rows[live])[i] for i in range(live.sum())}
    assert len(owners) == 4
    got = _np(sp.read_rows(torch.as_tensor(rows)))
    assert np.array_equal(got[live], _np(full.read_rows(
        torch.as_tensor(rows)))[live])
    assert np.array_equal(got, _np(rsp.read_rows(rows)))
    codes, scales = sp.read_quant_rows(torch.as_tensor(rows))
    fc, fs = full.read_quant_rows(torch.as_tensor(rows))
    rc, rs = rsp.read_quant_rows(rows)
    assert np.array_equal(_np(codes)[live], _np(fc)[live])
    assert np.array_equal(_np(scales)[live], _np(fs)[live])
    assert np.array_equal(_np(codes), _np(rc))
    assert np.array_equal(_np(scales), _np(rs))
    # and a child alone maps another shard's rows and -1 lanes to -1
    c0 = sp.children[0]
    mapped = _np(c0._staged_rows(torch.as_tensor(rows)))
    assert (mapped[~live] == -1).all()
    mine = np.array([sp._owners_of_rows([r])[0] == 0 if r >= 0 else False
                     for r in rows.reshape(-1)]).reshape(rows.shape)
    assert (mapped[live & ~mine] == -1).all()
    assert (mapped[mine] >= 0).all()


def test_sim_transport_parallel_fanout_hook(pkgs, pds):
    """Scalar charges are identical with or without ``parallel``; vector
    charges reduce by max (parallel) or sum (serial), to the reference's
    float64 values."""
    data, _ = pds
    out = {}
    for P in pkgs:
        ser = P.SimulatedRDMAPool(_tiny_store(P, data), fabric=P.RDMA_100G,
                                  parallel=False, **P.pool_kw)
        par = P.SimulatedRDMAPool(_tiny_store(P, data), fabric=P.RDMA_100G,
                                  parallel=True, **P.pool_kw)
        led_a, led_b = P.NetLedger(P.RDMA_100G), P.NetLedger(P.RDMA_100G)
        ser.read_spans(np.arange(6), ledger=led_a, doorbell=3)
        par.read_spans(np.arange(6), ledger=led_b, doorbell=3)
        assert ser.sim_s == par.sim_s
        assert led_a.as_dict() == led_b.as_dict()
        ser._transport("fanout", [1e6, 2e6], [4, 4], [1, 1])
        par._transport("fanout", [1e6, 2e6], [4, 4], [1, 1])
        assert ser.sim_s["fanout"] == pytest.approx(
            ser.model_dt(1e6, 4, 1) + ser.model_dt(2e6, 4, 1))
        assert par.sim_s["fanout"] == pytest.approx(par.model_dt(2e6, 4, 1))
        out[P.name] = (ser.sim_s, par.sim_s, led_a.as_dict())
    assert out["repro"] == out["repro_torch"]


# ------------------------------------------------------------ placement

def test_placement_round_robin_and_size_balanced(pkgs):
    R, T = pkgs
    for P in pkgs:
        assert P.PL.RoundRobinPlacement().place(10, 3).tolist() == [
            0, 1, 2, 0, 1, 2, 0, 1, 2, 0]
    sizes = np.array([100, 1, 1, 1, 50, 49, 1, 1])
    owner = T.PL.SizeBalancedPlacement().place(8, 2, group_sizes=sizes)
    loads = [sizes[owner == s].sum() for s in (0, 1)]
    assert abs(loads[0] - loads[1]) <= sizes.max() // 2
    assert np.array_equal(owner, R.PL.SizeBalancedPlacement().place(
        8, 2, group_sizes=sizes))


def test_placement_freq_moves_hot_to_cheap_shard(pkgs):
    moves = {}
    for P in pkgs:
        pol = P.PL.FrequencyAwarePlacement(migrate_every=8, max_moves=2,
                                           min_gain=0.01)
        owner = pol.place(6, 2)
        due = False
        for _ in range(20):
            due = pol.note_access(0) or due
        assert due
        moves[P.name] = pol.plan_moves(owner, shard_costs=[1.0, 0.1])
        assert (0, 0, 1) in moves[P.name]
    assert moves["repro"] == moves["repro_torch"]


def test_sim_latency_scales_with_fabric(pkgs, built, pds):
    """A slower fabric models more wire time for the same verbs (same
    counts, same results), equal to the reference's on both fabrics."""
    data, queries = pds
    slow = By(lambda P: P.slow(rtt_s=50e-6, bw_Bps=1e9, per_op_s=1e-6))
    fast = By(lambda P: P.TPU_ICI)
    out = {}
    for name, fab in (("fast", fast), ("slow", slow)):
        ref, eng = _pair(pkgs, built, data, "sim_rdma", fabric=fab)
        r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
        _same(r, t)
        assert t[2]["pool"]["sim_s"] == r[2]["pool"]["sim_s"]
        out[name] = t
    (_, gf, stf), (_, gs, sts) = out["fast"], out["slow"]
    assert np.array_equal(gf, gs)
    assert stf["net"]["round_trips"] == sts["net"]["round_trips"]
    assert sts["pool"]["sim_total_s"] > stf["pool"]["sim_total_s"]
    assert sts["net"]["latency_s"] > stf["net"]["latency_s"]


# ------------------------------------------------------- capacity layer

def test_apply_budgets_keeps_within_budget_and_spills(pkgs):
    R, T = pkgs
    owner = np.array([0, 0, 0, 0, 1, 1], np.int64)
    sizes = np.array([10, 10, 10, 10, 10, 10], np.float64)
    kw = dict(group_sizes=sizes, shard_budgets=[25, 25, 100],
              shard_costs=[0.0, 0.0, 0.0])
    out = T.PL.apply_budgets(owner, **kw)
    loads = [sizes[out == s].sum() for s in range(3)]
    assert loads[0] <= 25 and loads[1] <= 25
    assert sizes.sum() == sum(loads)
    assert (out[:2] == 0).all()
    assert np.array_equal(out, R.PL.apply_budgets(owner, **kw))


def test_apply_budgets_never_rejects_data(pkgs):
    R, T = pkgs
    owner = np.zeros(6, np.int64)
    kw = dict(group_sizes=np.full(6, 10.0), shard_budgets=[5, 5])
    out = T.PL.apply_budgets(owner, **kw)
    assert set(out.tolist()) <= {0, 1}
    loads = [float((out == s).sum()) for s in (0, 1)]
    assert abs(loads[0] - loads[1]) <= 1
    assert np.array_equal(out, R.PL.apply_budgets(owner, **kw))


def test_place_replicated_distinct_shards_and_clamp(pkgs):
    R, T = pkgs
    owner = np.array([0, 1, 2, 0, 1], np.int64)
    reps = T.PL.place_replicated(owner, 3, 2)
    assert reps.shape == (5, 2)
    assert np.array_equal(reps[:, 0], owner)
    assert all(row[0] != row[1] for row in reps)
    reps4 = T.PL.place_replicated(owner, 3, 4)
    assert reps4.shape == (5, 3)
    assert all(len(set(row.tolist())) == 3 for row in reps4)
    assert T.PL.place_replicated(np.zeros(4, np.int64), 1, 3).shape == (4, 1)
    for r, args in ((reps, (owner, 3, 2)), (reps4, (owner, 3, 4))):
        assert np.array_equal(r, R.PL.place_replicated(*args))


def test_place_replicated_respects_budgets(pkgs):
    R, T = pkgs
    owner = np.array([0, 1, 0, 1], np.int64)
    kw = dict(group_sizes=np.full(4, 10.0),
              shard_budgets=[20.0, 20.0, 100.0])
    reps = T.PL.place_replicated(owner, 3, 2, **kw)
    assert (reps[:, 1] == 2).all()
    assert np.array_equal(reps, R.PL.place_replicated(owner, 3, 2, **kw))


# ----------------------------------------------------------- replication

class _DeadChild:
    """A vanished memory node: every verb raises the package's
    ``PoolUnavailableError``, like a transport with a dead socket."""

    _VERBS = ("read_spans", "read_rows", "read_quant_rows", "append",
              "repack", "refresh_blocks", "adopt", "_stage_quant",
              "snapshot", "close")

    def __init__(self, err):
        self._err = err

    def __getattr__(self, name):
        if name in self._VERBS:
            def boom(*a, **k):
                raise self._err("node down (test stub)")
            return boom
        raise AttributeError(name)


def test_replicated_pool_bit_identical_with_parity(pkgs, built, pds):
    data, queries = pds
    _, T = pkgs
    base = _engine(T, built, data, "local")
    ref, eng = _pair(pkgs, built, data, "sharded", n_shards=3,
                     replication=2)
    d0, g0, st0 = base.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    assert st0["net"] == t[2]["net"]
    _same(r, t)
    snap = t[2]["pool"]
    assert snap["replication"] == 2
    assert sum(snap["replicas_by_shard"]) == 2 * base.store.spec.n_groups
    assert sum(snap["groups_by_shard"]) == base.store.spec.n_groups
    _same_snap(r[2]["pool"], snap)


def test_replica_selection_prefers_cheapest_live_shard(pkgs, pds):
    data, _ = pds
    serve = {}
    for P in pkgs:
        s = _tiny_store(P, data)
        slow = P.slow(rtt_s=200e-6, bw_Bps=0.125e9, per_op_s=25e-6)
        pool = P.ShardedPool(
            s, [lambda st: P.SimulatedRDMAPool(st, fabric=P.RDMA_100G,
                                               **P.pool_kw),
                lambda st: P.SimulatedRDMAPool(st, fabric=slow,
                                               **P.pool_kw)],
            replication=2, **P.pool_kw)
        assert all(pool.owner_of_group(g) == 0
                   for g in range(s.spec.n_groups))
        pool.read_spans(np.arange(6), ledger=P.NetLedger(P.RDMA_100G),
                        doorbell=3)
        assert pool.children[1].verbs.get("read_spans", 0) == 0
        serve[P.name] = pool.snapshot()
    _same_snap(serve["repro"], serve["repro_torch"])


def test_failover_mid_stream_is_transparent(pkgs, built, pds):
    """Kill one shard between searches at replication=2: the next search
    retries on the survivors with results bit-identical to LocalPool and
    the ledger unchanged; only the dead shard's groups re-stage; inserts
    then fan to the remaining replicas — every counter as the
    reference's."""
    data, queries = pds
    _, T = pkgs
    base = _engine(T, built, data, "local")
    ref, eng = _pair(pkgs, built, data, "sharded", n_shards=3,
                     replication=2)
    base.search(queries, k=10)
    _both(ref, eng, lambda e: e.search(queries, k=10))
    for P, e in zip(pkgs, (ref, eng)):
        e.pool.children[0] = _DeadChild(P.PoolUnavailableError)
    d0, g0, st0 = base.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    for key in ("round_trips", "descriptors", "bytes"):
        assert st0["net"][key] == t[2]["net"][key], key
    _same(r, t)
    fo = t[2]["pool"]["failover"]
    assert fo["deaths"] == 1 and fo["lost_groups"] == 0
    assert fo["read_retries"] >= 1 and fo["rereplicated_groups"] >= 1
    assert t[2]["pool"]["alive"] == [False, True, True]
    gb = eng.store.spec.group_blocks
    restaged = sum(c.staging["restaged_blocks"]
                   for c in eng.pool.children[1:])
    assert restaged == fo["rereplicated_groups"] * gb
    new = queries[:2] + 0.001
    gl = base.insert(new)
    gr, gt = _both(ref, eng, lambda e: e.insert(new))
    assert np.array_equal(gl, gt) and np.array_equal(gr, gt)
    d2, g2, _ = base.search(queries[:8], k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries[:8], k=10))
    assert np.array_equal(d2, t[0]) and np.array_equal(g2, t[1])
    _same(r, t)
    assert eng.pool.replication_io["fanout_writes"] >= 1
    _same_snap(ref.pool.snapshot(), eng.pool.snapshot())


def test_single_replica_death_still_surfaces(pkgs, built, pds):
    data, queries = pds
    _, T = pkgs
    eng = _engine(T, built, data, "sharded", n_shards=2, replication=1)
    eng.search(queries[:4], k=10)
    eng.pool.children[0] = _DeadChild(T.PoolUnavailableError)
    with pytest.raises(T.PoolUnavailableError):
        eng.search(queries[:4], k=10)
    assert eng.pool.failover["lost_groups"] >= 1


def test_elastic_add_remove_shard(pkgs, built, pds):
    """add_shard moves only the groups the policy maps to the new shard;
    remove_shard drains through re-replication; results unchanged, and
    the elastic and failover tallies equal the reference's."""
    data, queries = pds
    _, T = pkgs
    base = _engine(T, built, data, "local")
    ref, eng = _pair(pkgs, built, data, "sharded", n_shards=2,
                     replication=2)
    d0, g0, _ = base.search(queries, k=10)
    for P, e in zip(pkgs, (ref, eng)):
        assert e.pool.add_shard(
            lambda st, P=P: P.LocalPool(st, **P.pool_kw)) == 2
    assert eng.pool.n_shards == 3
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    _same(r, t)
    assert eng.pool.elastic["added"] == 1
    assert eng.pool.elastic["moved_groups"] >= 1
    _both(ref, eng, lambda e: e.pool.remove_shard(0))
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    _same(r, t)
    snap = eng.pool.snapshot()
    assert snap["alive"] == [False, True, True]
    assert snap["failover"]["deaths"] == 0
    assert snap["elastic"]["removed"] == 1
    assert snap["failover"]["lost_groups"] == 0
    _same_snap(ref.pool.snapshot(), snap)


def test_shard_budgets_cap_primary_load(pkgs, built, pds):
    data, queries = pds
    _, T = pkgs
    base = _engine(T, built, data, "local")
    fp = _engine(T, built, data, "sharded",
                 n_shards=2).pool._group_footprint_bytes()
    ref, eng = _pair(pkgs, built, data, "sharded", n_shards=2,
                     shard_budgets=(fp, fp * 64))
    d0, g0, _ = base.search(queries, k=10)
    r, t = _both(ref, eng, lambda e: e.search(queries, k=10))
    assert np.array_equal(d0, t[0]) and np.array_equal(g0, t[1])
    _same(r, t)
    assert t[2]["pool"]["groups_by_shard"][0] <= 1
    _same_snap(r[2]["pool"], t[2]["pool"])


# ------------------------------------------------------------ chaos e2e

def test_straggler_detected_and_routed_around(pkgs, built, pds):
    """Twin of ``tests/test_obs.py``'s straggler chaos: a seeded WR
    injector on shard 1 of a 3-shard sim-RDMA pool at replication=2; the
    detector flags exactly shard 1, its serving slots move, later reads
    post nothing to it, results never change — and the detector report,
    the histograms and the straggler tallies equal the reference's."""
    data, queries = pds
    kw = dict(shard_transport="sim_rdma", n_shards=3, replication=2)
    R, T = pkgs
    res = {}
    for P in pkgs:
        HI = importlib.import_module(f"{P.name}.obs.hist")
        INJ = importlib.import_module(f"{P.name}.rdma.inject")
        TR = importlib.import_module(f"{P.name}.obs.trace").TRACER
        ref = _engine(P, built, data, "sharded", **kw)
        d0b, g0b, _ = ref.search(queries[8:], k=5)
        TR.configure(trace_id=51, tail=True, tail_window=64)
        try:
            eng = _engine(P, built, data, "sharded", **kw)
            eng.pool.straggler = HI.StragglerDetector(min_count=4,
                                                      min_excess_s=1e-4)
            for _ in range(3):
                eng.search(queries[:8], k=5)
            assert eng.pool.check_stragglers()["flagged"] == {}
            inj = INJ.WRInjector(seed=7, delay_s=2e-3)
            eng.pool.children[1].set_injector(inj)
            for _ in range(3):
                d2, g2, _ = eng.search(queries[8:], k=5)
            rep = eng.pool.check_stragglers()
            assert set(rep["flagged"]) == {1}
            assert rep["flagged"][1]["excess_s"] >= 1e-4
            assert not np.any(eng.pool._serve == 1)
            posts = inj.posts
            d3, g3, _ = eng.search(queries[8:], k=5)
            assert inj.posts == posts
        finally:
            TR.disable()
        for d, g in ((d2, g2), (d3, g3)):
            assert np.array_equal(d, d0b) and np.array_equal(g, g0b)
        st = eng.pool.snapshot()
        assert st["stragglers"]["flagged_now"] == 1
        assert st["stragglers"]["reroutes"] >= 1
        assert "read_spans" in st["hist"]
        res[P.name] = (st, rep, g3, inj.snapshot())
    (rst, rrep, rg, rinj), (tst, trep, tg, tinj) = (res["repro"],
                                                   res["repro_torch"])
    assert np.array_equal(tg, rg)
    assert trep == rrep and tinj == rinj
    _same_snap(rst, tst)


def test_slo_and_metrics_with_dead_shard(pkgs, built, pds):
    """The port's serving tier over a sharded sim-RDMA pool that loses a
    shard: SLO, failover and straggler blocks in ``stats()`` and every
    metric family in the exporter, as the reference's."""
    data, queries = pds
    _, T = pkgs
    from repro_torch.serve.batcher import BatchPolicy
    from repro_torch.serve.server import SearchServer
    eng = _engine(T, built, data, "sharded", shard_transport="sim_rdma",
                  n_shards=3, replication=2)
    pol = BatchPolicy(max_batch=8, max_wait_s=1e-3, slo="p99<5ms",
                      slo_short_window=4)
    with SearchServer(eng, pol) as srv:
        srv.search(queries[:4], k=5)
        eng.pool._on_shard_down(1)
        srv.search(queries[4:8], k=5)

        def _dead_harvest():
            raise T.PoolUnavailableError("shard died mid-drain")
        eng.pool.children[0].harvest_trace = _dead_harvest
        assert eng.pool.harvest_trace() == 0
        assert eng.pool.trace_harvest_failures == 1
        srv.search(queries[8:12], k=5)
        st = srv.stats()
        r = st["slo"]["serve"]["-"]
        assert r["n"] >= 2
        assert {"burn", "burn_short", "burn_long", "attainment",
                "met"} <= set(r)
        assert r["threshold_ms"] == pytest.approx(5.0)
        assert st["failover"]["trace_harvest_failures"] == 1
        assert st["failover"]["alive_shards"] == 2
        assert "stragglers" in st
        txt = srv.metrics_text()
    for family in ("repro_slo", "repro_pool_verb_latency_seconds_bucket",
                   "repro_tracer", "repro_straggler", "repro_failover"):
        assert family in txt, family
    for line in txt.strip().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


# ------------------------------------------------------------ factory

def test_factory_checks_and_remote_raises(pkgs, built, pds):
    """The per-shard lists' lengths are checked before a pool is built
    (``shard_fabrics`` by ``make_pool_factory``; a remote child's
    endpoints, and the engine's other checks, by the constructor), and
    every sharded child serves the engine's device.  (The name dates from
    the slices before the remote transport was ported.)"""
    from repro_torch import DHNSWEngine, EngineConfig
    from repro_torch.core.cost_model import RDMA_100G
    with pytest.raises(ValueError, match="shard_fabrics"):
        DHNSWEngine(EngineConfig(pool="sharded", n_shards=3,
                                 shard_fabrics=(RDMA_100G,) * 2),
                    device="cpu")
    with pytest.raises(ValueError, match="endpoints"):
        DHNSWEngine(EngineConfig(pool="sharded", n_shards=2,
                                 shard_transport="remote",
                                 endpoints=("h:1",)), device="cpu")
    with pytest.raises(ValueError, match="shard transport"):
        DHNSWEngine(EngineConfig(pool="sharded", shard_transport="ib"),
                    device="cpu")
    with pytest.raises(ValueError, match="replication"):
        DHNSWEngine(EngineConfig(pool="local", replication=2), device="cpu")
    eng = _engine(pkgs[1], built, pds[0], "sharded", n_shards=2)
    assert all(c.device == torch.device("cpu") for c in eng.pool.children)


def test_cpu_sharded_search_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from repro_torch import DHNSWEngine, EngineConfig\n"
        "from repro_torch.data.synthetic import sift_like\n"
        "ds = sift_like(n=600, n_queries=8, seed=1)\n"
        "for kw in (dict(pool='sim_rdma'),\n"
        "           dict(pool='sharded', shard_transport='sim_rdma',\n"
        "                n_shards=3, replication=2, quant='int8',\n"
        "                quant_kernel='auto', cache_frac=0.6)):\n"
        "    e = DHNSWEngine(EngineConfig(n_rep=8, b=2, search_mode='scan',\n"
        "                                 use_gather_kernel=True, **kw),\n"
        "                    device='cpu').build(ds.data)\n"
        "    d, g, st = e.search(ds.queries, k=5)\n"
        "    assert g.shape == (8, 5) and st['pool']['sim_total_s'] > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
