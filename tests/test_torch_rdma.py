"""The port's verbs layer, bearers, 1/N compacted staging and WR injector
on the CPU: twins of ``tests/test_rdma.py`` (verbs units, bearer
conformance, 1/N staging, the failure surface) and of
``tests/test_obs.py``'s report CLI and WR-injector tests.

``repro_torch.rdma`` and ``repro_torch.net.wire`` are copies of the
reference's (``tests/test_torch_serve.py`` holds their text to the
originals); here they must also behave as the originals on the same
inputs: the same frames, MR geometry, completions and injection
schedules.  The staging twins run the port's sharded pool and the
reference's on the same store and compare every child's staging tallies
and the data they serve.  The bearer twins run ``RemotePool`` over the
loopback bearer (an in-process ``HostRegion``) and the tcp bearer (a
spawned ``python -m repro_torch.net.server``): bit-identical to the
port's ``LocalPool``, and equal to the reference's remote pool on the
same index (gids, ``net``, the measured wire of every verb).
"""
import copy
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G, NetLedger  # noqa: E402
from repro_torch.core.layout import MT_GROUP  # noqa: E402
from repro_torch.net import wire as W  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.pool import LocalPool, ShardedPool  # noqa: E402
from repro_torch.rdma import verbs as V  # noqa: E402
from repro_torch.rdma.inject import InjectedFault, WRInjector  # noqa: E402


@pytest.fixture(scope="module")
def jax_pkg():
    pytest.importorskip("jax")
    import repro.pool as RP
    return RP


@pytest.fixture(scope="module")
def pds(sift_small):
    return sift_small.data[:1200], sift_small.queries[:24]


@pytest.fixture(scope="module")
def tiny(jax_pkg, pds):
    """``tests/test_rdma.py``'s tiny store, built once by the JAX package."""
    from repro.core.hnsw import HNSWParams
    from repro.core.layout import build_store
    from repro.core.meta import build_meta
    data, _ = pds
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    return meta, build_store(data, meta, sub_params=HNSWParams(
        M=4, M0=8, ef_construction=40))


def _stores(tiny):
    """(reference store, port store): fresh copies of the tiny store."""
    meta, store = tiny
    return (copy.deepcopy(store),
            convert.state_from_numpy(*convert.numpy_state(meta, store))[1])


@pytest.fixture(scope="module")
def servers(jax_pkg):
    """One pool server of each package: package name -> endpoints."""
    from repro.net import spawn_pool_servers as rspawn

    from repro_torch.net import spawn_pool_servers
    with rspawn(1) as reps, spawn_pool_servers(1) as teps:
        yield {"repro": reps, "repro_torch": teps}


class Overtime(BaseException):
    """A test ran past its time limit (not an ``OSError``: no transport
    may swallow it)."""


@pytest.fixture()
def time_limit():
    """Fails a test that spawns or talks to servers after 120 s."""
    def boom(*_):
        raise Overtime("test ran past 120 s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _local(st):
    return LocalPool(st, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ verbs units

def test_wr_frame_read_list_is_one_doorbell_frame():
    from repro.net import wire as RW
    from repro.rdma import verbs as RV
    wrs = [V.read_wr(V.RKEY_SPANS, p, 128) for p in (3, 1, 7)]
    op, payload, flags = V.wr_frame(wrs)
    assert op == W.OP_READ_SPANS
    assert np.array_equal(W.dec_pids(payload), [3, 1, 7])
    assert flags == 0
    assert (op, payload, flags) == RV.wr_frame(
        [RV.read_wr(RV.RKEY_SPANS, p, 128) for p in (3, 1, 7)])
    assert np.array_equal(RW.dec_pids(payload), [3, 1, 7])
    assert V.wr_frame([V.read_wr(V.RKEY_ROWS, 5, 4)])[0] == W.OP_READ_ROWS
    assert (V.wr_frame([V.read_wr(V.RKEY_QROWS, 5, 4)])[0]
            == W.OP_READ_QUANT_ROWS)
    w = [V.write_wr(V.RKEY_REGION, 0, b"ab"), V.write_imm_wr(
        V.RKEY_OVERFLOW, 2, b"cd", imm=9)]
    rw = [RV.write_wr(RV.RKEY_REGION, 0, b"ab"), RV.write_imm_wr(
        RV.RKEY_OVERFLOW, 2, b"cd", imm=9)]
    assert V.wr_frame(w) == RV.wr_frame(rw)


def test_wr_frame_rejects_malformed_lists():
    with pytest.raises(ValueError):
        V.wr_frame([])
    with pytest.raises(ValueError):
        V.wr_frame([V.read_wr(V.RKEY_SPANS, 0, 8),
                    V.read_wr(V.RKEY_ROWS, 1, 8)])
    with pytest.raises(ValueError):
        V.wr_frame([V.write_wr(V.RKEY_REGION, 0, b"x")])
    with pytest.raises(ValueError):
        V.wr_frame([V.send_wr(1), V.send_wr(2)])


def test_region_mrs_geometry(tiny):
    from repro.core import layout as RLA
    from repro.rdma import verbs as RV

    from repro_torch.core import layout as LA
    rstore, store = _stores(tiny)
    spec = store.spec
    mrs = V.region_mrs(spec)
    assert set(mrs) == {V.RKEY_SPANS, V.RKEY_ROWS, V.RKEY_OVERFLOW,
                        V.RKEY_REGION}
    assert mrs[V.RKEY_SPANS].length == spec.n_partitions
    assert mrs[V.RKEY_SPANS].nbytes == spec.partition_bytes()
    assert mrs[V.RKEY_REGION].length == spec.n_blocks
    LA.attach_quant_mirror(store, 8)
    RLA.attach_quant_mirror(rstore, 8)
    qmrs = V.region_mrs(store.spec, quant=True)
    assert V.RKEY_QROWS in qmrs
    assert (qmrs[V.RKEY_QROWS].nbytes
            == store.spec.dim + (store.spec.dim // 8) * 4)
    rq = RV.region_mrs(rstore.spec, quant=True)
    assert {k: (m.length, m.nbytes) for k, m in qmrs.items()} == {
        k: (m.length, m.nbytes) for k, m in rq.items()}


def test_completion_queue_maps_remote_errors():
    class ErrBearer:
        frames = False
        closed = False

        def __init__(self):
            self.q = []

        def submit(self, op, payload, flags=0, *, prefix=b"", wrs=None):
            self.q.append((op or 7, W.FLAG_ERROR, b"boom"))
            return 0

        def complete(self):
            return self.q.pop(0)

    qp = V.QueuePair(ErrBearer())
    qp.post_send([V.send_wr(7)])
    comp = qp.cq.poll()[0]
    assert comp.status == V.WC_REMOTE_ERROR
    assert comp.error == "boom"
    with pytest.raises(RuntimeError):
        qp.cq.poll()


def test_model_bearer_tallies_match_reference(jax_pkg, tiny):
    """The simulated NIC posts each charge slice as WR lists through the
    accounting-only bearer: its tallies equal the reference's."""
    from repro.core import cost_model as RCM

    from repro_torch.pool import SimulatedRDMAPool
    rstore, store = _stores(tiny)
    sp = SimulatedRDMAPool(store, device="cpu", fabric=RDMA_100G)
    rp = jax_pkg.SimulatedRDMAPool(rstore)
    for pool, led in ((sp, NetLedger(RDMA_100G)),
                      (rp, RCM.NetLedger(RCM.RDMA_100G))):
        pool.read_spans(np.arange(8), ledger=led, doorbell=3)
        pool.post_row_reads([(p, 3) for p in range(6)], ledger=led,
                            doorbell=2)
    qp = sp.snapshot()["qp"]
    assert qp == rp.snapshot()["qp"]
    assert qp["doorbells"] > 0 and qp["descriptors"] >= qp["doorbells"]


# ------------------------------------------------------- 1/N staging

@pytest.mark.parametrize("n", [1, 2, 4])
def test_staged_device_bytes_scale_inverse_with_shards(jax_pkg, tiny, n):
    """Each child stages only its owned groups, block-compacted: staged
    blocks partition the region, and per-shard device bytes are the
    compacted blocks plus the meta table — the reference's tallies."""
    rstore, store = _stores(tiny)
    spec = store.spec
    sp = ShardedPool(store, [_local] * n, device="cpu")
    rp = jax_pkg.ShardedPool(rstore, [jax_pkg.LocalPool] * n)
    stg = sp.snapshot()["staging"]
    assert stg == rp.snapshot()["staging"]
    assert sum(stg["blocks_staged_by_shard"]) == spec.n_blocks
    cap = -(-spec.n_groups // n) * spec.group_blocks
    assert max(stg["blocks_staged_by_shard"]) <= cap
    blk_bytes = (spec.gblk + spec.vblk) * 4
    for staged, dev in zip(stg["blocks_staged_by_shard"],
                           stg["device_bytes_by_shard"]):
        assert dev == staged * blk_bytes + store.meta_table.nbytes
    for c in sp.children:
        held = sum(t.numel() * t.element_size()
                   for t in (c._g_dev, c._v_dev, c._mt_dev))
        assert held == c.staging["device_bytes"]


def test_compacted_reads_bit_identical_to_full(jax_pkg, tiny):
    """The indirection is invisible: span and row reads off a compacted
    LocalPool (half the groups) and off a 2-shard pool equal the fully
    staged pool's, dead lanes and ledger charges included."""
    _, s0 = _stores(tiny)
    _, s1 = _stores(tiny)
    _, s2 = _stores(tiny)
    spec = s0.spec
    lp = _local(s0)
    half = list(range(spec.n_groups // 2))
    cp = LocalPool(s1, device="cpu", owned_groups=half)
    assert cp.staging["compacted"]
    mt = s0.meta_table
    owned = np.array([p for p in range(spec.n_partitions)
                      if int(mt[p, MT_GROUP]) in half])
    led_l, led_c = NetLedger(RDMA_100G), NetLedger(RDMA_100G)
    for a, b in zip(lp.read_spans(owned, ledger=led_l, doorbell=4),
                    cp.read_spans(owned, ledger=led_c, doorbell=4)):
        assert torch.equal(a, b)
    assert led_l.as_dict() == led_c.as_dict()
    sp = ShardedPool(s2, [_local] * 2, device="cpu")
    assert all(c.staging["compacted"] for c in sp.children)
    pids = np.arange(spec.n_partitions)
    for a, b in zip(lp.read_spans(pids, ledger=None, doorbell=4),
                    sp.read_spans(pids, ledger=None, doorbell=4)):
        assert torch.equal(a, b)
    rows = torch.as_tensor(np.array([[0, 65, 130], [200, -1, 7]], np.int32))
    assert torch.equal(lp.read_rows(rows), sp.read_rows(rows))
    rstore, _ = _stores(tiny)
    rp = jax_pkg.ShardedPool(rstore, [jax_pkg.LocalPool] * 2)
    for a, b in zip(sp.read_spans(pids, ledger=None, doorbell=4),
                    rp.read_spans(pids, ledger=None, doorbell=4)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_migration_restages_only_moved_blocks(jax_pkg, tiny):
    """Moving one group's serving replica stages exactly that group's
    blocks on the destination, as the reference's migration does."""
    rstore, store = _stores(tiny)
    gb = store.spec.group_blocks
    sp = ShardedPool(store, [_local] * 2, device="cpu")
    rp = jax_pkg.ShardedPool(rstore, [jax_pkg.LocalPool] * 2)
    c0, c1 = sp.children
    assert c0.staging["restaged_blocks"] == c1.staging["restaged_blocks"] == 0
    g = int(np.nonzero(sp._serve == 0)[0][0])
    pre1 = c1.staging["blocks_staged"]
    sp._migrate(g, 0, 1)
    rp._migrate(g, 0, 1)
    assert sp.owner_of_group(g) == 1
    assert c1.staging["restaged_blocks"] == gb
    assert c1.staging["blocks_staged"] == pre1 + gb
    assert c0.staging["restaged_blocks"] == 0
    snap, rsnap = sp.snapshot(), rp.snapshot()
    for key in ("staging", "migration", "groups_by_shard"):
        assert snap[key] == rsnap[key], key
    lp = _local(_stores(tiny)[1])
    pids = np.arange(store.spec.n_partitions)
    for x, y, z in zip(lp.read_spans(pids, ledger=None),
                       sp.read_spans(pids, ledger=None),
                       rp.read_spans(pids, ledger=None)):
        assert torch.equal(x, y) and np.array_equal(y.numpy(), np.asarray(z))


def test_failover_restages_only_dead_shards_groups(jax_pkg, tiny):
    """Healing a death re-stages only the dead shard's groups onto the
    survivors (group-granular adoption), in the reference's order: equal
    replica maps, failover counters and re-staged block counts."""
    rstore, store = _stores(tiny)
    spec = store.spec
    sp = ShardedPool(store, [_local] * 3, device="cpu", replication=2)
    rp = jax_pkg.ShardedPool(rstore, [jax_pkg.LocalPool] * 3, replication=2)
    held0 = sum(1 for row in sp._replicas if (row == 0).any())
    assert held0 > 0
    sp._on_shard_down(0)
    rp._on_shard_down(0)
    survivors = sp.children[1:]
    restaged = sum(c.staging["restaged_blocks"] for c in survivors)
    assert restaged == sp.failover["rereplicated_groups"] * spec.group_blocks
    assert sp.failover["rereplicated_groups"] <= held0
    for s, c in enumerate(sp.children[1:], start=1):
        assert c.staging["restaged_blocks"] % spec.group_blocks == 0
        held = sum(1 for row in sp._replicas if (row == s).any())
        assert c.staging["blocks_staged"] == held * spec.group_blocks
    assert np.array_equal(sp._replicas, rp._replicas)
    assert np.array_equal(sp._serve, rp._serve)
    assert sp.failover == rp.failover
    assert [c.staging for c in survivors] == [
        c.staging for c in rp.children[1:]]
    lp = _local(_stores(tiny)[1])
    pids = np.arange(spec.n_partitions)
    for x, y in zip(lp.read_spans(pids, ledger=None),
                    sp.read_spans(pids, ledger=None)):
        assert torch.equal(x, y)


# ------------------------------------------------- bearer conformance

CFG = dict(mode="full", search_mode="scan", n_rep=12, b=3, ef=32,
           cache_frac=0.25, seed=3)


@pytest.fixture(scope="module")
def built(jax_pkg, pds):
    """One index over ``pds`` built by the JAX package at ``CFG``."""
    from repro.core import DHNSWEngine as RE
    from repro.core import EngineConfig as RC
    return RE(RC(**CFG)).build(pds[0])


def _engines(built, data, pool: str, **over):
    """(reference engine, port engine) over copies of one index, on
    ``RDMA_100G``."""
    from repro.core import DHNSWEngine as RE
    from repro.core import EngineConfig as RC
    from repro.core.cost_model import RDMA_100G as RF

    from repro_torch import DHNSWEngine, EngineConfig
    over = {**CFG, **over, "pool": pool}
    ref = RE(RC(**over, fabric=RF))
    ref.client.adopt_built(copy.deepcopy(built.meta),
                           copy.deepcopy(built.store), data)
    eng = DHNSWEngine(EngineConfig(**over, fabric=RDMA_100G), device="cpu")
    eng.client.adopt_built(*convert.state_from_numpy(
        *convert.numpy_state(built.meta, built.store)), data)
    return ref, eng


def _search_identical(e0, e1, queries):
    d0, g0, st0 = e0.search(queries, k=10)
    d1, g1, st1 = e1.search(queries, k=10)
    assert np.array_equal(g0, g1) and np.array_equal(d0, d1)
    assert st0["net"] == st1["net"]
    return d1, g1, st1


def _port_vs_ref(ref_out, port_out):
    (dr, gr, sr), (dt, gt, st) = ref_out, port_out
    assert np.array_equal(gt, gr)
    np.testing.assert_allclose(dt, dr, rtol=1e-5, atol=1e-4)
    assert st["net"] == sr["net"]


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("bearer", ["loopback", "tcp"])
def test_bearer_conformance_bit_identical(built, pds, servers, time_limit,
                                          bearer, quant):
    """The QP path over either bearer: search + insert bit-identical to
    LocalPool, ledger parity, measured wire bytes == the model for every
    read verb (append frames carry the 8-byte partition address beyond
    it); against the reference's remote engine, results, ``net`` and the
    measured wire of every verb agree."""
    data, queries = pds
    _, e0 = _engines(built, data, "local", quant=quant)
    eps = {n: ((servers[n][0],) if bearer == "tcp" else None)
           for n in servers}
    ref, _ = _engines(built, data, "remote", quant=quant, bearer=bearer,
                      endpoints=eps["repro"])
    _, e1 = _engines(built, data, "remote", quant=quant, bearer=bearer,
                     endpoints=eps["repro_torch"])
    _port_vs_ref(ref.search(queries, k=10),
                 _search_identical(e0, e1, queries))
    new = queries[:2] + 0.001
    gids = [e.insert(new) for e in (e0, e1, ref)]
    assert np.array_equal(gids[0], gids[1]) and np.array_equal(gids[1],
                                                               gids[2])
    _port_vs_ref(ref.search(queries[:8], k=10),
                 _search_identical(e0, e1, queries[:8]))
    snap, rsnap = e1.pool.snapshot(), ref.pool.snapshot()
    assert snap["bearer"] == bearer
    wvm = snap["wire_vs_model"]
    assert wvm and wvm == rsnap["wire_vs_model"]
    for verb, row in wvm.items():
        if verb.startswith("read"):
            assert row["measured"] == row["modeled"], (verb, row)
        elif verb == "append":
            assert row["modeled"] <= row["measured"] < 1.05 * row["modeled"]
    for key in ("frames_tx", "frames_rx", "bytes_tx", "bytes_rx",
                "payload_by_verb", "model_by_verb", "frames_by_verb"):
        assert snap["wire"][key] == rsnap["wire"][key], key
    assert snap["verbs"] == rsnap["verbs"]
    assert snap["totals"] == rsnap["totals"]


def test_sharded_over_loopback_regions_bit_identical(built, pds):
    """Two RemotePool children, each over its own in-process HostRegion:
    the sharded fan-out through the QP path stays bit-identical, and every
    child's wire equals the reference's."""
    data, queries = pds
    _, e0 = _engines(built, data, "local")
    ref, e1 = _engines(built, data, "sharded", shard_transport="remote",
                       bearer="loopback", n_shards=2)
    _port_vs_ref(ref.search(queries, k=10),
                 _search_identical(e0, e1, queries))
    snap, rsnap = e1.pool.snapshot(), ref.pool.snapshot()
    assert all(s["bearer"] == "loopback" for s in snap["shards"])
    assert snap["wire_total"]["frames_tx"] > 0
    assert snap["wire_total"] == rsnap["wire_total"]


def test_loopback_raw_verbs_match_local_with_doorbell_frames(jax_pkg, tiny,
                                                             pds):
    """One WR-list post per doorbell batch — 5 spans at doorbell=2 cost
    exactly 3 frames == the ledger's round trips — and every verb result
    and charge matches LocalPool's and the reference remote pool's."""
    from repro.core.cost_model import NetLedger as RLed
    from repro.core.cost_model import RDMA_100G as RF
    from repro.net import RemotePool as RRemote

    from repro_torch.net import RemotePool
    data, _ = pds
    rstore, s0 = _stores(tiny)
    _, s1 = _stores(tiny)
    lp = _local(s0)
    rp = RemotePool(s1, None, device="cpu", bearer="loopback")
    jp = RRemote(rstore, None, bearer="loopback")
    led_l, led_r, led_j = NetLedger(RDMA_100G), NetLedger(RDMA_100G), \
        RLed(RF)
    pids = np.array([0, 2, 3, 5, 6])
    f0 = rp.wire["frames_tx"]
    a = lp.read_spans(pids, ledger=led_l, doorbell=2)
    b = rp.read_spans(pids, ledger=led_r, doorbell=2)
    c = jp.read_spans(pids, ledger=led_j, doorbell=2)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and np.array_equal(_np(y), _np(z))
    assert rp.wire["frames_tx"] - f0 == 3 == led_r.round_trips
    assert led_l.as_dict() == led_r.as_dict() == led_j.as_dict()
    rows = np.array([[0, 5, 9], [2, -1, 7]], np.int32)
    got = rp.read_rows(torch.as_tensor(rows))
    assert torch.equal(lp.read_rows(torch.as_tensor(rows)), got)
    assert np.array_equal(_np(got), _np(jp.read_rows(rows)))
    vec = data[0] + 0.5
    slots = [p.append(vec, 9999, 1, ledger=led)
             for p, led in ((lp, led_l), (rp, led_r), (jp, led_j))]
    assert slots[0] == slots[1] == slots[2] >= 0
    for st in (s1, rstore):
        assert np.array_equal(s0.vec_buf, st.vec_buf)
        assert np.array_equal(s0.meta_table, st.meta_table)
    assert led_l.as_dict() == led_r.as_dict() == led_j.as_dict()
    assert rp.wire["frames_by_verb"] == jp.wire["frames_by_verb"]
    rp.close()
    jp.close()


def test_loopback_server_error_drains_and_surfaces(tiny):
    """A bad descriptor raises a clean RuntimeError; the bearer stays
    usable (completions were drained, not abandoned)."""
    from repro_torch.net import RemotePool
    rp = RemotePool(_stores(tiny)[1], None, device="cpu", bearer="loopback")
    with pytest.raises(RuntimeError, match="pool server error"):
        rp.read_spans(np.array([0, 999]), ledger=None)
    g, v = rp.read_spans(np.array([1]), ledger=None)
    assert v.shape[0] == 1 and v.dtype == torch.float32
    assert g.dtype == torch.int32
    rp.close()


# ------------------------------------------------- report and injector

def test_report_names_dominant_stage(tmp_path, capsys):
    """The port's report CLI over a port trace names the dominant stage
    and the batched-vs-serial gap, printing what the reference's CLI
    prints for the same trace file."""
    pytest.importorskip("jax")
    from repro.obs import report as RR
    tr = Tracer()
    tr.configure(trace_id=7)
    for phase, slow in (("serial", 0.010), ("batched", 0.002)):
        tr.set_phase(phase)
        with tr.span(report.REQUEST_SPAN, tier="bench"):
            tr.add("stage.slow", "compute", 0.0, slow)
            tr.add("stage.fast", "compute", 0.0, 0.001)
    path = tmp_path / "t.json"
    tr.save(path)
    assert report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "dominant stage" in out
    assert "batched-vs-serial gap" in out
    assert "stage.slow" in out
    assert RR.main([str(path)]) == 0
    assert capsys.readouterr().out == out


def test_wr_injector_deterministic_schedule():
    from repro.rdma.inject import WRInjector as RI
    a = WRInjector(seed=7, delay_s=1e-4, spike_s=1e-3, spike_every=5)
    b = WRInjector(seed=7, delay_s=1e-4, spike_s=1e-3, spike_every=5)
    r = RI(seed=7, delay_s=1e-4, spike_s=1e-3, spike_every=5)
    for _ in range(20):
        a.on_post([None])
        b.on_post([None])
        r.on_post([None])
    assert a.snapshot() == b.snapshot() == r.snapshot()
    assert a.posts == 20 and a.injections == 20
    assert a.injected_s == pytest.approx(20 * 1e-4 + 4 * 1e-3)
    c = WRInjector(seed=8, spike_s=1e-3, spike_every=5)
    for _ in range(20):
        c.on_post([None])
    assert c.injections == 4
    assert c.injected_s == pytest.approx(4e-3)


def test_wr_injector_error_is_connection_error():
    from repro_torch.pool.protocol import PoolUnavailableError
    e = WRInjector(seed=0, error_every=1)
    with pytest.raises(InjectedFault):
        e.on_post([None])
    assert e.faults == 1
    assert e.injected_s == 0.0
    assert issubclass(InjectedFault, ConnectionError)
    assert issubclass(PoolUnavailableError, ConnectionError)


def test_net_exposes_only_the_wire():
    """``repro_torch.net`` carries the wire framing the verbs layer needs
    and the remote transport built on it, the reference's names; the
    verbs layer frames WR lists through that one wire module."""
    pytest.importorskip("jax")
    import repro.net as RN

    import repro_torch.net as N
    assert set(N.__all__) == set(RN.__all__) | {"wire"}
    for name in ("RemotePool", "PoolServer", "HostRegion",
                 "spawn_pool_servers", "PoolUnavailableError"):
        assert getattr(N, name).__module__.startswith("repro_torch.")
    assert N.wire is W
    assert W.OP_READ_SPANS == V.wr_frame(
        [V.read_wr(V.RKEY_SPANS, 0, 8)])[0]
