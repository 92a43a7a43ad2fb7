"""The port's verbs layer, 1/N compacted staging and WR injector on the
CPU: twins of ``tests/test_rdma.py`` (verbs units, 1/N staging) and of
``tests/test_obs.py``'s report CLI and WR-injector tests.

``repro_torch.rdma`` and ``repro_torch.net.wire`` are copies of the
reference's (``tests/test_torch_serve.py`` holds their text to the
originals); here they must also behave as the originals on the same
inputs: the same frames, MR geometry, completions and injection
schedules.  The staging twins run the port's sharded pool and the
reference's on the same store and compare every child's staging tallies
and the data they serve.
"""
import copy

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
    """``repro_torch.net`` carries the wire framing the verbs layer needs;
    the remote transport is not ported, and nothing stands in for it."""
    import repro_torch.net as N
    assert N.__all__ == ["wire"]
    for name in ("RemotePool", "PoolServer", "spawn_pool_servers"):
        assert not hasattr(N, name)
    assert W.OP_READ_SPANS == V.wr_frame(
        [V.read_wr(V.RKEY_SPANS, 0, 8)])[0]
