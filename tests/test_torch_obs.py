"""The port's tracing and metrics over the remote transport, on the CPU:
twins of ``tests/test_obs.py``'s remote cases.

Against an in-process ``PoolServer`` (the port's copy, its verbs served
by threads of this process) or a loopback ``HostRegion``: the client
negotiates FLAG_TRACE at PING, stamps verb frames with trace context and
harvests the server's service-time spans under the matching client
``net.*`` span; a server that never acked the flag is never sent trace
bytes; tracing on or off leaves results and the ``NetLedger`` bit for bit
unchanged; ``SearchServer.dump_trace`` harvests remote spans; the server's
service histograms render as Prometheus text.  Where the reference's run
is deterministic (the verbs a search issues, the spans a harvest adopts),
the port's equals it on the same index.
"""
import copy
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig, convert  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G  # noqa: E402
from repro_torch.net.server import PoolServer  # noqa: E402
from repro_torch.obs.metrics import render_pool_server  # noqa: E402
from repro_torch.obs.trace import TRACER, load_trace  # noqa: E402
from repro_torch.serve.batcher import BatchPolicy  # noqa: E402
from repro_torch.serve.server import SearchServer  # noqa: E402

CFG = dict(mode="full", search_mode="scan", n_rep=12, b=3, ef=32,
           cache_frac=0.25, seed=3)


class Overtime(BaseException):
    """A test ran past its time limit (not an ``OSError``: no transport
    may swallow it)."""


@pytest.fixture(autouse=True)
def _guard():
    """Every test leaves the tracers disabled and ends within 120 s."""
    def boom(*_):
        raise Overtime("test ran past 120 s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    TRACER.disable()


@pytest.fixture(scope="module")
def pds(sift_small):
    return sift_small.data[:1200], sift_small.queries[:16]


@pytest.fixture(scope="module")
def built(pds):
    """One index over ``pds`` built by the JAX package at ``CFG``."""
    pytest.importorskip("jax")
    from repro.core import DHNSWEngine as RE
    from repro.core import EngineConfig as RC
    return RE(RC(**CFG)).build(pds[0])


@pytest.fixture()
def server():
    srv = PoolServer().start()
    yield srv
    srv.stop()


def _engine(built, data, **over):
    eng = DHNSWEngine(EngineConfig(**{**CFG, "fabric": RDMA_100G, **over}),
                      device="cpu")
    eng.client.adopt_built(*convert.state_from_numpy(
        *convert.numpy_state(built.meta, built.store)), data)
    return eng


def _ref_engine(built, data, **over):
    from repro.core import DHNSWEngine as RE
    from repro.core import EngineConfig as RC
    from repro.core.cost_model import RDMA_100G as RF
    eng = RE(RC(**{**CFG, "fabric": RF, **over}))
    eng.client.adopt_built(copy.deepcopy(built.meta),
                           copy.deepcopy(built.store), data)
    return eng


def _by_id(spans):
    return {s["id"]: s for s in spans}


def test_trace_flag_roundtrip_loopback(built, pds, server):
    """FLAG_TRACE is acked at PING; harvested server spans sit under the
    client ``net.<verb>`` span that carried their context, inside it on
    the client clock; a second harvest sees only the first's own STATS
    drain.  The harvested verbs equal the reference's on the same index."""
    data, queries = pds
    TRACER.configure(trace_id=21)
    eng = _engine(built, data, pool="remote", endpoints=(server.endpoint,))
    eng.search(queries[:4], k=5)
    pool = eng.pool
    assert pool._server_trace is True
    n = pool.harvest_trace()
    assert n > 0
    spans = TRACER.snapshot()
    idx = _by_id(spans)
    server_spans = [s for s in spans if s["tier"] == "server"]
    assert len(server_spans) == n
    for s in server_spans:
        parent = idx[s["parent"]]
        assert parent["tier"] == "net"
        assert parent["name"] == "net." + s["name"][len("server."):]
        assert parent["dur"] >= s["dur"] - 1e-9
        assert parent["t0"] - 1e-9 <= s["t0"]
        assert s["t0"] + s["dur"] <= parent["t0"] + parent["dur"] + 1e-9
        assert s["attrs"]["clock"] == "server"
    names = sorted(s["name"] for s in server_spans)
    n_before = len(server_spans)
    pool.harvest_trace()
    fresh = [s for s in TRACER.snapshot() if s["tier"] == "server"][n_before:]
    assert all(s["name"] == "server.stats" for s in fresh)
    pool.close()
    TRACER.disable()

    from repro.net.server import PoolServer as RServer
    from repro.obs.trace import TRACER as RT
    rsrv = RServer().start()
    try:
        RT.configure(trace_id=21)
        reng = _ref_engine(built, data, pool="remote",
                           endpoints=(rsrv.endpoint,))
        reng.search(queries[:4], k=5)
        assert reng.pool.harvest_trace() == n
        assert sorted(s["name"] for s in RT.snapshot()
                      if s["tier"] == "server") == names
        reng.pool.close()
    finally:
        RT.disable()
        rsrv.stop()


def test_old_server_never_sent_trace_bytes(built, pds, server):
    """A server whose PING never acked FLAG_TRACE is never shown the
    trace prefix: results and charged bytes are those of an untraced
    run, and a harvest adopts nothing."""
    data, queries = pds
    eng = _engine(built, data, pool="remote", endpoints=(server.endpoint,))
    d0, g0, s0 = eng.search(queries[:4], k=5)
    eng.pool.close()
    TRACER.configure(trace_id=33)
    eng = _engine(built, data, pool="remote", endpoints=(server.endpoint,))
    eng.pool._server_trace = False
    d1, g1, s1 = eng.search(queries[:4], k=5)
    assert np.array_equal(d0, d1) and np.array_equal(g0, g1)
    assert s0["net"]["bytes"] == s1["net"]["bytes"]
    assert eng.pool.harvest_trace() == 0
    assert not any(s["tier"] == "server" for s in TRACER.snapshot())
    eng.pool.close()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tracing_off_vs_on_bit_identical_remote(built, pds, server, quant):
    """Tracing charges nothing on the remote transport: results and the
    ledger are bit-identical with the tracer off and on."""
    data, queries = pds
    outs = []
    for on in (False, True):
        if on:
            TRACER.configure(trace_id=11)
        else:
            TRACER.disable()
        eng = _engine(built, data, pool="remote", quant=quant,
                      endpoints=(server.endpoint,))
        d, g, st = eng.search(queries[:6], k=5)
        outs.append((d.copy(), g.copy(), dict(st["net"])))
        eng.pool.close()
    assert len(TRACER.snapshot()) > 0
    (d0, g0, n0), (d1, g1, n1) = outs
    assert np.array_equal(d0, d1) and np.array_equal(g0, g1) and n0 == n1


def test_dump_trace_harvests_remote(built, pds, server, tmp_path):
    """``SearchServer.dump_trace`` over a remote engine writes the
    server's harvested spans into the trace file."""
    data, queries = pds
    TRACER.configure(trace_id=17)
    eng = _engine(built, data, pool="remote", endpoints=(server.endpoint,))
    with SearchServer(eng, BatchPolicy(max_batch=8, max_wait_s=1e-3)) as ss:
        ss.search(queries[:2], k=5)
        path = tmp_path / "trace.json"
        n = ss.dump_trace(path)
    spans = load_trace(path)
    assert len(spans) == n
    assert any(s["tier"] == "server" for s in spans)
    eng.pool.close()


def test_pool_server_service_histograms(built, pds):
    """A loopback region's per-verb service histograms ship in
    ``server_stats`` and render as Prometheus text; the verbs and their
    counts equal the reference's on the same search."""
    data, queries = pds
    eng = _engine(built, data, pool="remote", bearer="loopback")
    eng.search(queries[:4], k=5)
    st = eng.pool.server_stats()
    assert st["service_hist"]
    for verb, series in st["service_hist"].items():
        assert series["count"] >= 1
        assert verb in st["service_s"]
    txt = render_pool_server(st)
    assert "repro_poolserver_service_seconds_bucket" in txt
    assert "repro_poolserver_service_seconds_count" in txt
    for line in txt.strip().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    reng = _ref_engine(built, data, pool="remote", bearer="loopback")
    reng.search(queries[:4], k=5)
    rst = reng.pool.server_stats()
    assert st["verbs"] == rst["verbs"]
    assert {v: s["count"] for v, s in st["service_hist"].items()} == {
        v: s["count"] for v, s in rst["service_hist"].items()}
    assert (st["payload_rx"], st["payload_tx"]) == (rst["payload_rx"],
                                                    rst["payload_tx"])
    eng.pool.close()
    reng.pool.close()
