"""The port's search counted from inside, on the CPU: the tracer's counters
and timed waits (``TRACER.count`` / ``TRACER.wait``), their roll-up into
``compute.search`` and its ``stats``, and the device spans of the kernels.

Four contracts:

* **tracing is free** — with the tracer off or on, a search through the
  local pool returns bit-identical answers, ``stats["net"]`` and plan
  counts, for the graph walk, the scan, and both int8 stage 1s; with it
  off the counters are absent from ``stats``.
* **counted where the work happens** — ``walk_steps`` / ``route_steps``
  equal the loop iterations counted independently, every blocking upload
  and readback of a round is a counted host sync, and no ``.item()``,
  ``.cpu()``, ``bool()``, ``synchronize`` or upload of host data runs
  outside a ``TRACER.wait`` (a sync point that is not wrapped fails here).
* **the fetch's real bytes** — the exact ``compute.fetch`` span's
  ``row_bytes`` equal the rows the fetched partitions hold, counted from
  the region's graph blocks.
* **device spans** — a kernel span never synchronizes: on the card it
  closes before its work finishes and ``snapshot`` resolves its CUDA
  events into ``device_s`` (``gpu``); on the CPU it has no ``device_s``.
"""
import contextlib
import copy
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core import layout as LA  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.data.synthetic import clustered  # noqa: E402
from repro_torch.obs.trace import TRACER, Tracer, load_trace  # noqa: E402

BASE = dict(mode="full", n_rep=16, ef=32, seed=3)
PATHS = {
    "graph": dict(search_mode="graph", b=4, cache_frac=0.25),
    "scan": dict(search_mode="scan", b=4, cache_frac=0.25),
    "int8_flat": dict(search_mode="scan", b=6, quant="int8",
                      quant_kernel="auto", cache_frac=0.6, exact_frac=0.25,
                      doorbell=16),
    "int8_pairs": dict(search_mode="graph", b=6, quant="int8",
                       quant_kernel="off", cache_frac=0.25, exact_frac=0.25,
                       doorbell=16),
}
SPIN_CYCLES = 100_000_000            # ~60 ms of an H100's clock
COUNTERS = ("walk_steps", "host_syncs", "sync_wait_s")
PLAN_KEYS = ("n_rounds", "n_pairs", "cache_hits", "n_fetches",
             "rerank_rows", "rerank_hit_rows", "exact_admitted")


@pytest.fixture(autouse=True)
def _off():
    yield
    TRACER.disable()


@pytest.fixture(scope="module")
def index():
    """One small index built by the port on the CPU: (dataset, meta,
    store)."""
    ds = clustered(1500, 32, 24, seed=5)
    eng = DHNSWEngine(EngineConfig(**BASE, **PATHS["graph"]),
                      device="cpu").build(ds.data)
    return ds, eng.meta, eng.store


def _engine(index, path, **over):
    ds, meta, store = index
    eng = DHNSWEngine(EngineConfig(**{**BASE, **PATHS[path], **over}),
                      device="cpu")
    eng.adopt_built(copy.deepcopy(meta), copy.deepcopy(store), ds.data)
    return eng


def _batches(eng, queries):
    """Two batches: the second one meets the first one's cache."""
    return [eng.search(queries[:12], k=5), eng.search(queries[12:], k=5)]


# ------------------------------------------------------------ the tracer

def test_counts_roll_up_into_the_enclosing_spans():
    tr = Tracer().configure(trace_id=3)
    with tr.span("root") as root:
        tr.count("steps", 2)
        with tr.span("child"):
            tr.count("steps")
            with tr.wait("site"):
                pass
            with tr.span("leaf"):
                tr.count("other", 5)
        assert root.counts["steps"] == 3 and root.counts["other"] == 5
        assert root.counts["host_syncs"] == 1
        assert root.counts["host_syncs.site"] == 1
    by = {s["name"]: s["attrs"] for s in tr.snapshot()}
    assert by["leaf"] == {"other": 5}
    assert by["child"]["steps"] == 1 and by["child"]["other"] == 5
    assert by["child"]["sync_wait_s"] == by["child"]["sync_wait_s.site"] >= 0
    assert by["root"]["steps"] == 3 and by["root"]["host_syncs"] == 1
    tr.count("dropped")                    # no open span: nothing to add to
    assert len(tr.snapshot()) == 3


def test_disabled_counters_are_one_shared_noop():
    tr = Tracer()
    assert tr.wait("a") is tr.wait("b") is tr.span("x")
    assert tr.device_span("k", torch.device("cpu")) is tr.span("x")
    with tr.wait("a"):
        tr.count("n")
    assert tr.snapshot() == []


def test_clock_offset_is_recorded_and_saved(tmp_path):
    TRACER.configure(trace_id=9)
    now = time.time_ns() - time.perf_counter_ns()
    assert abs(TRACER.clock_offset_ns - now) < 50_000_000
    with TRACER.span("a", tier="t"):
        pass
    path = tmp_path / "trace.json"
    assert TRACER.save(str(path)) == 1
    blob = json.loads(path.read_text())
    assert blob["otherData"]["clock_offset_ns"] == TRACER.clock_offset_ns
    assert [s["name"] for s in load_trace(str(path))] == ["a"]


@pytest.mark.parametrize("kernel", ["quant_topk", "distance_topk",
                                    "decode_attention"])
def test_kernel_spans_carry_no_device_time_on_the_cpu(kernel):
    TRACER.configure()
    _run_kernel(kernel, torch.device("cpu"))()
    spans = [s for s in TRACER.snapshot() if s["name"] == "kernel." + kernel]
    assert len(spans) == 1 and spans[0]["attrs"]["impl"] == "ref"
    assert "device_s" not in spans[0]["attrs"]


class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU: passed once the
    test says the device got there, or once something waits on it."""

    passed = False
    waits = 0

    def record(self, stream=None):
        self.done = _FakeEvent.passed

    def query(self):
        return self.done

    def synchronize(self):
        _FakeEvent.waits += 1 - self.done
        self.done = True

    def elapsed_time(self, end):
        return 2.5


def test_snapshot_never_waits_for_the_device(monkeypatch, tmp_path):
    """``snapshot()`` resolves the device spans the device has passed and
    leaves the rest pending without waiting (a metrics scrape does not
    block on the card); ``save()`` waits and resolves them all."""
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _FakeEvent())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_FakeEvent, "waits", 0)
    dev = torch.device("cuda")
    TRACER.configure()
    for passed in (True, False):
        monkeypatch.setattr(_FakeEvent, "passed", passed)
        with TRACER.device_span("kernel.k", dev, tier="kernel"):
            pass
    first, second = TRACER.snapshot()
    assert first["attrs"]["device_s"] == 2.5e-3
    assert "device_s" not in second["attrs"] and _FakeEvent.waits == 0
    assert TRACER.save(str(tmp_path / "t.json")) == 2
    assert second["attrs"]["device_s"] == 2.5e-3 and _FakeEvent.waits == 1
    got = load_trace(str(tmp_path / "t.json"))
    assert [s["attrs"]["device_s"] for s in got] == [2.5e-3, 2.5e-3]


def test_device_time_report_reads_the_kernel_spans(tmp_path, capsys):
    """``python -m repro_torch.obs.device_time`` puts the kernel spans'
    ``device_s`` beside their host ``dur``, so a kernel A/B reads the
    card's time; a trace without ``device_s`` gets no table."""
    from repro_torch.obs import device_time
    tr = Tracer().configure(trace_id=4)
    for dev_s in (0.004, 0.006):
        tr.add("kernel.quant_topk", "kernel", 0.0, 0.0001, impl="cuda",
               device_s=dev_s)
    tr.add("compute.search", "compute", 0.0, 0.02)
    spans = tr.snapshot()
    assert device_time.device_table(spans) == [
        ("kernel", "kernel.quant_topk", 2, pytest.approx(0.0002),
         pytest.approx(0.010))]
    path = tmp_path / "t.json"
    tr.save(str(path))
    assert device_time.main([str(path)]) == 0
    row = [ln.split() for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("kernel")]
    assert row == [["kernel", "kernel.quant_topk", "2", "0.200", "10.000",
                    "5000.0"]]
    plain = [s for s in spans if s["name"] == "compute.search"]
    assert device_time.render(plain) == ""


@pytest.mark.parametrize("turn", ["on", "off"])
def test_tracer_switched_during_a_search(index, monkeypatch, turn):
    """Another thread may switch the tracer while a search runs (an
    operator enabling tracing on a live server): the search still
    returns the untraced answers, and its ``stats`` hold counters only
    where ``compute.search`` itself was traced: those counted before the
    switch (the queries' upload), none of the walk after it."""
    queries = index[0].queries[:12]
    want = _engine(index, "graph").search(queries, k=5)
    eng = _engine(index, "graph")
    route = eng.client._route

    def switched(*a, **kw):
        if turn == "on":
            TRACER.configure()
        else:
            TRACER.disable()
        return route(*a, **kw)

    monkeypatch.setattr(eng.client, "_route", switched)
    if turn == "off":
        TRACER.configure()
    d, g, st = eng.search(queries, k=5)
    assert np.array_equal(d, want[0]) and np.array_equal(g, want[1])
    assert st["net"] == want[2]["net"]
    if turn == "on":
        assert not any(k in st for k in COUNTERS)
    else:
        assert st["host_syncs"] == st["host_syncs.upload"] == 1
        assert "walk_steps" not in st and "route_steps" not in st


# ------------------------------------------------------- tracing is free

@pytest.mark.parametrize("path", sorted(PATHS))
def test_tracing_off_vs_on_bit_identical_local(index, path):
    """Answers, the ledger and the plan counts are bit-identical with the
    tracer off and on; the counters appear in ``stats`` only when on."""
    queries = index[0].queries
    runs = []
    for on in (False, True):
        if on:
            TRACER.configure(trace_id=5)
        else:
            TRACER.disable()
        runs.append(_batches(_engine(index, path), queries))
    for (d0, g0, s0), (d1, g1, s1) in zip(*runs):
        assert np.array_equal(d0, d1) and np.array_equal(g0, g1)
        assert s0["net"] == s1["net"]
        assert {k: s0.get(k) for k in PLAN_KEYS} == {
            k: s1.get(k) for k in PLAN_KEYS}
        assert not any(k in s0 for k in COUNTERS)
        assert s1["host_syncs"] > 0 and s1["sync_wait_s"] >= 0
        if path in ("graph", "int8_pairs"):
            assert s1["walk_steps"] > 0 and s1["route_steps"] > 0
        if path == "int8_flat":
            assert "walk_steps" not in s1 and "route_steps" not in s1


# ----------------------------------------------------- where work happens

def _count_calls(monkeypatch, fn_owner, name):
    calls = [0]
    fn = getattr(fn_owner, name)

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(fn_owner, name, counted)
    return calls


@pytest.mark.parametrize("max_iters", [None, 3])
def test_walk_steps_equal_the_loop_iterations(index, monkeypatch, max_iters):
    """A beam walk at layer 0 reads one neighbour row a step: its
    ``walk_steps`` equal those reads, and its syncs the steps plus the
    check that ended the loop (none when ``max_iters`` ended it)."""
    ds, meta, _ = index
    g = meta.graph
    vecs = torch.as_tensor(g.vectors, dtype=torch.float32)
    adj = torch.as_tensor(g.adjacency, dtype=torch.int32)
    q = torch.as_tensor(ds.queries[:8])
    reads = _count_calls(monkeypatch, S, "_neighbours")
    TRACER.configure()
    with TRACER.span("walk") as sp:
        S.batched_beam_search(vecs, adj, q, int(g.entry), ef=16,
                              n_levels=1, max_iters=max_iters)
    steps = sp.counts["walk_steps"]
    assert steps == reads[0] > 0
    assert sp.counts["host_syncs.walk"] == steps + (max_iters is None)
    if max_iters is not None:
        assert steps == max_iters
    assert "route_steps" not in sp.counts


def test_route_steps_count_descent_hops_and_beam_steps(index, monkeypatch):
    ds, meta, _ = index
    g = meta.graph
    vecs = torch.as_tensor(g.vectors, dtype=torch.float32)
    adj = torch.as_tensor(g.adjacency, dtype=torch.int32)
    reads = _count_calls(monkeypatch, S, "_neighbours")
    TRACER.configure()
    with TRACER.span("route") as sp:
        S.meta_route(vecs, adj, torch.as_tensor(ds.queries[:8]),
                     int(g.entry), b=3, n_levels=g.n_levels)
    assert sp.counts["route_steps"] == reads[0] > 0
    # one check ends each descent layer and the beam walk
    assert sp.counts["host_syncs.route"] == reads[0] + g.n_levels
    assert "walk_steps" not in sp.counts


def test_host_syncs_cover_every_upload_and_readback(index):
    """Exact graph path on the local pool: one upload of the queries, two
    a fetch (block ids, cache slots), five a serve round (its pair
    tensors), and three readbacks (route ids, distances, ids)."""
    eng = _engine(index, "graph")
    TRACER.configure()
    for d, g, st in _batches(eng, index[0].queries):
        pass
    spans = TRACER.snapshot()
    roots = [s for s in spans if s["name"] == "compute.search"]
    last = roots[-1]
    mine = _tree(spans, last["id"])
    n_fetch = sum(s["name"] == "compute.fetch" for s in mine)
    n_serve = sum(s["name"] == "compute.serve" for s in mine)
    assert st["n_rounds"] >= n_serve >= 1
    assert st["host_syncs.upload"] == 1 + 2 * n_fetch + 5 * n_serve
    assert st["host_syncs.readback"] == 3
    assert st["host_syncs"] == sum(v for k, v in st.items()
                                   if k.startswith("host_syncs."))
    assert st["host_syncs"] >= (st["host_syncs.upload"]
                                + st["host_syncs.readback"])
    assert st["sync_wait_s"] == pytest.approx(sum(
        v for k, v in st.items() if k.startswith("sync_wait_s.")))
    # the root span holds the totals it copied into stats
    assert {k: last["attrs"][k] for k in COUNTERS} == {
        k: st[k] for k in COUNTERS}
    # the serve round's work under its own spans
    serve = [s for s in mine if s["name"] == "compute.serve"][0]
    kids = {s["name"] for s in spans if s["parent"] == serve["id"]}
    assert kids == {"compute.serve.decode", "compute.serve.walk",
                    "compute.serve.merge"}
    assert serve["attrs"]["walk_steps"] > 0


def test_rerank_plan_split_into_its_parts(index):
    eng = _engine(index, "int8_flat")
    TRACER.configure()
    _batches(eng, index[0].queries)
    spans = TRACER.snapshot()
    plans = [s for s in spans if s["name"] == "compute.rerank_plan"]
    assert len(plans) == 2 and all("admitted" in s["attrs"] for s in plans)
    for plan in plans:
        kids = [s["name"] for s in spans if s["parent"] == plan["id"]]
        assert kids == ["compute.rerank_plan.readback",
                        "compute.rerank_plan.dedup",
                        "compute.rerank_plan.charge",
                        "compute.rerank_plan.admit"]
        assert plan["attrs"]["host_syncs.readback"] == 1


def _tree(spans, root_id):
    """Every span under ``root_id``."""
    below, ids = [], {root_id}
    for s in sorted(spans, key=lambda s: s["id"]):
        if s["parent"] in ids:
            ids.add(s["id"])
            below.append(s)
    return below


@contextlib.contextmanager
def _sync_watch(monkeypatch):
    """Patch every way the host can wait for the card to note whether it
    ran inside a ``TRACER.wait``; yields (names run outside one, calls run
    inside one, waits opened)."""
    depth, out_of, inside, waits = [0], [], [0], [0]
    wait = TRACER.wait

    @contextlib.contextmanager
    def watched(site):
        waits[0] += 1
        depth[0] += 1
        try:
            with wait(site):
                yield
        finally:
            depth[0] -= 1

    with monkeypatch.context() as m:
        def patch(owner, name, host_data=False):
            fn = getattr(owner, name)

            def noted(*a, **kw):
                if not host_data or (a and not torch.is_tensor(a[0])):
                    if depth[0]:
                        inside[0] += 1
                    else:
                        out_of.append(f"{owner.__name__}.{name}")
                return fn(*a, **kw)
            m.setattr(owner, name, noted)

        m.setattr(TRACER, "wait", watched)
        for name in ("item", "cpu", "tolist", "__bool__", "__int__",
                     "__float__"):
            patch(torch.Tensor, name)
        patch(torch.cuda, "synchronize")
        patch(torch, "as_tensor", host_data=True)
        patch(torch, "tensor", host_data=True)
        yield out_of, inside, waits


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_unwrapped_sync_on_the_search_path(index, path, monkeypatch):
    """Every readback, conversion to a Python value, synchronize and
    upload of host data a search makes runs inside a ``TRACER.wait``,
    and each wait is one counted host sync."""
    eng = _engine(index, path)
    queries = index[0].queries
    TRACER.configure()
    eng.search(queries[:12], k=5)          # the int8 flat view's cold sync
    with _sync_watch(monkeypatch) as (out_of, inside, waits):
        _, _, st = eng.search(queries[12:], k=5)
    assert out_of == []
    assert inside[0] >= waits[0] == st["host_syncs"] > 0


def test_fetch_row_bytes_equal_the_partitions_rows(index):
    """With overflow rows in use (inserts), the exact fetch spans'
    ``row_bytes`` over a batch equal the bytes of the rows the fetched
    partitions hold: base rows counted from the partition's graph block
    (graph entry and vector), the overflow rows in use in its group."""
    ds = index[0]
    eng = _engine(index, "graph")
    eng.insert(ds.queries[:6] + 0.01)
    fetched = []
    read_spans = eng.pool.read_spans

    def noted(pids, **kw):
        fetched.append(np.asarray(pids).reshape(-1).copy())
        return read_spans(pids, **kw)
    eng.pool.read_spans = noted
    TRACER.configure()
    _, _, st = eng.search(ds.queries, k=5)
    spans = TRACER.snapshot()
    got = sum(s["attrs"]["row_bytes"] for s in spans
              if s["name"] == "compute.fetch")
    store, spec = eng.store, eng.store.spec
    row = spec.dim * 4
    want = 0
    for p in np.concatenate(fetched).tolist():
        group = int(store.meta_table[p, LA.MT_GROUP])
        n_over = sum(len(LA.overflow_gids(store, q))
                     for q in (2 * group, 2 * group + 1)
                     if q < len(store.meta_table))
        want += (len(LA.partition_gids(store, p)) * ((spec.deg + 1) * 4 + row)
                 + n_over * (4 + row))
    assert st["n_fetches"] == len(np.concatenate(fetched)) > 0
    assert got == want
    # a group's two counters sit on both partners' rows
    assert int(store.meta_table[:, [LA.MT_OV_A, LA.MT_OV_B]].sum()) == 12
    wire = sum(s["attrs"]["bytes"] for s in spans
               if s["name"] == "pool.read_spans")
    assert 0 < got < wire


# ------------------------------------------------------- kernel spans

def _run_kernel(kernel, dev, big=False):
    """One call of ``kernel`` on ``dev``: small, or (``big``) a few
    milliseconds of the card's time."""
    g = torch.Generator().manual_seed(0)
    if kernel == "quant_topk":
        from repro_torch.kernels.quant_topk.ops import quant_topk
        B, N, D = (2000, 131072, 128) if big else (4, 64, 32)
        q = torch.randn(B, D, generator=g)
        codes = torch.randint(-127, 128, (N, D), generator=g,
                              dtype=torch.int8)
        scales = torch.rand(N, D // 32, generator=g)
        args = [t.to(dev) for t in (q, codes, scales)]
        return lambda: quant_topk(*args, 20, 32)
    if kernel == "distance_topk":
        from repro_torch.kernels.distance_topk.ops import distance_topk
        B, N, D = (2000, 131072, 128) if big else (4, 64, 32)
        q, x = (torch.randn(n, D, generator=g).to(dev) for n in (B, N))
        return lambda: distance_topk(q, x, 20)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    B, S_, K, G, hd = (16, 8192, 8, 4, 128) if big else (2, 16, 2, 2, 16)
    q = torch.randn(B, K * G, hd, generator=g).to(dev)
    k, v = (torch.randn(B, S_, K, hd, generator=g).to(dev)
            for _ in range(2))
    pos = torch.full((B,), S_, dtype=torch.int32).to(dev)
    return lambda: decode_attention(q, k, v, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["quant_topk", "distance_topk",
                                    "decode_attention"])
def test_kernel_span_times_the_card_without_a_synchronize(kernel,
                                                          monkeypatch):
    """Behind a spin of tens of milliseconds on the stream the kernel's
    span closes at once on the host: nothing in it waited for the card.  ``snapshot`` then
    resolves its CUDA events into ``device_s``, the kernel's own time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    call = _run_kernel(kernel, dev, big=True)
    call()                                   # build and warm the kernel
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize(dev)
    spin_s = time.perf_counter() - t0
    syncs = _count_calls(monkeypatch, torch.cuda, "synchronize")
    TRACER.configure()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    call()
    host_s = time.perf_counter() - t0
    assert syncs[0] == 0
    monkeypatch.undo()
    torch.cuda.synchronize(dev)
    waited_s = time.perf_counter() - t0
    spans = [s for s in TRACER.snapshot() if s["name"] == "kernel." + kernel]
    assert len(spans) == 1
    span = spans[0]
    assert span["attrs"]["impl"] == "cuda"
    assert span["dur"] <= host_s < 0.5 * spin_s <= waited_s
    assert 0 < span["attrs"]["device_s"] < waited_s
