"""The sub-HNSW beam walk (``kernels/beam_walk``): the wrapper against the
plain loop it replaces on the card, ``core/search.py batched_beam_search``
on the per-lane path.

On the CPU the wrapper is that plain loop, bit for bit, and launches
nothing; the tracer's deferred counts (``count_later`` / ``settle``),
which carry the kernel's step count, roll up and settle as documented;
the graph serve paths reach the walk through the wrapper.

Tests marked ``gpu`` hold the CUDA kernel against the plain loop on the
card: random per-lane graphs with -1 padding, duplicated neighbours in a
row, ids >= n (a partition's graph after an insert) and small n; ids
equal up to ties (1e-5 relative), distances within 1e-5 relative, each
lane's steps equal to the plain loop's for that lane alone; then the
serve paths on a built store and a whole engine against the same engine
on the CPU.  They decide inside the test whether a card exists and skip
here.  The file imports no JAX.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core import device_store as DS  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.data.synthetic import clustered  # noqa: E402
from repro_torch.kernels.beam_walk import ops as BW  # noqa: E402
from repro_torch.kernels.beam_walk.ref import beam_walk_ref  # noqa: E402
from repro_torch.kernels.quant_topk.ref import ids_agree_up_to_ties  # noqa: E402
from repro_torch.obs.trace import TRACER, Tracer  # noqa: E402

RTOL = 1e-5
DEG = 16
CFG = dict(mode="full", n_rep=16, ef=32, seed=3, search_mode="graph", b=4,
           cache_frac=0.25)


@pytest.fixture(autouse=True)
def _off():
    yield
    TRACER.disable()


def _graphs(seed: int, B: int, n: int, D: int, deg: int = DEG):
    """Random per-lane graphs: vectors (B, n, D), adjacency (B, n, deg)
    with -1 padding, a duplicated neighbour in every row and ids past the
    lane's n, queries (B, D), entries (B,)."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((B, n, D)).astype(np.float32)
    adj = rng.integers(0, n, (B, n, deg)).astype(np.int32)
    adj[rng.random((B, n, deg)) < 0.15] = -1
    adj[rng.random((B, n, deg)) < 0.05] = n + 2
    adj[:, :, 1] = adj[:, :, 0]
    q = rng.standard_normal((B, D)).astype(np.float32)
    entry = rng.integers(0, n, B)
    return [torch.from_numpy(a) for a in (vecs, adj, q, entry)]


def _plain_steps(vecs, adj, q, entry, ef: int, max_iters=None):
    """Each lane's beam steps in the plain loop, the lane walked alone
    (the tracer is left off)."""
    steps = []
    TRACER.configure()
    for b in range(vecs.shape[0]):
        with TRACER.span("lane") as sp:
            S.batched_beam_search(vecs[b:b + 1], adj[b:b + 1, None],
                                  q[b:b + 1], entry[b:b + 1], ef=ef,
                                  n_levels=1, max_iters=max_iters)
        steps.append(sp.counts.get("walk_steps", 0))
    TRACER.disable()
    return np.asarray(steps)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("ef,D,n", [(10, 128, 40), (48, 100, 200),
                                    (64, 37, 5)])
def test_wrapper_on_cpu_is_the_plain_loop(ef, D, n):
    """Bit-equal to ``batched_beam_search`` and no launch."""
    vecs, adj, q, entry = _graphs(ef + D, 12, n, D)
    before = BW.launches
    d, i = BW.beam_walk(vecs, adj, q, entry, ef=ef)
    d0, i0 = S.batched_beam_search(vecs, adj[:, None], q, entry, ef=ef,
                                   n_levels=1)
    assert d.dtype == torch.float32 and i.dtype == torch.long
    assert torch.equal(d, d0) and torch.equal(i, i0)
    if n < 10:                           # ids past n reach the beam
        assert (i >= n).any()
    assert BW.launches == before


@pytest.mark.parametrize("max_iters", [None, 3])
def test_wrapper_counts_on_cpu(max_iters):
    """Tracer on: the plain loop counts its steps and its syncs; nothing
    is launched, so no ``walk_launches``."""
    vecs, adj, q, entry = _graphs(7, 10, 60, 16)
    TRACER.configure()
    with TRACER.span("walk") as sp:
        BW.beam_walk(vecs, adj, q, entry, ef=16, max_iters=max_iters)
        TRACER.settle()
    steps = _plain_steps(vecs, adj, q, entry, 16, max_iters)
    assert sp.counts["walk_steps"] == steps.max() > 0
    assert sp.counts["host_syncs.walk"] == steps.max() + (max_iters is None)
    assert "walk_launches" not in sp.counts


def test_wrapper_rejects_shapes_that_disagree():
    vecs, adj, q, entry = _graphs(1, 4, 10, 8)
    with pytest.raises(ValueError):
        BW.beam_walk(vecs, adj[:, :5], q, entry, ef=8)
    with pytest.raises(ValueError):
        BW.beam_walk(vecs, adj[:, None], q, entry, ef=8)
    with pytest.raises(ValueError):
        BW.beam_walk(vecs, adj, q[:, :4], entry, ef=8)
    with pytest.raises(ValueError):
        BW.beam_walk(vecs, adj, q, entry[:3], ef=8)
    with pytest.raises(ValueError):
        BW.beam_walk(vecs, adj, q, entry, ef=0)


def test_deferred_counts_roll_up_and_settle():
    """``count_later`` rolls up with the spans, stays out of their
    ``attrs``, and lands in the counters of the span that settles it."""
    tr = Tracer().configure()
    with tr.span("root") as root:
        tr.count("walk_steps", 1)
        with tr.span("round"):
            with tr.span("walk"):
                tr.count_later("walk_steps", torch.tensor(5, dtype=torch.int32))
                tr.count("walk_launches")
            tr.count_later("walk_steps", torch.tensor(7, dtype=torch.int32))
        assert root.counts["walk_steps"] == 1 and len(root.later) == 2
        tr.settle()
        tr.settle()                        # settled counts are not re-added
        assert root.counts["walk_steps"] == 13
        assert root.counts["walk_launches"] == 1
    by = {s["name"]: s["attrs"] for s in tr.snapshot()}
    assert by["walk"] == {"walk_launches": 1}
    assert by["root"]["walk_steps"] == 13
    off = Tracer()
    with off.span("x"):
        off.count_later("walk_steps", torch.tensor(1))
        off.settle()
    assert off.snapshot() == []


@pytest.fixture(scope="module")
def built():
    """One small index built by the port on the CPU, with a few inserts
    (overflow rows in use): (dataset, meta, store)."""
    ds = clustered(1500, 32, 24, seed=5)
    eng = DHNSWEngine(EngineConfig(**CFG), device="cpu").build(ds.data)
    eng.insert(ds.data[:24] + 0.02)
    return ds, eng.meta, eng.store


def _decoded(store, device):
    """Every partition's span decoded on ``device``, with a query each."""
    pids = np.arange(store.meta_table.shape[0])
    ids = np.stack([store.span_block_ids(int(p)) for p in pids])
    g, v, mt = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (store.graph_buf[ids], store.vec_buf[ids],
                          store.meta_table[pids]))
    return DS.decode_span(store.spec, g, v, mt)


@pytest.mark.parametrize("local", [False, True])
def test_graph_serve_paths_walk_through_the_wrapper(built, monkeypatch,
                                                    local):
    """``search_decoded_graph`` and ``_local`` call the wrapper once and
    return what the plain loop gave them before."""
    ds, _, store = built
    part = _decoded(store, "cpu")
    q = torch.from_numpy(ds.queries[:part.entry.shape[0]])
    calls = []
    wrapper = BW.beam_walk

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return wrapper(*a, **kw)

    fn = DS.search_decoded_graph_local if local else DS.search_decoded_graph
    want = fn(part, q, 10, 48)
    monkeypatch.setattr(BW, "beam_walk", counted)
    got = fn(part, q, 10, 48)
    assert len(calls) == 1 and len(calls[0]) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    np_max = part.adjacency.shape[2]
    d0, i0 = S.batched_beam_search(part.vectors[:, :np_max], part.adjacency,
                                   q, part.entry, ef=48, n_levels=1)
    d1, i1 = beam_walk_ref(part.vectors[:, :np_max], part.adjacency[:, 0], q,
                           part.entry, ef=48)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("max_iters", [None, 4])
def test_smoke_reads_each_lanes_steps_from_the_plain_loop(max_iters):
    """``chip_smoke.plain_walk_counts``, which holds the kernel's per-lane
    steps on the paths, reads from one batched plain walk the steps each
    lane takes walked alone, and at least one vector row a lane."""
    cs = _chip_smoke()
    vecs, adj, q, entry = _graphs(21, 24, 200, 32)
    entry[0] = 0
    d, i, steps, rows = cs.plain_walk_counts(vecs, adj, q, entry, ef=16,
                                             max_iters=max_iters)
    d0, i0 = beam_walk_ref(vecs, adj, q, entry, ef=16, max_iters=max_iters)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    want = _plain_steps(vecs, adj, q, entry, 16, max_iters)
    np.testing.assert_array_equal(steps.numpy(), want)
    assert (rows >= 1).all() and (rows <= 200).all()


def test_smoke_walk_record_holds_a_round_against_the_plain_loop():
    """``_walk_round`` passes a launch equal to the plain loop, and
    refuses one whose lane steps differ where the walks never part at a
    tie; ``_walk_record`` has phase 4's keys."""
    cs = _chip_smoke()
    args = _graphs(22, 8, 90, 16)
    d, i, steps, _ = cs.plain_walk_counts(*args, ef=12)

    def plain(*a, ef, max_iters=None):
        return (*beam_walk_ref(*a, ef=ef, max_iters=max_iters), None)
    rec = cs._walk_round(plain, args, 12, None, (d, i, steps), timed=False)
    assert rec["ids_differ"] == 0 and rec["max_abs_err"] == 0.0
    assert rec["steps_max"] == int(steps.max()) and rec["bound_ms"] > 0
    assert rec["partings"] == []
    with pytest.raises(AssertionError, match="lane 3 .* never part"):
        cs._walk_round(plain, args, 12, None, (d, i, steps + (
            torch.arange(8) == 3)), timed=False)
    with pytest.raises(AssertionError, match="steps differ in 2 lanes"):
        cs._walk_round(plain, args, 12, None, (d, i, steps + (
            torch.arange(8) < 2)), timed=False)
    out = cs._walk_record([("path", [rec, rec]), ("gist", [rec])],
                          timed=False)
    assert set(out) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}
    assert out["name"] == "beam_walk" and out["ms"] is None
    assert out["bound_ms"] == pytest.approx(rec["bound_ms"])


def test_smoke_finds_where_two_walks_part_at_a_tie():
    """``_walk_parting`` reruns one lane step by step and names the step
    where the beams part; two rows at one distance, met in the other
    order, part there at a tie (gap 0)."""
    cs = _chip_smoke()
    vecs = torch.tensor([[[3., 3.], [1., 0.], [0., 1.], [2., 2.],
                          [0., 2.], [5., 5.]]])
    adj = torch.tensor([[[1, 2, 3], [4, 0, -1], [5, 0, -1], [0, -1, -1],
                         [1, -1, -1], [2, -1, -1]]], dtype=torch.int32)
    q, entry = torch.zeros((1, 2)), torch.zeros(1, dtype=torch.long)
    swapped = adj.clone()
    swapped[0, 0, :2] = torch.tensor([2, 1], dtype=torch.int32)

    def other_order(v, a, qq, e, *, ef, max_iters=None):
        return (*beam_walk_ref(v, swapped, qq, e, ef=ef,
                               max_iters=max_iters), None)
    step, at, gap, gap64 = cs._walk_parting(
        other_order, (vecs, adj, q, entry), 0, 4, None)
    assert step == 1 and at == [0, 1] and gap == gap64 == 0.0
    far = vecs.clone()
    far[0, 2] = torch.tensor([0., 0.5])

    def farther(v, a, qq, e, *, ef, max_iters=None):
        return (*beam_walk_ref(far, a, qq, e, ef=ef, max_iters=max_iters),
                None)
    with pytest.raises(AssertionError, match="beyond a tie"):
        cs._walk_parting(farther, (vecs, adj, q, entry), 0, 4, None)


# ------------------------------------------------------ on the card (gpu)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_walks_agree(d, i, d0, i0):
    """Kernel (d, i) against the plain (d0, i0), on the host."""
    d, i, d0, i0 = (t.cpu().numpy() for t in (d, i, d0, i0))
    ok, n = ids_agree_up_to_ties(i, i0, d0, rtol=RTOL)
    assert ok, f"{n} ids differ beyond ties"
    np.testing.assert_allclose(d, d0, rtol=RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ef", [10, 48, 64])
@pytest.mark.parametrize("D,n", [(128, 300), (960, 200), (100, 7), (37, 90),
                                 (66, 40)])
def test_beam_walk_kernel_on_card(ef, D, n):
    dev = _cuda()
    vecs, adj, q, entry = _graphs(1000 * ef + D, 48, n, D)
    max_iters = 5 if (ef, D) == (10, 37) else None
    before = BW.launches
    d, i, steps = BW.launch(vecs.to(dev), adj.to(dev), q.to(dev),
                            entry.to(dev), ef=ef, max_iters=max_iters)
    torch.cuda.synchronize()
    assert BW.launches == before + 1
    d0, i0 = beam_walk_ref(vecs, adj, q, entry, ef=ef, max_iters=max_iters)
    _assert_walks_agree(d, i, d0, i0)
    want = _plain_steps(vecs, adj, q, entry, ef, max_iters)
    np.testing.assert_array_equal(steps.cpu().numpy(), want)
    # the wrapper: the same launch, counted
    d2, i2 = BW.beam_walk(vecs.to(dev), adj.to(dev), q.to(dev),
                          entry.to(dev), ef=ef, max_iters=max_iters)
    assert BW.launches == before + 2
    assert torch.equal(d2, d) and torch.equal(i2, i)


@pytest.mark.gpu
def test_beam_walk_strided_views_on_card():
    """The serve paths' views (a lane stride past the rows walked, the
    adjacency a slice of the decoded span) read without a copy give the
    contiguous inputs' result."""
    dev = _cuda()
    vecs, adj, q, entry = _graphs(5, 32, 150, 128)
    wide = torch.zeros((32, 170, 128))
    wide[:, :150] = vecs
    span = torch.full((32, 150, DEG + 3), -1, dtype=torch.int32)
    span[:, :, :DEG] = adj
    d, i, s = BW.launch(wide.to(dev)[:, :150], span.to(dev)[:, :, :DEG],
                        q.to(dev), entry.to(dev), ef=48)
    d0, i0, s0 = BW.launch(vecs.to(dev), adj.to(dev), q.to(dev),
                           entry.to(dev), ef=48)
    assert torch.equal(d, d0) and torch.equal(i, i0) and torch.equal(s, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,D,deg,ef", [(100, 128, 65, 48),
                                        (100, 128, 16, 513),
                                        (2_000_000, 128, 16, 48)])
def test_beam_walk_refuses_shapes_on_card(n, D, deg, ef):
    """A shape past the kernel's limits (deg, ef, or a lane's shared
    memory past what the device grants a block) is refused at launch."""
    dev = _cuda()
    vecs = torch.zeros((2, n, D), device=dev)
    adj = torch.zeros((2, n, deg), dtype=torch.int32, device=dev)
    q, entry = torch.zeros((2, D), device=dev), torch.zeros(2).long().to(dev)
    before = BW.launches
    with pytest.raises(RuntimeError, match="refused the shape"):
        BW.launch(vecs, adj, q, entry, ef=ef)
    assert BW.launches == before


@pytest.mark.gpu
def test_beam_walk_counts_without_a_wait_on_card():
    """Tracer on: one ``walk_launches`` a launch and the lanes' longest
    walk as ``walk_steps``, settled after the host waited; no host sync
    of the walk's own."""
    dev = _cuda()
    vecs, adj, q, entry = (t.to(dev) for t in _graphs(9, 40, 120, 128))
    _, _, steps = BW.launch(vecs, adj, q, entry, ef=48)
    TRACER.configure()
    with TRACER.span("search") as sp:
        with TRACER.span("walk") as walk:
            BW.beam_walk(vecs, adj, q, entry, ef=48)
            BW.beam_walk(vecs, adj, q, entry, ef=48)
        assert "walk_steps" not in sp.counts
        torch.cuda.synchronize()
        TRACER.settle()
    assert sp.counts["walk_launches"] == 2
    assert sp.counts["walk_steps"] == 2 * int(steps.max())
    assert "host_syncs" not in sp.counts
    assert "walk_steps" not in walk.attrs


@pytest.mark.gpu
@pytest.mark.parametrize("local", [False, True])
def test_graph_serve_paths_on_card(built, local):
    """``search_decoded_graph`` / ``_local`` over every partition of a
    built store (overflow rows in use): the card against the CPU."""
    dev = _cuda()
    ds, _, store = built
    fn = DS.search_decoded_graph_local if local else DS.search_decoded_graph
    outs = []
    for device in ("cpu", dev):
        part = _decoded(store, device)
        q = torch.from_numpy(ds.queries[:part.entry.shape[0]]).to(device)
        before = BW.launches
        outs.append(fn(part, q, 10, 48))
        assert BW.launches == before + (device != "cpu")
    (d0, i0), (d, i) = outs
    d, i = d.cpu().numpy(), i.cpu().numpy()
    d0, i0 = d0.numpy(), i0.numpy()
    ok, n = ids_agree_up_to_ties(np.where(np.isfinite(d), i, -1),
                                 np.where(np.isfinite(d0), i0, -1), d0,
                                 rtol=RTOL)
    assert ok, f"{n} ids differ beyond ties"
    np.testing.assert_allclose(d, d0, rtol=RTOL, atol=1e-6)


@pytest.mark.gpu
def test_engine_graph_search_on_card(built):
    """A whole exact graph search on the card against the same engine on
    the CPU: answers equal up to ties, the same walk steps, one launch a
    pair chunk, and no walk syncs."""
    dev = _cuda()
    ds, meta, store = built
    runs = []
    for device in ("cpu", dev):
        eng = DHNSWEngine(EngineConfig(**CFG), device=device)
        eng.adopt_built(copy.deepcopy(meta), copy.deepcopy(store), ds.data)
        TRACER.configure()
        runs.append(eng.search(ds.queries, k=5))
        TRACER.disable()
    (d0, g0, s0), (d, g, s) = runs
    ok, n = ids_agree_up_to_ties(g, g0, d0, rtol=RTOL)
    assert ok, f"{n} gids differ beyond ties"
    np.testing.assert_allclose(d, d0, rtol=RTOL, atol=1e-6)
    assert s["walk_steps"] == s0["walk_steps"] > 0
    assert s["walk_launches"] == s["n_rounds"] and "walk_launches" not in s0
    assert "host_syncs.walk" not in s and s0["host_syncs.walk"] > 0
    assert s["net"] == s0["net"]
