"""The port's insert path on the CPU: twins of the reference's insert
tests, and the port's inserts against the JAX package's.

Insert routes each vector through the cached meta-HNSW and writes it
into its group's shared overflow region through the pool ``append`` verb
(host layout, device twin, and the int8 mirror's twin); a full region is
repacked (``repack``), and a group that no longer fits is rebuilt whole
(``_full_rebuild``).  The parity tests carry one index built by the JAX
package across with ``repro_torch.convert`` and run the same seeded
inserts through both engines in exact graph, exact scan, int8 pairs and
int8 flat: returned gids, ``_last_insert_net``, pool verbs and totals and
every host buffer must be equal, post-insert search gids equal, and
distances within rtol 1e-5 / atol 1e-4 (as ``test_torch_engine.py``).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DHNSWEngine, EngineConfig, convert  # noqa: E402
from repro_torch.core import layout as LA  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G, NetLedger  # noqa: E402
from repro_torch.core.hnsw import HNSWParams  # noqa: E402
from repro_torch.pool.local import LocalPool  # noqa: E402
from repro_torch.quant.codec import (dequantize_groups,  # noqa: E402
                                     quantize_groups, quantize_row_torch)

RTOL, ATOL = 1e-5, 1e-4
BUFS = ("graph_buf", "vec_buf", "meta_table", "n_base", "qvec_buf",
        "qscale_buf")


def _engine(data, **kw):
    return DHNSWEngine(EngineConfig(**kw), device="cpu").build(data)


def _found(gids, g) -> float:
    return float(np.mean([gid in g[i] for i, gid in enumerate(gids)]))


# ------------------------------------------- twins of test_engine.py

def test_insert_then_searchable(sift_small):
    eng = _engine(sift_small.data[:2000], search_mode="scan", n_rep=16, b=2,
                  ef=32, cache_frac=0.4, seed=3)
    new = sift_small.data[2000:2010] + 0.001
    gids = eng.insert(new)
    assert len(gids) == 10
    assert np.array_equal(gids, np.arange(2000, 2010))
    d, g, _ = eng.search(new, k=3)
    assert _found(gids, g) >= 0.9, (g[:3], gids[:3])


def test_insert_overflow_triggers_repack(sift_small):
    eng = _engine(sift_small.data[:1000], search_mode="scan", n_rep=8, b=2,
                  ef=32, cache_frac=0.5, seed=3)
    ov = eng.store.spec.ov_cap
    base = sift_small.data[42]
    new = base[None, :] + 0.0005 * np.random.default_rng(0).standard_normal(
        (ov + 3, eng.store.spec.dim)).astype(np.float32)
    gids = eng.insert(new)
    assert eng.pool.verbs["repack"] >= 1
    d, g, _ = eng.search(new[:8], k=3)
    assert _found(gids[:8], g) >= 0.8


def test_insert_right_after_repack_immediately_searchable(sift_small):
    """The vector whose insert triggers a repack is re-appended through the
    pool verb (device twin included) and is its own nearest neighbour at
    distance ~0 right away.  The burst targets the smallest partition, so
    the repack fits."""
    eng = _engine(sift_small.data[:1000], search_mode="scan", n_rep=16, b=2,
                  ef=32, cache_frac=0.5, seed=3)
    spec = eng.store.spec
    sizes = np.asarray(eng.store.n_base)
    pid = int(np.argmin(sizes))
    assert sizes[pid] + spec.ov_cap <= spec.np_max, "repack must fit"
    rep = sift_small.data[int(eng.meta.rep_ids[pid])]
    new = rep[None, :] + 0.0003 * np.random.default_rng(1).standard_normal(
        (spec.ov_cap + 1, spec.dim)).astype(np.float32)
    gids = eng.insert(new)
    assert eng.pool.verbs["repack"] == 1
    assert eng.pool.verbs["append"] == spec.ov_cap + 1
    d, g, _ = eng.search(new[-1:], k=3)
    assert int(gids[-1]) in g[0], (gids[-1], g[0])
    assert d[0, 0] <= 1e-6, d[0]


def test_failed_repack_rebuild_keeps_gid_unique(sift_small):
    """A repack that cannot fit falls back to a full rebuild, which folds
    the triggering vector into the base: it is not appended again, so its
    gid appears once."""
    eng = _engine(sift_small.data[:1000], search_mode="scan", n_rep=16, b=2,
                  ef=32, cache_frac=0.5, seed=3)
    spec = eng.store.spec
    pid = int(np.argmax(np.asarray(eng.store.n_base)))
    assert eng.store.n_base[pid] + spec.ov_cap > spec.np_max
    rep = sift_small.data[int(eng.meta.rep_ids[pid])]
    new = rep[None, :] + 0.0003 * np.random.default_rng(2).standard_normal(
        (spec.ov_cap + 1, spec.dim)).astype(np.float32)
    gids = eng.insert(new)
    assert eng.client._n0 == 1000 + spec.ov_cap + 1   # rebuilt whole
    assert not eng.client._extra
    d, g, _ = eng.search(new[-1:], k=5)
    assert int(gids[-1]) in g[0]
    assert d[0, 0] <= 1e-6, d[0]
    live = g[0][g[0] >= 0]
    assert len(np.unique(live)) == len(live), g[0]
    more = eng.insert(new[:1] + 0.01)
    assert int(more[0]) == 1000 + spec.ov_cap + 1


# -------------------------------------------- twins of test_quant.py

@pytest.fixture(scope="module")
def qds():
    from repro_torch.data.synthetic import sift_like
    return sift_like(n=3000, n_queries=256, seed=7)


def test_insert_searchable_with_quant(qds):
    eng = _engine(qds.data[:2000], mode="full", search_mode="scan",
                  n_rep=16, b=2, ef=32, cache_frac=0.4, seed=3, quant="int8")
    new = qds.data[2000:2010] + 0.001
    gids = eng.insert(new)
    d, g, _ = eng.search(new, k=3)
    assert _found(gids, g) >= 0.9, (g[:3], gids[:3])


def test_insert_overflow_repack_with_quant(qds):
    eng = _engine(qds.data[:1000], mode="full", search_mode="scan", n_rep=8,
                  b=2, ef=32, cache_frac=0.5, seed=3, quant="int8")
    ov = eng.store.spec.ov_cap
    base = qds.data[42]
    new = base[None, :] + 0.0005 * np.random.default_rng(0).standard_normal(
        (ov + 3, eng.store.spec.dim)).astype(np.float32)
    gids = eng.insert(new)
    d, g, _ = eng.search(new[:8], k=3)
    assert _found(gids[:8], g) >= 0.8
    # the quantized mirror tracked the repack: codes decode near vec_buf
    store = eng.store
    xr = dequantize_groups(store.qvec_buf, store.qscale_buf,
                           store.spec.quant_group)
    assert np.abs(xr - store.vec_buf).max() <= (
        np.abs(store.vec_buf).max() / 200)
    # and its staged twin equals the host mirror
    assert np.array_equal(eng.pool._qv_dev.numpy(), store.qvec_buf)
    assert np.array_equal(eng.pool._qs_dev.numpy(), store.qscale_buf)


def test_flat_kernel_insert_stays_coherent(qds):
    """Appends keep the dense-resident flat view coherent without a
    resync: the inserted vector is a stage-1 candidate right away, and
    the view (codes, scales and the payload twin) equals a fresh sync."""
    eng = _engine(qds.data[:2000], mode="full", search_mode="scan", n_rep=16,
                  b=3, ef=32, cache_frac=0.6, seed=3, quant="int8",
                  quant_kernel="auto")
    eng.search(qds.queries[:8], k=10)         # cold sync
    new = qds.queries[:4] + 0.001
    gids = eng.insert(new)
    c = eng.client
    assert c._flat_synced and c._flat_n == 2004
    d, g, st = eng.search(new, k=3)
    assert st.get("quant_kernel") == "flat"
    assert _found(gids, g) == 1.0, (g, gids)
    grown = [t.clone() for t in (c._flat_codes, c._flat_scales,
                                 c._flat_cols)]
    idx = c._flat_idx.copy()
    c._sync_flat(NetLedger(RDMA_100G))
    np.testing.assert_array_equal(np.sort(idx[:2004]),
                                  np.sort(c._flat_idx[:2004]))
    order = {int(r): j for j, r in enumerate(c._flat_idx[:2004])}
    perm = torch.as_tensor([order[int(r)] for r in idx[:2004]])
    for old, new_t in zip(grown, (c._flat_codes, c._flat_scales,
                                  c._flat_cols)):
        assert torch.equal(old[:2004], new_t[perm])


# ----------------------------------------------- the codec's device twin

def test_quantize_row_torch_matches_quantize_row_jnp():
    """Bit for bit, on seeded rows with exact half-way quotients (group
    absmax 127: scale 1, so x.5 rounds half to even), an all-zero group
    and values past the clip."""
    pytest.importorskip("jax")
    from repro.quant.codec import quantize_row_jnp
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(128).astype(np.float32) for _ in range(8)]
    half = np.zeros(128, np.float32)
    half[:32] = np.arange(32) - 15.5          # -15.5 .. 15.5 step 1
    half[0] = 127.0
    half[64:96] = 0.0                         # an all-zero group
    half[96:] = rng.standard_normal(32) * 1e30
    rows.append(half)
    for row in rows:
        for group in (2, 4, 8, 32):
            c_t, s_t = quantize_row_torch(torch.from_numpy(row), group)
            c_j, s_j = quantize_row_jnp(jnp.asarray(row), group)
            c_h, s_h = quantize_groups(row, group)
            assert c_t.dtype == torch.int8 and s_t.dtype == torch.float32
            assert np.array_equal(c_t.numpy(), np.asarray(c_j))
            assert s_t.numpy().tobytes() == np.asarray(s_j).tobytes()
            assert np.array_equal(c_t.numpy(), c_h)
            assert s_t.numpy().tobytes() == s_h.tobytes()
    c, s = quantize_row_torch(torch.from_numpy(half), 32)
    assert np.array_equal(c.numpy()[1:32], np.rint(half[1:32]))
    assert not c.numpy()[64:96].any() and s.numpy()[2] == 0.0


@pytest.mark.gpu
def test_quantize_row_torch_on_card_matches_the_host():
    """On the card the device twin's codes and scales equal the host
    codec's bit for bit (``LA.refresh_quant_blocks`` on the host and the
    device scatter must agree), on seeded rows of many scales."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    rows = (rng.standard_normal((512, 128))
            * 10.0 ** rng.uniform(-6, 6, (512, 1))).astype(np.float32)
    rows[0, :32] = 0.0
    for group in (2, 4, 6, 8, 32, 64, 128):
        if 128 % group:
            continue
        c_h, s_h = quantize_groups(rows, group)
        for r in range(len(rows)):
            c, s = quantize_row_torch(torch.from_numpy(rows[r]).cuda(),
                                      group)
            assert np.array_equal(c.cpu().numpy(), c_h[r])
            assert s.cpu().numpy().tobytes() == s_h[r].tobytes()


# ---------------------------------------------------- compacted staging

def _tiny_store(data, ov_cap=8, quant=True):
    from repro_torch.core.meta import build_meta
    meta = build_meta(data, 8, seed=0, meta_levels=2)
    store = LA.build_store(data, meta, ov_cap=ov_cap,
                           sub_params=HNSWParams(M=4, M0=8,
                                                 ef_construction=40))
    return LA.attach_quant_mirror(store, 32) if quant else store


def _equal_reads(a, b, pids, rows):
    la, lb = NetLedger(RDMA_100G), NetLedger(RDMA_100G)
    for quant in (False, True):
        for x, y in zip(a.read_spans(pids, ledger=la, doorbell=4,
                                     quant=quant),
                        b.read_spans(pids, ledger=lb, doorbell=4,
                                     quant=quant)):
            assert torch.equal(x, y)
    assert la.as_dict() == lb.as_dict()
    live = rows >= 0      # dead lanes gather a placeholder row, masked
    assert torch.equal(a.read_rows(rows)[live], b.read_rows(rows)[live])
    for x, y in zip(a.read_quant_rows(rows), b.read_quant_rows(rows)):
        assert torch.equal(x[live], y[live])


def test_compacted_staging_gives_the_full_staging_verbs(sift_small):
    """``restrict_staging`` and ``owned_groups=`` stage only the owned
    groups' blocks, yet span, row and quantized-row reads, appends and
    ``refresh_blocks`` give what the fully staged pool gives; dead -1
    lanes stay dead."""
    data = sift_small.data[:600]
    full = LocalPool(_tiny_store(data), device="cpu")
    comp = LocalPool(_tiny_store(data), device="cpu", owned_groups=[0, 2])
    spec = full.spec
    assert comp.staging["compacted"] and not full.staging["compacted"]
    assert comp.staging["blocks_staged"] == 2 * spec.group_blocks
    assert comp.staging["device_bytes"] < full.staging["device_bytes"]
    pids = np.array([0, 1, 4, 5])
    sv = spec.slot_vecs
    rows = torch.tensor([[0, 5, -1], [2 * spec.group_blocks * sv + 3,
                                      sv + 1, -1]], dtype=torch.int32)
    _equal_reads(full, comp, pids, rows)
    # appends land in the compacted region at the remapped blocks
    for pool in (full, comp):
        for j, pid in enumerate((0, 1, 4)):
            assert pool.append(data[pid] + 0.01 * (j + 1), 9000 + j, pid,
                               ledger=NetLedger(RDMA_100G)) >= 0
    assert full.totals == comp.totals
    assert dict(full.verbs) == dict(comp.verbs)
    _equal_reads(full, comp, pids, rows)
    # refresh_blocks adopts a new group at group granularity
    gb = spec.group_blocks
    comp.refresh_blocks(np.arange(1 * gb, 2 * gb))
    full.refresh_blocks(np.arange(1 * gb, 2 * gb))
    assert comp.staging["blocks_staged"] == 3 * gb
    assert comp.staging["restaged_blocks"] == gb
    assert full.staging["restaged_blocks"] == gb
    _equal_reads(full, comp, np.array([0, 2, 3, 4]), rows)
    # back to full staging
    comp.restrict_staging(None)
    assert not comp.staging["compacted"]
    assert comp.staging["blocks_staged"] == spec.n_blocks
    _equal_reads(full, comp, np.arange(spec.n_partitions), rows)
    comp.restrict_staging([1])
    assert comp.staging["blocks_staged"] == gb
    _equal_reads(full, comp, np.array([2, 3]), torch.tensor(
        [[gb * sv, -1]], dtype=torch.int32))


def test_compacted_staging_matches_reference(sift_small):
    """The port's compacted pool against the reference's: the same staged
    block ids, the same slot map and the same staging tallies after an
    append and a group adoption."""
    pytest.importorskip("jax")
    from repro.core import layout as RLA
    from repro.pool.local import LocalPool as RLocalPool
    from repro.core.cost_model import NetLedger as RNetLedger
    from repro.core.cost_model import RDMA_100G as R_RDMA
    data = sift_small.data[:600]
    store = _tiny_store(data)
    ref_store = RLA.Store(**{f.name: copy.deepcopy(getattr(store, f.name))
                             for f in dataclasses.fields(store)})
    ref_store.spec = RLA.LayoutSpec(**dataclasses.asdict(store.spec))
    port = LocalPool(copy.deepcopy(store), device="cpu", owned_groups=[1])
    ref = RLocalPool(ref_store, owned_groups=[1])
    for pool, ledger in ((port, NetLedger(RDMA_100G)),
                         (ref, RNetLedger(R_RDMA))):
        assert pool.append(data[2] + 0.02, 7000, 2, ledger=ledger) >= 0
        pool.refresh_blocks(np.arange(0, store.spec.group_blocks))
    assert np.array_equal(port._staged_ids, ref._staged_ids)
    assert np.array_equal(port._block_slot, ref._block_slot)
    assert port.staging == ref.staging
    assert port.totals == ref.totals and dict(port.verbs) == dict(ref.verbs)
    for a in ("_g_dev", "_v_dev", "_qv_dev", "_qs_dev"):
        assert np.array_equal(getattr(port, a).numpy(),
                              np.asarray(getattr(ref, a))), a


# ------------------------------------------------- against the reference

CONFIGS = {
    "exact-graph": dict(search_mode="graph", b=2, ef=32, cache_frac=0.5),
    "exact-scan": dict(search_mode="scan", b=2, ef=32, cache_frac=0.5),
    "int8-pairs": dict(search_mode="scan", b=4, quant="int8",
                       quant_kernel="off", cache_frac=0.25,
                       exact_frac=0.25),
    "int8-flat": dict(search_mode="scan", b=4, quant="int8",
                      quant_kernel="auto", cache_frac=0.6, exact_frac=0.25),
}


@pytest.fixture(scope="module")
def ref_built(sift_small):
    """One index (1000 rows, 16 partitions) built by the JAX package."""
    pytest.importorskip("jax")
    import repro.core as RC
    data = sift_small.data[:1000]
    return RC, RC.DHNSWEngine(RC.EngineConfig(n_rep=16, seed=3)).build(data)


def _bursts(sift_small, ref, rng):
    """Seeded inserts: ten held-out rows, then ov_cap + 1 rows near the
    smallest partition's representative (the group repacks) and ov_cap + 1
    near the largest's (the repack cannot fit: a full rebuild).  The
    bursts' noise (0.02) keeps the rows apart in int8 codes, so stage-1
    ties do not decide which rows reach the re-rank."""
    spec = ref.store.spec
    sizes = np.asarray(ref.store.n_base)
    data = sift_small.data

    def burst(pid):
        rep = data[int(ref.meta.rep_ids[pid])]
        return (rep[None] + 0.02 * rng.standard_normal(
            (spec.ov_cap + 1, spec.dim))).astype(np.float32)
    return [data[1000:1010], burst(int(np.argmin(sizes))),
            burst(int(np.argmax(sizes)))]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_inserts_match_reference(ref_built, sift_small, name):
    RC, built = ref_built
    kw = dict(n_rep=16, seed=3, **CONFIGS[name])
    data = sift_small.data[:1000]
    ref = RC.DHNSWEngine(RC.EngineConfig(**kw))
    ref.client.adopt_built(built.meta, copy.deepcopy(built.store), data)
    meta, store = convert.state_from_numpy(*convert.numpy_state(
        built.meta, built.store))
    eng = DHNSWEngine(EngineConfig(**kw), device="cpu").adopt_built(
        meta, store, data)
    queries = sift_small.queries[:16]
    ref.search(queries, k=5)
    eng.search(queries, k=5)
    repacks = []
    for batch in _bursts(sift_small, built, np.random.default_rng(1)):
        want = ref.insert(batch)
        got = eng.insert(batch)
        assert np.array_equal(got, want)
        assert eng._last_insert_net == ref._last_insert_net
        assert dict(eng.pool.verbs) == dict(ref.pool.verbs)
        assert eng.pool.totals == ref.pool.totals
        assert eng.client._n0 == ref.client._n0
        for a in BUFS:
            x, y = getattr(ref.store, a), getattr(eng.store, a)
            assert (x is None) == (y is None), a
            if x is not None:
                assert np.asarray(x).dtype == y.dtype, a
                assert np.asarray(x).tobytes() == y.tobytes(), a
        repacks.append(eng.pool.verbs["repack"])
        q = np.concatenate([queries, batch[:8]])
        dr, gr, sr = ref.search(q, k=5)
        dt, gt, st = eng.search(q, k=5)
        assert np.array_equal(gt, gr)
        np.testing.assert_allclose(dt, dr, rtol=RTOL, atol=ATOL)
        assert st["net"] == sr["net"]
        for key in ("n_fetches", "cache_hits", "rerank_rows", "flat_rows"):
            assert st.get(key) == sr.get(key), key
    # the second burst repacked; the third's repack failed (a rebuild)
    assert repacks == [0, 1, 2]
    assert eng.client._n0 == ref.client._n0 > 1000


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["naive", "full"])
def test_pools_bit_identical_search_insert(sift_small, mode, quant):
    """Twin of the reference's transport conformance test for ``local``:
    the port's LocalPool engine and the reference's, built from the same
    data, serve the same layout, results and counted network, before and
    after inserts through the append verb."""
    pytest.importorskip("jax")
    import repro.core as RC
    data, queries = sift_small.data[:1200], sift_small.queries[:24]
    cfg = dict(mode=mode, search_mode="scan", n_rep=12, b=3, ef=32,
               cache_frac=0.25, seed=3, quant=quant)
    ref = RC.DHNSWEngine(RC.EngineConfig(fabric=_ref_fabric(), **cfg))
    ref.build(data)
    eng = _engine(data, fabric=RDMA_100G, **cfg)
    for a in ("graph_buf", "vec_buf", "meta_table"):
        assert np.array_equal(getattr(ref.store, a), getattr(eng.store, a))
    for q in (queries, None):
        if q is None:
            new = queries[:3] + 0.001
            assert np.array_equal(ref.insert(new), eng.insert(new))
            assert ref._last_insert_net == eng._last_insert_net
            q = queries[:8]
        dr, gr, sr = ref.search(q, k=10)
        dt, gt, st = eng.search(q, k=10)
        assert np.array_equal(gt, gr)
        np.testing.assert_allclose(dt, dr, rtol=RTOL, atol=ATOL)
        for key in ("round_trips", "descriptors", "bytes", "bytes_saved"):
            assert st["net"][key] == sr["net"][key], key
    assert eng.pool.snapshot()["totals"] == ref.pool.snapshot()["totals"]


def _ref_fabric():
    from repro.core.cost_model import RDMA_100G as R
    return R


def test_verb_counts_match_ledger(sift_small):
    """Pool-side running totals equal the sum of every ledger the engine
    charged (searches and inserts); each append is one charged WRITE of
    dim * 4 + 8 bytes, plus codes and scales with the int8 mirror."""
    data, queries = sift_small.data[:1200], sift_small.queries[:24]
    eng = _engine(data, mode="full", search_mode="scan", n_rep=12, b=3,
                  ef=32, cache_frac=0.25, seed=3, fabric=RDMA_100G,
                  quant="int8")
    totals = {"round_trips": 0.0, "descriptors": 0.0, "bytes": 0.0}
    for i in range(3):
        _, _, st = eng.search(queries[i * 8:(i + 1) * 8], k=10)
        for key in totals:
            totals[key] += st["net"][key]
    eng.insert(queries[:2] + 0.001)
    net = eng._last_insert_net
    spec = eng.store.spec
    per = spec.dim * 4 + 8 + spec.dim + spec.dim // spec.quant_group * 4
    assert net["round_trips"] == net["descriptors"] == 2
    assert net["bytes"] == 2 * per
    for key in totals:
        totals[key] += net[key]
    snap = eng.pool.snapshot()
    for key in totals:
        assert snap["totals"][key] == pytest.approx(totals[key]), key
    assert snap["verbs"]["read_meta"] >= 3
    assert snap["verbs"]["append"] == 2
