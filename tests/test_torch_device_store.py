"""The port's quantized-tier device store against the JAX package's.

One seeded index (the shared ``built_engine`` fixture: n=4000, n_rep=32,
seed 3) gets the int8 mirror; the spans of a few partitions are decoded
and searched by both packages, the port with a leading batch of spans
where the reference ``vmap``s one.  Dequantized vectors, decoded graph
state, exact-row addresses and payloads must be exactly equal; local ids
equal except at reference ties within 1e-5 relative; distances within
rtol 1e-5, atol 1e-4 (the two sides sum squares in a different order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import device_store as DS  # noqa: E402
from repro_torch.kernels.quant_topk.ref import ids_agree_up_to_ties  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
PIDS = [0, 5, 17, 31]
M, EF = 20, 48


@pytest.fixture(scope="module")
def jds():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import device_store as RDS
    from repro.core import layout as RLA
    return jnp, RDS, RLA


@pytest.fixture(scope="module")
def stores(jds, built_engine):
    """(reference store, port store), both with the int8 mirror."""
    _, _, RLA = jds
    rs = RLA.attach_quant_mirror(dataclasses.replace(built_engine.store), 32)
    _, ps = convert.state_from_numpy(*convert.numpy_state(built_engine.meta,
                                                          rs))
    return rs, ps


def _spans(store, pids):
    ids = np.stack([store.span_block_ids(int(p)) for p in pids])
    return (store.graph_buf[ids], store.qvec_buf[ids], store.qscale_buf[ids],
            store.meta_table[np.asarray(pids)])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ext(d, i, k):
    d = np.asarray(d, np.float64)
    return d, np.where(np.isfinite(d), np.asarray(i), -1)


def _assert_local(d, li, d_ref, li_ref):
    """Port (k) lists against reference (k + 1) lists."""
    k = d.shape[1]
    d_ext, li_ext = _ext(d_ref, li_ref, k)
    ok, n = ids_agree_up_to_ties(np.where(np.isfinite(d), li, -1), li_ext,
                                 d_ext, rtol=RTOL)
    assert ok, f"{n} local ids differ beyond ties"
    np.testing.assert_allclose(d, d_ext[:, :k], rtol=RTOL, atol=ATOL)


def test_decode_quant_span_matches_reference(jds, stores):
    jnp, RDS, _ = jds
    rs, ps = stores
    g, qv, qs, mt = _spans(rs, PIDS)
    part, rows = DS.decode_quant_span(ps.spec, *_t(g, qv, qs, mt))
    assert rows.dtype == torch.int32
    for j in range(len(PIDS)):
        rp, rr = RDS.decode_quant_span(rs.spec, jnp.asarray(g[j]),
                                       jnp.asarray(qv[j]), jnp.asarray(qs[j]),
                                       jnp.asarray(mt[j]))
        np.testing.assert_array_equal(part.vectors[j].numpy(),
                                      np.asarray(rp.vectors))
        np.testing.assert_array_equal(part.adjacency[j].numpy(),
                                      np.asarray(rp.adjacency))
        np.testing.assert_array_equal(part.gids[j].numpy(),
                                      np.asarray(rp.gids))
        np.testing.assert_array_equal(part.valid[j].numpy(),
                                      np.asarray(rp.valid))
        assert int(part.entry[j]) == int(rp.entry)
        np.testing.assert_array_equal(rows[j].numpy(), np.asarray(rr))


@pytest.mark.parametrize("mode", ["scan", "graph"])
def test_search_decoded_local_matches_reference(jds, stores, sift_small,
                                                mode):
    jnp, RDS, _ = jds
    rs, ps = stores
    g, qv, qs, mt = _spans(rs, PIDS)
    q = sift_small.queries[:len(PIDS)]
    part, _ = DS.decode_quant_span(ps.spec, *_t(g, qv, qs, mt))
    if mode == "graph":
        d, li = DS.search_decoded_graph_local(part, torch.from_numpy(q), M,
                                              EF)
    else:
        d, li = DS.search_decoded_scan_local(part, torch.from_numpy(q), M)
    assert li.dtype == torch.int32 and d.shape == li.shape == (len(PIDS), M)
    for j in range(len(PIDS)):
        rp, _ = RDS.decode_quant_span(rs.spec, jnp.asarray(g[j]),
                                      jnp.asarray(qv[j]), jnp.asarray(qs[j]),
                                      jnp.asarray(mt[j]))
        if mode == "graph":
            dr, lr = RDS.search_decoded_graph_local(rp, jnp.asarray(q[j]),
                                                    M + 1, EF)
        else:
            dr, lr = RDS.search_decoded_scan_local(rp, jnp.asarray(q[j]),
                                                   M + 1)
        _assert_local(d[j:j + 1].numpy(), li[j:j + 1].numpy(),
                      np.asarray(dr)[None], np.asarray(lr)[None])


def test_search_decoded_scan_local_pads_past_the_partition(jds, stores,
                                                           sift_small):
    """k past the decoded rows: inf/-1 padding, as ``_pad_topk`` pads."""
    jnp, RDS, _ = jds
    rs, ps = stores
    g, qv, qs, mt = _spans(rs, PIDS[:1])
    q = sift_small.queries[:1]
    part, _ = DS.decode_quant_span(ps.spec, *_t(g, qv, qs, mt))
    k = part.vectors.shape[1] + 5
    d, li = DS.search_decoded_scan_local(part, torch.from_numpy(q), k)
    rp, _ = RDS.decode_quant_span(rs.spec, *(jnp.asarray(a[0])
                                             for a in (g, qv, qs, mt)))
    dr, lr = RDS.search_decoded_scan_local(rp, jnp.asarray(q[0]), k)
    assert d.shape == (1, k)
    assert (li[0, -5:] == -1).all() and torch.isinf(d[0, -5:]).all()
    np.testing.assert_array_equal(np.isfinite(d[0].numpy()),
                                  np.isfinite(np.asarray(dr)))
    live = np.isfinite(np.asarray(dr))
    np.testing.assert_allclose(d[0].numpy()[live], np.asarray(dr)[live],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(li[0].numpy()[-5:], np.asarray(lr)[-5:])


def test_merge_ranked_payload_matches_reference(jds):
    jnp, RDS, _ = jds
    rng = np.random.default_rng(5)
    B, m, n_lanes, P = 5, 6, 3, 3
    run_d = np.sort(rng.random((B, m)).astype(np.float32), axis=1)
    run_d[1, 3:] = np.inf
    run_p = rng.integers(0, 1000, (B, m, P)).astype(np.int32)
    # pairs: unique (query, rank); the last two are padding (row B)
    qi = np.array([0, 0, 1, 2, 2, 2, 4, B, B], np.int32)
    rk = np.array([0, 1, 0, 0, 1, 2, 0, 0, 0], np.int32)
    d = np.sort(rng.random((len(qi), m)).astype(np.float32), axis=1)
    d[0, :2] = run_d[0, :2]               # ties with the running list
    d[3, 4:] = np.inf
    p = rng.integers(0, 1000, (len(qi), m, P)).astype(np.int32)
    rd, rp = RDS.merge_ranked_payload(*(jnp.asarray(a) for a in (
        run_d, run_p, qi, rk, d, p)), n_lanes=n_lanes)
    nd, np_ = DS.merge_ranked_payload(*_t(run_d, run_p, qi, rk, d, p),
                                      n_lanes=n_lanes)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(np_.numpy(), np.asarray(rp))
    # the single-column merge is the payload merge with P = 1
    gd, gg = DS.merge_ranked(*_t(run_d, run_p[..., 0], qi, rk, d, p[..., 0]),
                             n_lanes=n_lanes)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(rp)[..., 0])


@pytest.mark.parametrize("mode", ["scan", "graph"])
def test_serve_quant_pool_matches_reference(jds, stores, sift_small, mode):
    """One stage-1 round over four cached quantized spans: the pooled
    candidates' distances and payloads [gid, exact row, pid]."""
    jnp, RDS, _ = jds
    rs, ps = stores
    spec = ps.spec
    g, qv, qs, _ = _spans(rs, PIDS)
    n_slots = len(PIDS) + 1                 # one slot left empty
    cache = [np.full((n_slots,) + g.shape[1:], -1, np.int32),
             np.zeros((n_slots,) + qv.shape[1:], np.int8),
             np.zeros((n_slots,) + qs.shape[1:], np.float32)]
    slot_of = {p: s for s, p in enumerate(PIDS)}
    for c, blk in zip(cache, (g, qv, qs)):
        c[:len(PIDS)] = blk
    B = 6
    queries = sift_small.queries[:B]
    pairs = [(0, 0), (0, 5), (1, 17), (2, 31), (2, 0), (2, 5), (4, 17),
             (5, 31)]
    npad = 16
    qi = np.full(npad, B, np.int32)
    pid = np.zeros(npad, np.int32)
    slot = np.zeros(npad, np.int32)
    rank = np.zeros(npad, np.int32)
    seen: dict = {}
    for n, (q, p) in enumerate(pairs):
        qi[n], pid[n], slot[n] = q, p, slot_of[p]
        rank[n] = seen.get(q, 0)
        seen[q] = rank[n] + 1
    valid = np.arange(npad) < len(pairs)
    pool_d = np.full((B, M), np.inf, np.float32)
    pool_p = np.full((B, M, 3), -1, np.int32)
    rd, rp = RDS.serve_quant_pool(
        rs.spec, *(jnp.asarray(a) for a in cache), jnp.asarray(rs.meta_table),
        jnp.asarray(queries), jnp.asarray(pool_d), jnp.asarray(pool_p),
        *(jnp.asarray(a) for a in (qi, pid, slot, rank, valid)), m=M, ef=EF,
        mode=mode, n_lanes=3)
    nd, np_ = DS.serve_quant_pool(
        spec, *_t(*cache), torch.from_numpy(ps.meta_table),
        torch.from_numpy(queries), *_t(pool_d, pool_p, qi, pid, slot, rank,
                                       valid), m=M, ef=EF, mode=mode,
        n_lanes=3)
    assert np_.dtype == torch.int32 and np_.shape == (B, M, 3)
    np.testing.assert_array_equal(np_.numpy(), np.asarray(rp))
    np.testing.assert_allclose(nd.numpy(), np.asarray(rd), rtol=RTOL,
                               atol=ATOL)
    assert (np_.numpy()[3] == -1).all()     # query 3 has no pair


def test_write_slots_quant_in_place(stores):
    _, ps = stores
    g, qv, qs, _ = _spans(ps, PIDS[:2])
    cache = [torch.full((3,) + g.shape[1:], -1, dtype=torch.int32),
             torch.zeros((3,) + qv.shape[1:], dtype=torch.int8),
             torch.zeros((3,) + qs.shape[1:], dtype=torch.float32)]
    out = DS.write_slots_quant(ps.spec, *cache,
                               torch.tensor([2, 0], dtype=torch.int32),
                               *_t(g, qv, qs))
    assert all(a is b for a, b in zip(out, cache))
    for c, blk in zip(cache, (g, qv, qs)):
        np.testing.assert_array_equal(c[2].numpy(), blk[0])
        np.testing.assert_array_equal(c[0].numpy(), blk[1])
    assert (cache[0][1] == -1).all()
