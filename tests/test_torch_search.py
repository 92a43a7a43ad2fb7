"""The port's batched search (``repro_torch.core.search``) against the JAX
package's ``repro.core.search`` on the CPU.

Inputs are made with numpy from a seed (or taken from the shared
``built_engine`` fixture's meta-HNSW) and cross the frameworks as numpy.
Routing must give the same partition ids; distances agree within rtol
1e-5 (the two sides sum in a different order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import search as TS  # noqa: E402

RTOL = 1e-5


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import search as S
    return jnp, S


def _port_meta(built_engine):
    meta, _ = convert.state_from_numpy(*convert.numpy_state(
        built_engine.meta, built_engine.store))
    return meta


@pytest.mark.parametrize("b", [1, 4])
def test_meta_route_pids_equal_reference(jref, built_engine, sift_small, b):
    """Routing gate: pids equal the reference's on the ``built_engine``
    geometry (n=4000, n_rep=32, seed 3)."""
    jnp, S = jref
    g = built_engine.meta.graph
    pr, dr = S.meta_route(jnp.asarray(g.vectors), jnp.asarray(g.adjacency),
                          jnp.asarray(sift_small.queries), int(g.entry), b=b,
                          n_levels=g.n_levels)
    tg = _port_meta(built_engine).graph
    pt, dt = TS.meta_route(torch.from_numpy(tg.vectors),
                           torch.from_numpy(tg.adjacency),
                           torch.from_numpy(sift_small.queries),
                           int(tg.entry), b=b, n_levels=tg.n_levels)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pr))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dr), rtol=RTOL)


def test_meta_route_matches_client_route(built_engine, sift_small):
    """The engine's routing call and the function agree (same entry)."""
    from repro_torch import DHNSWEngine, EngineConfig
    meta, store = convert.state_from_numpy(*convert.numpy_state(
        built_engine.meta, built_engine.store))
    eng = DHNSWEngine(EngineConfig(n_rep=32, b=4, seed=3), device="cpu")
    eng.adopt_built(meta, store, sift_small.data)
    q = torch.from_numpy(sift_small.queries)
    pids = eng.client._route(q, 4)
    g = meta.graph
    want, _ = TS.meta_route(torch.from_numpy(g.vectors),
                            torch.from_numpy(g.adjacency), q, int(g.entry),
                            b=4, n_levels=g.n_levels)
    np.testing.assert_array_equal(pids, want.numpy())


@pytest.mark.parametrize("ef,n_levels", [(8, 1), (16, 3), (48, 3)])
def test_batched_beam_search_matches_reference(jref, built_engine,
                                               sift_small, ef, n_levels):
    """The batched loop over the meta graph equals the reference's vmap'd
    ``lax.while_loop`` walk, lane by lane."""
    jnp, S = jref
    g = built_engine.meta.graph
    q = sift_small.queries[:40]
    dr, ir = S.batched_beam_search(jnp.asarray(g.vectors),
                                   jnp.asarray(g.adjacency), jnp.asarray(q),
                                   int(g.entry), ef=ef, n_levels=n_levels)
    dt, it = TS.batched_beam_search(torch.from_numpy(g.vectors),
                                    torch.from_numpy(g.adjacency),
                                    torch.from_numpy(q), int(g.entry), ef=ef,
                                    n_levels=n_levels)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dr), rtol=RTOL)


def test_beam_search_per_lane_graphs_match_reference(jref, rng):
    """Per-lane graphs (the fetched-partition form) walk exactly like one
    reference ``beam_search`` per lane, including a lane with padded
    neighbours (the node-0 visited quirk)."""
    jnp, S = jref
    L, N, D, deg, ef = 6, 60, 16, 6, 12
    vecs = rng.standard_normal((L, N, D)).astype(np.float32)
    adj = rng.integers(0, N, (L, 1, N, deg)).astype(np.int32)
    adj[:, :, :, -2:] = -1                       # padded tail of every list
    q = rng.standard_normal((L, D)).astype(np.float32)
    entry = rng.integers(0, N, L)
    dt, it = TS.batched_beam_search(torch.from_numpy(vecs),
                                    torch.from_numpy(adj),
                                    torch.from_numpy(q),
                                    torch.from_numpy(entry), ef=ef)
    for lane in range(L):
        dr, ir = S.beam_search(jnp.asarray(vecs[lane]), jnp.asarray(adj[lane]),
                               jnp.asarray(q[lane]), int(entry[lane]), ef=ef)
        np.testing.assert_array_equal(it[lane].numpy(), np.asarray(ir))
        np.testing.assert_allclose(dt[lane].numpy(), np.asarray(dr),
                                   rtol=RTOL)


def test_scan_and_merge_match_reference(jref, rng):
    jnp, S = jref
    x = rng.standard_normal((50, 8)).astype(np.float32)
    x[7] = x[3]                                  # a tie: lower index first
    q = rng.standard_normal(8).astype(np.float32)
    dr, ir = S.scan_partition(jnp.asarray(x), jnp.asarray(q), 10, n_valid=40)
    dt, it = TS.scan_partition(torch.from_numpy(x), torch.from_numpy(q), 10,
                               n_valid=40)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dr), rtol=RTOL)
    a = np.sort(rng.random((4, 5)).astype(np.float32), 1)
    b = np.sort(rng.random((4, 5)).astype(np.float32), 1)
    b[:, 0] = a[:, 1]                            # cross-list ties
    ia, ib = np.arange(20).reshape(4, 5), 100 + np.arange(20).reshape(4, 5)
    mr = S.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b),
                      jnp.asarray(ib), 6)
    mt = TS.merge_topk(*(torch.from_numpy(v) for v in (a, ia, b, ib)), 6)
    np.testing.assert_array_equal(mt[1].numpy(), np.asarray(mr[1]))
    np.testing.assert_array_equal(mt[0].numpy(), np.asarray(mr[0]))
