"""The yardstick: the generator, the reference, the pricing, the order
statistics, the trace reduction and the judge, each against hand-worked
or brute-force numbers."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.reference import exact_knn as REF
from bench.yardstick import check, data as D, net, stats as ST
from bench.yardstick.trace import DeviceTrace


CONFIG = {"data": {"n": 3000, "dim": 16, "spread": 0.15, "n_clusters": 0,
                   "data_seed": 4}}


@pytest.mark.parametrize("sources", D.SOURCES)
def test_generator_is_deterministic_by_seed(sources):
    traffic = {"pool": 200, "sources": sources, "zipf_s": 1.0}
    a = D.make(CONFIG, traffic, 2**31 + 5)
    b = D.make(CONFIG, traffic, 2**31 + 5)
    c = D.make(CONFIG, traffic, 2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert a[0].dtype == a[1].dtype == np.float32


def test_every_seed_keeps_one_geometry():
    """The rows are the configuration's (its ``data_seed``); the seed
    draws only the queries."""
    traffic = {"pool": 10, "sources": "uniform"}
    a, qa = D.make(CONFIG, traffic, 1)
    b, qb = D.make(CONFIG, traffic, 2)
    assert np.array_equal(a, b) and not np.array_equal(qa, qb)


def test_uniform_generator_equals_the_programs():
    """A frozen copy: the rows are bit-equal to those of the port's
    generator they were taken from, and the queries are drawn the way
    it draws them."""
    from repro_torch.data.synthetic import clustered
    ds = clustered(2500, 24, 300, seed=9, k_gt=1)
    rng = D.rng_for(9)
    data, assign, n_clusters = D.geometry(rng, 2500, 24)
    src = D.query_sources(rng, assign, n_clusters, 300, sources="uniform")
    assert np.array_equal(ds.data, data)
    assert np.array_equal(ds.queries, D.perturb(rng, data, src, 0.15))
    made, _ = D.make({"data": {"n": 2500, "dim": 24, "data_seed": 9}},
                     {"pool": 5}, 123)
    assert np.array_equal(made, ds.data)


def test_zipf_sources_follow_cluster_popularity():
    rng = np.random.default_rng(3)
    assign = rng.integers(0, 20, size=20000)
    src = D.query_sources(np.random.default_rng(4), assign, 20, 50000,
                          sources="zipf", zipf_s=1.0)
    again = D.query_sources(np.random.default_rng(4), assign, 20, 50000,
                            sources="zipf", zipf_s=1.0)
    assert np.array_equal(src, again)
    share = np.sort(np.bincount(assign[src], minlength=20))[::-1] / 50000
    harmonic = sum(1.0 / r for r in range(1, 21))
    assert share[0] == pytest.approx(1.0 / harmonic, abs=0.01)
    assert share[1] == pytest.approx(0.5 / harmonic, abs=0.01)


def test_the_seed_takes_any_whole_number():
    for seed in (0, -1, 2**31 + 1, 2**70):
        D.rng_for(seed).random()


def _clustered(n, dim, n_queries, seed):
    return D.make({"data": {"n": n, "dim": dim, "data_seed": seed}},
                  {"pool": n_queries}, seed)


def test_exact_topk_equals_numpy_brute_force():
    data, queries = _clustered(2000, 32, 150, seed=5)
    d, i = REF.exact_topk(torch.as_tensor(data), torch.as_tensor(queries), 10)
    full = ((queries.astype(np.float64)[:, None, :]
             - data.astype(np.float64)[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-12)


def test_exact_dists_are_float64_and_mark_bad_ids():
    data, queries = _clustered(500, 8, 4, seed=1)
    ids = torch.tensor([[0, 499, -1], [3, 500, 7]])
    d = REF.exact_dists(torch.as_tensor(data), torch.as_tensor(queries),
                        torch.tensor([2, 3]), ids)
    assert d.dtype == torch.float64
    want = ((queries[2].astype(np.float64) - data[499]) ** 2).sum()
    assert d[0, 1].item() == pytest.approx(want, rel=1e-15)
    assert torch.isnan(d[0, 2]) and torch.isnan(d[1, 1])


def test_pricing_gives_hand_worked_numbers():
    # 3 round trips x 2 us + 10 descriptors x 0.25 us + 25 kB at 12.5 GB/s
    assert net.wire_seconds(3, 10, 25e3) == pytest.approx(10.5e-6)
    nets = [{"round_trips": 3, "descriptors": 10, "bytes": 25e3},
            {"round_trips": 1, "descriptors": 32, "bytes": 0.0}]
    # (10.5 + 2 + 8) us over 5 queries
    assert net.us_per_query(nets, 5) == pytest.approx(4.1)


def test_the_percentile_is_taken_over_every_query():
    walls = [0.1, 0.2, 0.9]
    sizes = [500, 400, 30]
    expanded = np.repeat(walls, sizes)
    for q in (50, 95, 99):
        assert ST.weighted_percentile(walls, sizes, q) == pytest.approx(
            float(np.percentile(expanded, q)))
    # over batches (each once) the 95th would lie between 0.2 and 0.9
    assert ST.weighted_percentile(walls, sizes, 95) == pytest.approx(0.2)
    assert ST.weighted_percentile([1, 2, 3, 4], [1, 1, 1, 1], 50) == 2.5


def _trace():
    """Two spans on the host clock (perf_counter s); device ops launched
    inside and outside them; offset 1000 ns."""
    spans = [{"name": "compute.fetch", "t0": 1e-6, "dur": 2e-6,
              "attrs": {"spans": 4}},
             {"name": "compute.round", "t0": 0.5e-6, "dur": 10e-6,
              "attrs": {}}]
    # (name, is_device, start ns, end ns, correlation)
    events = [("cudaLaunchKernel", False, 2100, 2200, 1),   # in fetch
              ("cudaLaunchKernel", False, 2900, 2950, 2),   # in fetch
              ("cudaLaunchKernel", False, 5000, 5100, 3),   # in round only
              ("gather", True, 3000, 4000, 1),
              ("copy", True, 3500, 4500, 2),
              ("argsort", True, 6000, 9000, 3)]
    return DeviceTrace(events, spans, (1000, 13000), 1000)


def test_trace_gives_device_time_to_the_span_that_launched_it():
    t = _trace()
    assert t.window_s == pytest.approx(12e-6)
    assert t.busy_s == pytest.approx(4.5e-6)           # 3000-4500, 6000-9000
    assert t.layer_device_s("compute.fetch") == pytest.approx(1.5e-6)
    assert t.layer_device_s("compute.round") == pytest.approx(4.5e-6)
    assert t.layer_device_s("compute.nothing") is None
    assert t.top_ops()[0] == ["argsort", pytest.approx(3e-6)]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # 1000-3000 (mid 2000: fetch), 4500-6000 (round), 9000-13000 (mid
    # 11000: round ends at 11500)
    assert gaps["compute.fetch"] == pytest.approx(2e-6)
    assert gaps["compute.round"] == pytest.approx(5.5e-6)


def test_trace_without_launches_gives_no_layer_time():
    t = DeviceTrace([("k", True, 10, 20, 5)], [], (0, 100), 0)
    assert not t.attributed
    assert t.layer_device_s("compute.fetch") is None


def _answers(data, queries, k=3):
    x, q = torch.as_tensor(data), torch.as_tensor(queries)
    d, i = REF.exact_topk(x, q, k)
    qi = np.arange(len(queries))
    return [(qi, d.float().numpy(), i.numpy())], i


LIMITS = {"dist_rel_err": 1e-4, "recall_loss": 0.05}


@pytest.mark.parametrize("fault", ["none", "id_out", "duplicate", "unsorted",
                                   "distance", "shape"])
def test_the_judge_counts_each_broken_guarantee(fault):
    data, queries = _clustered(400, 8, 20, seed=2)
    answers, gt = _answers(data, queries)
    qi, d, g = answers[0]
    d, g = d.copy(), g.copy()
    if fault == "id_out":
        g[4, 1] = 400
    elif fault == "duplicate":
        g[4, 1] = g[4, 0]
    elif fault == "unsorted":
        d[4] = d[4, ::-1]
    elif fault == "distance":
        d[4, 2] *= 1.001
    elif fault == "shape":
        d, g = d[:, :2], g[:, :2]
    v = check.judge([(qi, d, g)], data, queries, gt, k=3,
                    limits=LIMITS, device="cpu")
    want = {"none": (0, 0), "id_out": (1, 0), "duplicate": (1, 0),
            "unsorted": (0, 1), "distance": (0, 0), "shape": (20, 0)}[fault]
    assert (v["numbers"]["bad_rows"][0],
            v["numbers"]["unsorted_rows"][0]) == want
    assert v["correct"] == (fault == "none")
    assert v["failed"] == {"none": 0, "shape": 20}.get(fault, 1)
    if fault == "none":
        assert v["recall_at_10"] == 1.0
        assert v["numbers"]["dist_rel_err"][0] < 1e-6
    if fault == "distance":
        assert v["numbers"]["dist_rel_err"][0] == pytest.approx(1e-3,
                                                                rel=1e-3)


def test_the_judge_holds_which_neighbours_come_back():
    """Real rows with their exact distances, valid, distinct and sorted,
    but not the nearest: only ``recall_loss`` fails."""
    data, queries = _clustered(400, 8, 20, seed=2)
    answers, gt = _answers(data, queries)
    qi = answers[0][0]
    x, q = torch.as_tensor(data), torch.as_tensor(queries)
    d, g = REF.exact_topk(x, q, 6)
    worse = [(qi, d[:, 3:].float().numpy(), g[:, 3:].numpy())]
    v = check.judge(worse, data, queries, gt, k=3, limits=LIMITS,
                    device="cpu")
    assert v["numbers"]["bad_rows"][0] == v["numbers"]["unsorted_rows"][0] == 0
    assert v["numbers"]["dist_rel_err"][0] < 1e-6
    assert v["numbers"]["recall_loss"][0] == pytest.approx(1.0)
    assert not v["correct"] and v["failed"] == 0
    assert v["recall_at_10"] == pytest.approx(0.0)


def test_the_fetch_roofline_counts_the_rows_fetched():
    """The bound counts the real bytes of the partitions fetched in the
    profiled batches (read once, written once), not their padded spans;
    the time is the device time launched in ``compute.fetch``."""
    from bench import registry as REG
    from bench.yardstick import peaks
    ctx = REG.ReadContext(
        config={}, traffic={}, spans=[], trace=_trace(),
        batches=[{"profiled": True, "fetched": [np.array([0, 2])]},
                 {"profiled": False, "fetched": [np.array([1])]}],
        layout={"partition_bytes": np.array([100, 10**6, 300])})
    read = REG.reader("gather_roofline")
    want = 100.0 * 2 * 400 / peaks.HBM_BYTES_S / 1.5e-6
    assert read(ctx) == pytest.approx(want)
    ctx.batches[0]["fetched"] = []
    assert read(ctx) is None
