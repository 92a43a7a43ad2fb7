"""The readers of the program's own counters and spans: each on a
synthetic ``ReadContext`` against hand-worked numbers, the batches the
profiler covered left out, nothing read where the program has no
counters; then a traced run of the sift cell on the CPU, whose fetch
spans' real bytes equal those of the partitions the runner noted."""
from __future__ import annotations

import pytest

from bench import registry as REG
from bench import run as RUN
from bench.yardstick import counters as C
from bench.yardstick.profiling import WindowProfiler

BENCH = REG.benchmark()
SIFT = "sift-hnsw-uniform-b500"
NEW = ("walk_steps", "host_syncs", "sync_wait_ms", "fetch_useful_share")


def _batch(profiled, **stats):
    return {"profiled": profiled, "wall_s": 0.5, "n": 500, "stats": stats}


def _ctx(batches, spans=()):
    return REG.ReadContext(config={}, traffic={}, batches=list(batches),
                           trace=None, spans=list(spans))


def _search(sid, fetches):
    """One batch's spans: its ``compute.search`` root (id ``sid``), a
    round, and per fetch an exact ``compute.fetch`` span with
    ``row_bytes`` over one ``pool.read_spans`` event of ``bytes``."""
    spans, nid = [], sid + 1
    round_id = nid
    for useful, wire, quant in fetches:
        attrs = {"spans": 2, "row_bytes": useful}
        if quant:
            attrs["quant"] = True
        spans.append({"id": nid + 2, "parent": nid + 1,
                      "name": "pool.read_spans", "attrs": {"bytes": wire}})
        spans.append({"id": nid + 1, "parent": round_id,
                      "name": "compute.fetch", "attrs": attrs})
        nid += 2
    spans.append({"id": round_id, "parent": sid, "name": "compute.round",
                  "attrs": {}})
    spans.append({"id": sid, "parent": 0, "name": "compute.search",
                  "attrs": {}})
    return spans


def test_counters_read_the_batches_the_profiler_left():
    ctx = _ctx([_batch(True, walk_steps=9000, host_syncs=9000,
                       sync_wait_s=9.0),
                _batch(False, walk_steps=100, host_syncs=130,
                       sync_wait_s=0.030),
                _batch(False, walk_steps=300, host_syncs=170,
                       sync_wait_s=0.050)])
    assert REG.reader("walk_steps")(ctx) == pytest.approx(200)
    assert REG.reader("host_syncs")(ctx) == pytest.approx(150)
    assert REG.reader("sync_wait_ms")(ctx) == pytest.approx(40.0)


def test_counters_read_every_batch_where_all_were_profiled():
    ctx = _ctx([_batch(True, host_syncs=5, sync_wait_s=0.012,
                       quant="int8"),
                _batch(True, host_syncs=7, sync_wait_s=0.016,
                       quant="int8")])
    assert REG.reader("host_syncs")(ctx) == pytest.approx(6)
    assert REG.reader("sync_wait_ms")(ctx) == pytest.approx(14.0)
    # the int8 path walks no sub-HNSW: no walk steps to read
    assert REG.reader("walk_steps")(ctx) is None


def test_counters_read_nothing_without_the_programs_counters():
    ctx = _ctx([_batch(False, sub_s=0.5), _batch(True, sub_s=0.6)],
               _search(1, [(100, 400, False)]))
    ctx.spans[1]["attrs"].pop("row_bytes")
    for name in NEW:
        assert REG.reader(name)(ctx) is None
    assert REG.reader("fetch_useful_share")(_ctx([])) is None


def test_fetch_useful_share_sums_the_quiet_batches_exact_fetches():
    spans = (_search(1, [(9, 10, False)])                 # profiled
             + _search(20, [(100, 400, False), (50, 200, False),
                            (7, 1000, True)])             # int8 fetch
             + _search(40, [(30, 200, False)]))
    batches = [_batch(True), _batch(False), _batch(False)]
    read = REG.reader("fetch_useful_share")
    assert read(_ctx(batches, spans)) == pytest.approx(
        100.0 * 180 / 800)
    # every batch profiled: every batch read
    every = [_batch(True)] * 3
    assert read(_ctx(every, spans)) == pytest.approx(100.0 * 189 / 810)
    # roots that do not match the batches one to one: every span read
    assert read(_ctx(batches[:2], spans)) == pytest.approx(
        100.0 * 189 / 810)


def test_quiet_spans_follow_each_span_to_its_root():
    spans = _search(1, [(1, 2, False)]) + _search(10, [(3, 4, False)])
    ctx = _ctx([_batch(True), _batch(False)], spans)
    got = {s["id"] for s in C.quiet_spans(ctx)}
    assert got == {s["id"] for s in _search(10, [(3, 4, False)])}


def test_the_new_metrics_list_their_cells():
    by = {m["name"]: m for m in BENCH["per_layer"]}
    assert by["walk_steps"]["workloads"] == [SIFT]
    assert by["fetch_useful_share"]["workloads"] == [SIFT]
    for name in ("host_syncs", "sync_wait_ms"):
        assert set(by[name]["workloads"]) == {
            w["name"] for w in BENCH["workloads"]}


def test_a_traced_run_reads_the_counters(tiny_bench):
    bench, d = tiny_bench
    line = RUN.execute(bench, SIFT, 2**31 + 17, 0.5, True, "cpu",
                       bench_dir=d, log=lambda s: None)
    assert line["correct"]
    m = line["metrics"]
    assert set(NEW) <= set(m)
    assert m["walk_steps"]["value"] > 0
    assert m["host_syncs"]["value"] > m["walk_steps"]["value"]
    assert m["sync_wait_ms"]["value"] >= 0
    assert 0 < m["fetch_useful_share"]["value"] < 100


def test_fetch_row_bytes_equal_the_noted_partitions(tiny_bench):
    """The exact fetch spans' ``row_bytes`` over the window equal the
    layout's ``partition_bytes`` of the partitions the runner noted."""
    from repro_torch.obs.trace import TRACER
    _, d = tiny_bench
    cell = REG.cell(BENCH, SIFT)
    run = REG.runner("search", d).Runner(
        REG.config(cell["config"], d), REG.traffic(cell["traffic"], d),
        2**31 + 3, "cpu", trace=True)
    run.setup()
    TRACER.configure(capacity=1 << 20)
    try:
        res = run.window(0.5, WindowProfiler(False, 0.0, "cpu"))
        spans = TRACER.snapshot()
    finally:
        TRACER.disable()
    part = run.layout()["partition_bytes"]
    noted = sum(int(part[p].sum()) for b in res["batches"]
                for p in b["fetched"])
    got = sum(s["attrs"]["row_bytes"] for s in spans
              if s["name"] == "compute.fetch")
    assert noted > 0 and got == noted
    assert all("host_syncs" in b["stats"] for b in res["batches"])
