"""The port's benchmarks against the JAX package's, on the CPU.

``benchmarks/torch_quant.py --smoke`` must give the counted rows of the
committed ``benchmarks/baselines/BENCH_quant.json`` exactly (MB, MB saved,
round trips, tier slots, recall), and ``benchmarks/torch_throughput.py``
the counted rows (round trips, cache hits, fetches, bytes, modelled
network time) of the JAX ``benchmarks/throughput.py`` at the same tiny
size.  Only counted numbers are compared: walls and times are the CPU's.
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
COUNTED = ("quant", "recall", "mbytes", "mbytes_saved", "round_trips",
           "exact_frac", "rerank_m", "quant_slots", "exact_slots",
           "quant_kernel", "kernel_active", "bytes_reduction")
TINY = dict(sift_n=1000, n_queries=32, batch=32, n_rep=8)


@pytest.fixture(scope="module")
def benchmarks():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import torch_quant, torch_throughput
    finally:
        sys.path.remove(str(ROOT))
    return torch_quant, torch_throughput


def test_torch_quant_smoke_reproduces_the_baseline(benchmarks, tmp_path):
    torch_quant, _ = benchmarks
    out = tmp_path / "BENCH_torch_quant.json"
    blob = torch_quant.run(smoke=True, out=str(out), device="cpu")
    assert json.loads(out.read_text()) == blob
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_quant.json").read_text())
    assert (blob["n"], blob["n_rep"], blob["n_batches"]) == (
        base["n"], base["n_rep"], base["n_batches"])
    assert len(blob["rows"]) == len(base["rows"]) == 4
    for got, want in zip(blob["rows"], base["rows"]):
        for key in COUNTED:
            assert got.get(key) == want.get(key), (want["quant"], key)
    assert blob["kernel"]["id_match"] == 1.0
    assert blob["kernel"]["impl"] == "plain"


@pytest.fixture()
def ref_throughput(monkeypatch):
    """The JAX ``benchmarks/throughput.py`` at the tiny preset."""
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common, throughput
    finally:
        sys.path.remove(str(ROOT))
    for key, val in TINY.items():
        monkeypatch.setitem(common.P, key, val)
    common.dataset.cache_clear()
    yield throughput
    common.dataset.cache_clear()


def test_torch_throughput_counted_rows_match_reference(benchmarks,
                                                       ref_throughput):
    _, torch_throughput = benchmarks
    preset = dict(torch_throughput.P, **TINY)
    got = torch_throughput.run(preset=preset, device="cpu")
    want = ref_throughput.run()
    assert [r["name"] for r in got][:-2] == [r["name"] for r in want][:-2]
    for g, w in zip(got, want):
        if w["name"].startswith("kernel/"):
            continue
        counted = {"rtpq", "hits", "fetches", "bytes", "trips",
                   "net_us"} & set(w)
        assert counted, w["name"]
        for key in counted:
            assert g[key] == w[key], (w["name"], key)
    assert [r["name"] for r in got[-2:]] == ["kernel/distance_topk/ref",
                                             "kernel/distance_topk/plain"]
    assert all(r["us_per_call"] > 0 for r in got[-2:])
    # the doorbell rows also carry the counted stats phase 7 of
    # chip_smoke.py compares with the exact scan batch
    db16 = next(r for r in got if r["name"] == "doorbell/width16")
    assert {"bytes", "hits", "fetches"} <= set(db16)


def test_torch_throughput_serves_a_prebuilt_index(benchmarks):
    """With an index the engines are adopted, not rebuilt: the counted
    rows equal those of the engines' own builds."""
    _, torch_throughput = benchmarks
    from repro_torch import DHNSWEngine, EngineConfig
    preset = dict(torch_throughput.P, **TINY)
    ds = torch_throughput.dataset(preset)
    eng = DHNSWEngine(EngineConfig(n_rep=TINY["n_rep"], seed=0),
                      device="cpu").build(ds.data)
    index = (eng.meta, eng.store, ds.data)
    got = torch_throughput.run(index, preset=preset, ds=ds, device="cpu")
    want = torch_throughput.run(preset=preset, device="cpu")
    for g, w in zip(got[:-2], want[:-2]):
        assert {k: v for k, v in g.items() if k not in ("us_per_call",
                                                        "qps_model",
                                                        "qps_wall")} == {
            k: v for k, v in w.items() if k not in ("us_per_call",
                                                    "qps_model", "qps_wall")}
    with pytest.raises(ValueError, match="partitions"):
        torch_throughput.run(index, preset=dict(preset, n_rep=4), ds=ds,
                             device="cpu")
