"""The port's benchmarks against the JAX package's, on the CPU.

``benchmarks/torch_quant.py --smoke`` must give the counted rows of the
committed ``benchmarks/baselines/BENCH_quant.json`` exactly (MB, MB saved,
round trips, tier slots, recall), and ``benchmarks/torch_throughput.py``
the counted rows (round trips, cache hits, fetches, bytes, modelled
network time) of the JAX ``benchmarks/throughput.py`` at the same tiny
size.  ``benchmarks/torch_pool.py --smoke`` must give every field of
``BENCH_pool.json``'s ``rows``, ``shard_rows``, ``transport_rows``,
``chaos`` and ``chaos_latency`` but the host clock and the servers'
ports (all counted, measured on the wire or on the modeled clock),
``benchmarks/torch_ingest.py --smoke`` every field of
``BENCH_ingest.json``'s ``recovery`` but the wall clock, and
``benchmarks/torch_serving.py --smoke`` its ``counted`` table.  Only
counted numbers are compared: walls and times are the CPU's.
"""
import contextlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
COUNTED = ("quant", "recall", "mbytes", "mbytes_saved", "round_trips",
           "exact_frac", "rerank_m", "quant_slots", "exact_slots",
           "quant_kernel", "kernel_active", "bytes_reduction")
TINY = dict(sift_n=1000, n_queries=32, batch=32, n_rep=8)
# fields of the pool and ingest tables read off the host's clock, or the
# port a server was given
CLOCK = {"wall_s", "p50_ms", "p99_ms", "kill_batch_ms", "endpoint",
         "recover_wall_s"}


@pytest.fixture(scope="module")
def benchmarks():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import torch_quant, torch_throughput
    finally:
        sys.path.remove(str(ROOT))
    return torch_quant, torch_throughput


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise in the test after ``seconds``: a stuck pool server's socket
    cannot hold the run."""
    def boom(*_):
        raise TimeoutError(f"ran past {seconds} s")
    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _baseline(name: str) -> dict:
    return json.loads((ROOT / "benchmarks" / "baselines" / name).read_text())


def _import_bench(name: str):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(f"benchmarks.{name}", fromlist=[name])
    finally:
        sys.path.remove(str(ROOT))


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


def test_torch_pool_smoke_reproduces_the_baseline(tmp_path):
    """Every field of the fabric sweep, the shard x placement sweep, the
    transport table (local, sim_rdma, remote over loopback and tcp), the
    kill -9 chaos row and the straggler chaos row but the host clock and
    the server's port equals the committed baseline's: counted verbs, the
    modeled clock, the measured wire bytes and frames, the failover
    counters, placement, migrations and the per-shard staged bytes."""
    torch_pool = _import_bench("torch_pool")
    out = tmp_path / "BENCH_torch_pool.json"
    with time_limit(240):                  # forks four pool servers
        blob = torch_pool.run(smoke=True, out=str(out), device="cpu")
    assert json.loads(out.read_text()) == blob
    base = _baseline("BENCH_pool.json")
    assert (blob["n"], blob["n_rep"], blob["n_batches"]) == (
        base["n"], base["n_rep"], base["n_batches"])
    for table in ("rows", "shard_rows", "transport_rows"):
        assert len(blob[table]) == len(base[table]), table
        for got, want in zip(blob[table], base[table]):
            assert set(got) == set(want), table
            for key in set(want) - CLOCK:
                assert got[key] == want[key], (table, key)
    assert set(blob["chaos"]) == set(base["chaos"])
    for key in set(base["chaos"]) - CLOCK:
        assert blob["chaos"][key] == base["chaos"][key], key
    assert blob["chaos_latency"] == base["chaos_latency"]
    assert [r.get("bearer") for r in blob["transport_rows"]] == [
        None, None, "loopback", "tcp"]
    assert "not_ported" not in blob


def test_torch_ingest_smoke_gives_the_recovery_row(tmp_path):
    """``benchmarks/torch_ingest.py --smoke --device cpu``, run as its
    command line: the ``recovery`` row (a durable server killed with
    SIGKILL and recovered from its WAL) equals ``BENCH_ingest.json``'s but
    the wall clock, and ``load_rows`` holds one bit-identical row."""
    out = tmp_path / "BENCH_torch_ingest.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "torch_ingest.py"),
         "--smoke", "--device", "cpu", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    blob = json.loads(out.read_text())
    want = _baseline("BENCH_ingest.json")["recovery"]
    got = blob["recovery"]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in CLOCK} == {
        k: v for k, v in want.items() if k not in CLOCK}
    assert [r["bit_identical"] for r in blob["load_rows"]] == [True]


def test_torch_serving_smoke_reproduces_the_counted_table(tmp_path):
    """The counted serial-vs-batched table equals ``BENCH_serving.json``'s
    (trips, descriptors and KB a query, the mean fused batch); the
    wall-clock rows exist and are not compared.  ``--trace`` writes a
    trace the port's report CLI reads."""
    torch_serving = _import_bench("torch_serving")
    from repro_torch.obs import report
    out = tmp_path / "BENCH_torch_serving.json"
    trace = tmp_path / "serving_trace.json"
    blob = torch_serving.run(smoke=True, out=str(out), device="cpu",
                             trace_out=str(trace))
    base = _baseline("BENCH_serving.json")
    assert blob["counted"] == base["counted"]
    for key in ("n", "seed", "clients", "per_client", "waves"):
        assert blob[key] == base[key], key
    assert [(r["clients"], r["impl"]) for r in blob["rows"]] == [
        (r["clients"], r["impl"]) for r in base["rows"]]
    assert report.main([str(trace)]) == 0
