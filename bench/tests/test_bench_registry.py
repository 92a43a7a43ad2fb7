"""BENCHMARK.json against the contract, and every piece of a cell found by
its name: a new configuration, traffic mix or per-layer metric is a new
file, with no edit to any other."""
from __future__ import annotations

import json
import re

import pytest

from bench import registry as REG
from bench import run as RUN

BENCH = REG.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == KEYS
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (REG.ROOT / "bench" / "run.py").is_file()
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = json.loads((REG.ROOT / c["file"]).read_text())
        assert sorted(body["reduced"]) == sorted(c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        for cell in m["workloads"]:
            reported = {e["name"] for e in BENCH["end_to_end"]
                        if REG.applies(e, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        e2e = [e for e in BENCH["end_to_end"] if REG.applies(e, cell)]
        assert len(e2e) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_found_by_name(cell):
    w = REG.cell(BENCH, cell)
    config = REG.config(w["config"])
    traffic = REG.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert hasattr(REG.runner(config["runner"]), "Runner")
    assert traffic["batch"] > 0 and traffic["pool"] >= traffic["batch"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_metric_reader_is_found_by_name(metric):
    assert callable(REG.reader(metric))


def test_applies_by_workloads_or_by_moves():
    """A metric's cells are those its ``workloads`` list; a metric with
    none is read in every cell (its reader returns nothing where it finds
    nothing to read)."""
    listed = {"name": "a", "moves": "qps", "workloads": ["x"]}
    free = {"name": "b", "moves": "p95_ms"}
    assert REG.applies(listed, "x")
    assert not REG.applies(listed, "y")
    assert REG.applies(free, "x") and REG.applies(free, "y")


def test_new_files_join_without_edits(tiny_bench):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, and a cell naming them, run with no other file changed."""
    bench, d = tiny_bench
    cfg = json.loads((d / "configs" / "sift-128-hnsw.json").read_text())
    cfg["name"] = "sift-128-scan"
    cfg["engine"]["search_mode"] = "scan"
    (d / "configs" / "sift-128-scan.json").write_text(json.dumps(cfg))
    (d / "traffic" / "zipf-b100.json").write_text(json.dumps(
        {"batch": 100, "pool": 600, "sources": "zipf", "zipf_s": 1.0,
         "warmup_batches": 1, "profile_seconds": 0.5}))
    (d / "metrics" / "batches_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.batches))\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "sift-scan-zipf-b100",
                               "config": "sift-128-scan",
                               "traffic": "zipf-b100", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "bench", "moves": "qps",
                               "workloads": ["sift-scan-zipf-b100"]})
    line = RUN.execute(bench, "sift-scan-zipf-b100", 7, 0.5, True, "cpu",
                       bench_dir=d, log=lambda s: None)
    assert line["correct"]
    assert line["metrics"]["batches_seen"]["value"] >= 1
    assert "route_ms" not in line["metrics"]        # listed for other cells
