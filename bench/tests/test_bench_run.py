"""The harness end to end: the result line, the refusal without a card,
what the process may import, and that the comparison fails the control
and each fault a search cell can have.  On the CPU at a tiny size; the
``gpu`` tests run a short, small run of each cell on the card."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from bench import registry as REG
from bench import run as RUN
from bench.runners import search as SEARCH

BENCH = REG.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
QUIET = dict(log=lambda s: None)


def _keys(line: dict) -> list:
    want = ["correct", "attempted", "failed", "metrics", "device"]
    return want + (["breakdown"] if "breakdown" in line else []) + ["checks"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(tiny_bench, cell, trace):
    bench, d = tiny_bench
    line = RUN.execute(bench, cell, 2**31 + 11, 0.5, bool(trace), "cpu",
                       bench_dir=d, **QUIET)
    assert list(line) == _keys(line)
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] % 100 == 0 and line["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in BENCH[kind]}
    assert set(line["metrics"]) <= names
    if not trace:
        assert {"qps", "recall_at_10", "net_us_per_query",
                "setup_s"} <= set(line["metrics"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"bad_rows", "unsorted_rows",
                                   "dist_rel_err", "recall_loss"}


def test_main_prints_checks_last_then_the_line(tiny_bench, monkeypatch,
                                               capsys):
    bench, d = tiny_bench
    real = RUN.execute
    monkeypatch.setattr(RUN, "require_cards", lambda chips: None)
    monkeypatch.setattr(RUN, "execute", lambda *a, **k: real(
        bench, a[1], a[2], a[3], a[4], "cpu", bench_dir=d))
    assert RUN.main(["--workload", CELLS[0], "--seed", "5", "--seconds",
                     "0.3", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == _keys(line)
    tail = err.strip().splitlines()[-5:]
    assert [t.split()[1] for t in tail] == ["bad_rows", "unsorted_rows",
                                            "dist_rel_err", "recall_loss",
                                            "correct"]


def test_without_a_card_the_run_exits_with_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert RUN.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_the_command_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=REG.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


FORBID = "{m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', " \
         "'flax', 'repro'%s}"


def _modules_after(code: str, extra: str = "") -> str:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nprint(sorted(" + FORBID % extra
         + "))"], cwd=REG.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package(tiny_bench):
    """A whole run in a fresh process (the harness, the program, the
    reference), then the top-level names in ``sys.modules``, compared
    whole: ``repro_torch`` is the program, ``repro`` the JAX package."""
    _, d = tiny_bench
    code = ("import sys; sys.path[:0] = ['src']\n"
            "from bench import registry, run\n"
            f"run.execute(registry.benchmark(), {CELLS[0]!r}, 3, 0.3, True,"
            f" 'cpu', bench_dir=__import__('pathlib').Path({str(d)!r}),"
            " log=lambda s: None)\n"
            "assert 'repro_torch' in sys.modules\n"
            "assert run.forbidden_modules() == []")
    assert _modules_after(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['src']\n"
            "import bench.reference.exact_knn, bench.yardstick.check")
    assert _modules_after(code, ", 'repro_torch'") == "[]"


def test_forbidden_names_are_compared_whole():
    assert RUN.forbidden_modules(["repro_torch.core", "reprox", "jaxtyping"
                                  ]) == []
    assert RUN.forbidden_modules(["repro.core", "jax._src", "flax"]) == [
        "flax", "jax", "repro"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(tiny_bench, cell):
    """The reference in bfloat16 in the program's place."""
    bench, d = tiny_bench
    line = RUN.execute(bench, cell, 2**31 + 21, 0.3, False, "cpu",
                       bench_dir=d, search=SEARCH.control, **QUIET)
    v, lim = (line["checks"]["dist_rel_err"][x] for x in ("value", "limit"))
    assert not line["correct"] and v > 10 * lim


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_rows_comes_out_not_correct(tiny_bench, cell):
    """The planted fault that keeps every row guarantee: true distances
    of wrong neighbours.  Only ``recall_loss`` catches it."""
    bench, d = tiny_bench
    line = RUN.execute(bench, cell, 2**31 + 22, 0.3, False, "cpu",
                       bench_dir=d, search=SEARCH.faults["half_rows"],
                       **QUIET)
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert not line["correct"] and line["failed"] == 0
    assert checks["dist_rel_err"][0] <= checks["dist_rel_err"][1]
    assert checks["recall_loss"][0] > 0.4 > checks["recall_loss"][1]


def _half(search):
    """Half of each batch left out: its rows take the other half's."""
    def f(q, k):
        h = len(q) // 2
        d, g, st = search(q[:h], k)
        return np.concatenate([d, d]), np.concatenate([g, g]), st
    return f


def _altered(search):
    """One answer altered where it is produced: the first id of the third
    batch."""
    calls = []

    def f(q, k):
        d, g, st = search(q, k)
        calls.append(1)
        if len(calls) == 3:
            g = g.copy()
            g[0, 0] = g[0, 1]
        return d, g, st
    return f


def _stale(search):
    """A step that returns its state unchanged: every batch after the
    first gets the first batch's answers."""
    first = []

    def f(q, k):
        if not first:
            first.append(search(q, k))
        return first[0]
    return f


@pytest.mark.parametrize("fault", [_half, _altered, _stale],
                         ids=["half", "altered", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_search_comes_out_not_correct(tiny_bench, cell, fault):
    """The rest of a run, on the CPU, with the timed path broken under
    the harness."""
    bench, d = tiny_bench
    line = RUN.execute(bench, cell, 2**31 + 31, 0.3, False, "cpu",
                       bench_dir=d, wrap=fault, **QUIET)
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(tiny_bench, card, cell):
    """A short run of each cell, cut small, on the card: the kernels, the
    profiler and the readers."""
    bench, d = tiny_bench
    line = RUN.execute(bench, cell, 2**31 + 41, 1.0, False, card,
                       bench_dir=d, **QUIET)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    traced = RUN.execute(bench, cell, 2**31 + 42, 1.0, True, card,
                         bench_dir=d, **QUIET)
    assert traced["correct"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    listed = {m["name"] for m in BENCH["per_layer"]
              if cell in m["workloads"]}
    assert set(traced["metrics"]) == listed
    for name, m in traced["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
    ctl = RUN.execute(bench, cell, 2**31 + 43, 1.0, False, card,
                      bench_dir=d, search=SEARCH.control, **QUIET)
    assert not ctl["correct"]
    half = RUN.execute(bench, cell, 2**31 + 44, 1.0, False, card,
                       bench_dir=d, search=SEARCH.faults["half_rows"],
                       **QUIET)
    assert not half["correct"]
