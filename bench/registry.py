"""Find the pieces of a cell by name.

A cell is an entry of ``workloads`` in the root ``BENCHMARK.json``; it
names a configuration (``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``).  A configuration names the runner that
drives it (``bench/runners/<runner>.py``).  A per-layer metric is read by
``bench/metrics/<name>.py``.  Nothing here lists them: a new file is found
by its name.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """The root ``BENCHMARK.json``."""
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``bench/runners/<name>.py``."""
    return _module(bench_dir / "runners" / f"{name}.py",
                   f"bench_runner_{name}")


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return _module(bench_dir / "metrics" / f"{name}.py",
                   f"bench_metric_{name}").read


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric belongs in a cell's line: the cells its
    ``workloads`` list; without one, every cell."""
    return cell_name in metric.get("workloads", [cell_name])


@dataclass
class ReadContext:
    """What a per-layer reader reads in a traced run.

    ``batches``: one dict a batch of the window (``wall_s``, ``n``,
    ``stats`` as the program returned them, ``profiled``: inside the
    profiler's part of the window).  ``trace``: a
    ``yardstick.trace.DeviceTrace`` of the profiled part, or None where
    the profiler recorded no device operation.  ``spans``: the program's
    ``TRACER`` spans of the whole window.  ``layout``: shape numbers of
    the index the runner built."""
    config: dict
    traffic: dict
    batches: list
    trace: Optional[object]
    spans: list
    layout: dict = field(default_factory=dict)
