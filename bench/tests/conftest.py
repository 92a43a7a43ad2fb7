"""Shared fixtures: a copy of ``bench/`` whose configurations and traffic
mixes are cut to a size the CPU runs in seconds (the tests drive the
whole harness there, the program's kernels through their plain
versions)."""
from __future__ import annotations

import json
import shutil

import pytest

from bench import registry as REG

TINY_ROWS = {"sift-128-hnsw": 3000, "gist-960-int8": 2000}
TINY_PARTITIONS = 16
TINY_POOL, TINY_BATCH = 600, 100


def shrink(bench_dir) -> None:
    """Cut every configuration and traffic mix under ``bench_dir``."""
    for path in (bench_dir / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["data"]["n"] = TINY_ROWS.get(c["name"], 2000)
        c["engine"]["n_rep"] = TINY_PARTITIONS
        path.write_text(json.dumps(c))
    for path in (bench_dir / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(pool=TINY_POOL, batch=TINY_BATCH, profile_seconds=0.5)
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_bench(tmp_path):
    """(BENCHMARK.json as a dict, a shrunk copy of ``bench/``)."""
    d = tmp_path / "bench"
    shutil.copytree(REG.BENCH_DIR, d,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(d)
    return REG.benchmark(), d


@pytest.fixture
def card():
    """The CUDA device; skips where torch sees none (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

