"""The JAX package's rows of the paper's evaluation (Fig. 6, Tables 1-2,
the insert study) at the ``quick`` preset, as the port's twins are held
to them: each row's counted fields only, never a clock field.

    PYTHONPATH=src python -m benchmarks.torch_paper_reference

regenerates ``benchmarks/torch_reference/paper_quick.json`` by running
``COMMAND`` (the JAX package on the CPU; a few minutes) in a subprocess
and parsing its CSV lines.  This module imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "benchmarks" / "torch_reference" / "paper_quick.json"
COMMAND = ("REPRO_BENCH_SCALE=quick PYTHONPATH=src JAX_PLATFORMS=cpu "
           "python -m benchmarks.run fig6 tables insert")
INSERT = {"insert/latency": ("n", "net"), "insert/self-recall@1": ("hit",),
          "insert/burst-with-repack": ("self_recall",)}


def counted_fields(name: str) -> tuple:
    """The fields of row ``name`` that are counted (or derived from
    counts alone), which the port must reproduce exactly."""
    if name.startswith("fig6/") and name.endswith("/headline"):
        return ("naive_over_full_net", "nodoorbell_over_full_net",
                "recall_at_ef48")
    if name.startswith("fig6/"):
        return ("recall", "net_us_q", "rtpq")
    if name.startswith("table/"):
        return ("net_us_q", "rtpq", "bytes_q", "recall")
    return INSERT[name]


def counted(row: dict) -> dict:
    """``row``'s name and counted fields."""
    return {"name": row["name"],
            **{k: row[k] for k in counted_fields(row["name"])}}


def parse(text: str) -> list[dict]:
    """The rows of ``benchmarks.run``'s CSV lines
    (``name,us_per_call,key=val ...``); other lines are skipped."""
    rows = []
    for line in text.splitlines():
        name, sep, rest = line.partition(",")
        if not (sep and re.fullmatch(r"(fig6|table|insert)/\S+", name)):
            continue
        us, _, pairs = rest.partition(",")
        row = {"name": name, "us_per_call": us}
        for kv in pairs.split():
            k, _, v = kv.partition("=")
            row[k] = int(v) if re.fullmatch(r"-?\d+", v) else float(v)
        rows.append(row)
    return rows


def row_names(preset: dict) -> list[str]:
    """The rows ``COMMAND`` prints, in order, from the twins' loops."""
    from benchmarks import torch_breakdown, torch_latency_recall
    names = [c[-1] for c in torch_latency_recall.cells(preset=preset)]
    names += [f"fig6/{n}/headline" for n in ("sift", "gist")]
    names += [c[-1] for c in torch_breakdown.cells()]
    return names + list(INSERT)


def load() -> dict:
    return json.loads(PATH.read_text())


def main() -> None:
    env = dict(os.environ, REPRO_BENCH_SCALE="quick", PYTHONPATH="src",
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "fig6", "tables", "insert"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True,
                            check=True).stdout.strip()
    rows = [counted(r) for r in parse(out.stdout)]
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps({"command": COMMAND, "commit": commit,
                                "rows": rows}, indent=1) + "\n")
    print(f"{len(rows)} rows -> {PATH.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
