"""The JAX package's dry-run numbers, as the port's dry runs are held to
them: every (arch x shape x mesh) cell's partition specs and per-device
argument bytes by kind (from ``repro.train.train_step.make_step``'s
shardings on a ``jax.sharding.AbstractMesh``: names and sizes, no
devices), the compiled decode cells' ``argument_size_bytes``
(``repro.launch.dryrun.run_cell`` on 512 forced host devices; its train
and prefill cells do not lower on jax 0.9, whose ``make_mesh`` gives
Explicit axes that its ``with_sharding_constraint`` refuses), and the
twelve ``repro.launch.dryrun_dhnsw`` rows' collective fields.

    PYTHONPATH=src python -m benchmarks.torch_dryrun_reference

regenerates ``benchmarks/torch_reference/dryrun.json`` by running
``torch_reference/dryrun_jax.py`` (the JAX package on the CPU, ~45 s)
in a subprocess.  This
module imports neither JAX nor the JAX package; ``chip_smoke.py`` reads
the file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATH = ROOT / "benchmarks" / "torch_reference" / "dryrun.json"
DHNSW_FIELDS = ("coll_kinds", "wire_dev", "n_collectives", "arg_bytes")

JAX_SCRIPT = ROOT / "benchmarks" / "torch_reference" / "dryrun_jax.py"


def generate(archs: str = "all", full: bool = True) -> dict:
    """The reference's numbers for ``archs`` ("all" or comma-separated
    ids); ``full`` adds the compiled decode cells and the d-HNSW rows."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(JAX_SCRIPT), archs,
                          "1" if full else "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    line = next(l for l in out.stdout.splitlines() if l.startswith("JSON "))
    return json.loads(line[5:])


def load() -> dict:
    return json.loads(PATH.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.parse_args(argv)
    ref = generate()
    PATH.write_text(json.dumps(ref, indent=1, sort_keys=True) + "\n")
    print(f"{PATH}: {len(ref['cells'])} cells, {len(ref['dhnsw'])} d-HNSW "
          f"rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
