"""Roofline of the port's dry-run cells, with the H100's own peaks.

Twin of ``benchmarks/roofline.py``, over the JSONL that
``python -m repro_torch.launch.dryrun --out F`` writes (the port's meshed
steps traced on the fake backend, layer units extrapolated to the full
depth).  Per (arch x shape x mesh) cell, each a device's:

  compute    = FLOPs / 989e12   (H100 SXM dense bf16 tensor-core peak)
  memory     = bytes accessed / 3.35e12   (HBM3)
  collective = ring-model wire bytes / 450e9   (NVLink 4, one direction)

FLOPs count the products only (``FlopCounterMode``); bytes accessed
every non-view op's inputs and outputs.  Also: MODEL_FLOPS = 6ND (train)
/ 2ND (serve), the useful-work ratio MODEL_FLOPS / (FLOPs x devices),
the dominant term and the roofline fraction (the model-ideal compute
time over the dominant term's).  The reference's post-HLO collective
re-parse (``benchmarks/reparse_collectives.py``) has no twin: torch has
no HLO text, and the dry run counts its collectives as it traces.

    PYTHONPATH=src python -m benchmarks.torch_roofline dryrun.jsonl [--mesh multi]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16
HBM_BW = 3.35e12         # H100 SXM HBM3, B/s
LINK_BW = 450e9          # H100 SXM NVLink 4, B/s one direction


@dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_dev: float
    bytes_dev: float
    wire_dev: float
    model_flops: float
    n_collectives: int

    @property
    def t_compute(self):
        return self.flops_dev / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_dev / HBM_BW

    @property
    def t_collective(self):
        return self.wire_dev / LINK_BW

    @property
    def t_dominant(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_ratio(self):
        total = self.flops_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.t_dominant if self.t_dominant else 0.0


def load_cells(path: str, mesh: str = "single") -> list[Cell]:
    cells = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("status") != "ok" or r.get("mesh") != mesh:
                continue
            coll = r["collectives"]
            cells.append(Cell(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                chips=r["n_devices"], flops_dev=float(r["cost"]["flops"]),
                bytes_dev=float(r["cost"]["bytes accessed"]),
                wire_dev=float(coll["wire_bytes_per_device"]),
                model_flops=float(r["model_flops"]),
                n_collectives=int(coll["n_collectives"])))
    return cells


def run(path: str, mesh: str = "single") -> list[dict]:
    rows = []
    for c in sorted(load_cells(path, mesh), key=lambda c: (c.arch, c.shape)):
        rows.append(dict(
            name=f"roofline/{c.arch}/{c.shape}/{c.mesh}",
            us_per_call=round(c.t_dominant * 1e6, 1),
            t_compute_s=f"{c.t_compute:.3e}",
            t_memory_s=f"{c.t_memory:.3e}",
            t_collective_s=f"{c.t_collective:.3e}",
            dominant=c.dominant, useful=round(c.useful_ratio, 3),
            roofline_frac=round(c.roofline_fraction, 3)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", help="the port's dry-run JSONL")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    for row in run(args.jsonl, args.mesh):
        print(json.dumps(row))
    cells = load_cells(args.jsonl, args.mesh)
    print("# worst roofline fractions:")
    for c in sorted(cells, key=lambda c: c.roofline_fraction)[:5]:
        print(f"#   {c.arch}/{c.shape}: {c.roofline_fraction:.3f} "
              f"(dominant: {c.dominant})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
