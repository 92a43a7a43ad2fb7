"""The control of a cell's comparison, and its planted faults: a stand-in
put in the program's place, whose answers go through the same window and
the same judge as a run's and have to come out not correct.

    python3 -m bench.control --workload <cell> --seeds 11,12,13 --seconds 5 [--stand-in half_rows]

prints, for each seed, the compared numbers beside their limits and the
verdict.  The benchmark's own runs never run it.  The default stand-in is
the runner module's ``control``: the configuration's plain reference one
precision below the one the configuration states (for ``search``: the
exact search in bfloat16).  ``--stand-in <name>`` takes one of the runner
module's ``faults`` instead (for ``search``: ``half_rows``, the exact
search over half of the rows, which keeps every row guarantee and loses
neighbours).
"""
from __future__ import annotations

import argparse
import json
import sys

from bench import run as RUN


def control_line(bench: dict, cell_name: str, seed: int, seconds: float,
                 device, bench_dir=None, stand_in: str = "control") -> dict:
    from bench import registry as REG
    bench_dir = bench_dir or REG.BENCH_DIR
    config = REG.config(REG.cell(bench, cell_name)["config"], bench_dir)
    mod = REG.runner(config["runner"], bench_dir)
    stand_in = mod.control if stand_in == "control" else mod.faults[stand_in]
    return RUN.execute(bench, cell_name, seed, seconds, False, device,
                       bench_dir=bench_dir, search=stand_in)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stand-in", default="control",
                    help="control, or a name in the runner's faults")
    args = ap.parse_args(argv)
    from bench import registry as REG
    bench = REG.benchmark()
    if args.device == "cuda":
        RUN.require_cards(int(REG.cell(bench, args.workload)["chips"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        line = control_line(bench, args.workload, seed, args.seconds,
                            args.device, stand_in=args.stand_in)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "stand_in": args.stand_in,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
