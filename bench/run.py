"""Run one benchmark cell once and print its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, runner and per-layer
readers are found by name under ``bench/`` (``bench/registry.py``).

The run makes its data and queries from ``--seed``, sets up the program
(the index build, the kernels, warm-up: ``setup_s`` runs from the start of
this script to the first timed batch), measures for ``--seconds``, reads
the peak device memory, frees the program, and has the plain reference
judge every answer of the window.  ``--trace 1`` turns on the program's
``TRACER`` and ``torch.profiler`` and prints the cell's per-layer metrics
instead of its end-to-end ones.

The last lines on standard error give each compared number beside its
limit; the last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` with
``--trace 1``) and ``checks`` last.  The run exits non-zero and prints no
result when the card (or enough cards) is missing, when the program cannot
be imported, or when the process holds JAX or the JAX package after the
window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The cell asks for more cards than torch sees."""


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` (compared whole, so
    ``repro_torch`` is not ``repro``) that the benchmark may not hold."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark "
                       "runs only on a CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def execute(bench: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, device, *, t_start: float = T_START,
            bench_dir: Path = None, search=None, wrap=None,
            log=None) -> dict:
    """Run one cell on ``device`` and return the result line (a dict, its
    keys in print order).  ``search`` stands in for the program (the
    control), ``wrap`` wraps the program's search (the fault tests): see
    the runner.  ``log`` takes the lines for standard error."""
    import torch

    from bench import registry as REG
    from bench.yardstick.profiling import WindowProfiler
    bench_dir = bench_dir or REG.BENCH_DIR
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = REG.cell(bench, cell_name)
    config = REG.config(cell["config"], bench_dir)
    traffic = REG.traffic(cell["traffic"], bench_dir)
    device = torch.device(device)
    on_card = device.type == "cuda"
    reported = {m["name"] for m in bench["end_to_end"]
                if REG.applies(m, cell_name)}

    run = REG.runner(config["runner"], bench_dir).Runner(
        config, traffic, seed, device, search=search, wrap=wrap,
        trace=trace)
    profiler = WindowProfiler(trace, float(traffic.get("profile_seconds",
                                                       seconds)), device)
    if trace:
        from repro_torch.obs.trace import TRACER
        profiler.warm()
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {cell_name} seed={seed}: set-up {setup_s:.3f} s")

    if trace:
        TRACER.configure(enabled=True, capacity=1 << 20)
    res = run.window(seconds, profiler)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    walls = sorted(b["wall_s"] for b in res["batches"])
    log(f"[bench] window {res['window_s']:.3f} s: {len(walls)} batches, "
        f"wall min {walls[0]:.6f} median {walls[len(walls) // 2]:.6f} max "
        f"{walls[-1]:.6f} s")
    breakdown = None
    per_layer = {}
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        spans = TRACER.snapshot()
        TRACER.disable()
        t0 = time.perf_counter()
        dtrace = profiler.device_trace(spans)
        ctx = REG.ReadContext(config=config, traffic=traffic,
                              batches=res["batches"], trace=dtrace,
                              spans=spans, layout=run.layout())
        for m in bench["per_layer"]:
            if REG.applies(m, cell_name):
                v = REG.reader(m["name"], bench_dir)(ctx)
                if v is not None:
                    per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace is not None:
            device_info["busy_s"] = dtrace.busy_s
            device_info["window_s"] = dtrace.window_s
            breakdown = {"device_ops": dtrace.top_ops(),
                         "idle_gaps": dtrace.idle_gaps()}
            prof_walls = [b["wall_s"] for b in res["batches"] if b["profiled"]]
            rest = [b["wall_s"] for b in res["batches"] if not b["profiled"]]
            log(f"[bench] trace: {dtrace.n_ops} device ops in "
                f"{dtrace.window_s:.3f} s profiled ({len(prof_walls)} of "
                f"{len(res['batches'])} batches; mean batch "
                f"{sum(prof_walls) / max(len(prof_walls), 1):.6f} s profiled"
                f", {sum(rest) / max(len(rest), 1):.6f} s not), launches "
                f"attributed: {dtrace.attributed}, read in "
                f"{time.perf_counter() - t0:.1f} s | {power_limit()}")

    run.free()
    verdict = run.judge(res["answers"])
    attempted = sum(b["n"] for b in res["batches"])
    metrics = {}
    if not trace:
        e2e = run.end_to_end(res, verdict)
        e2e["setup_s"] = (setup_s, "s")
        for m in bench["end_to_end"]:
            if m["name"] in reported and m["name"] in e2e:
                value, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        metrics = per_layer
    line = {"correct": bool(verdict["correct"]), "attempted": attempted,
            "failed": int(verdict["failed"]), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in verdict["numbers"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import registry as REG
    bench = REG.benchmark()
    cell = REG.cell(bench, args.workload)
    try:
        require_cards(int(cell["chips"]))
    except NoDevice as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the program: fail here without it)
    line = execute(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"[bench] the process holds {bad} after the window: the "
              "benchmark may not load JAX or the JAX package", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
