"""Device time of the port's kernel spans, beside their host time.

A kernel span (``kernel.quant_topk``, ``kernel.distance_topk``,
``kernel.decode_attention``) never waits for the card: its ``dur`` is the
host's launch only, and ``attrs["device_s"]`` the kernel's time on the
card, from a pair of CUDA events (:meth:`repro_torch.obs.trace.Tracer.
device_span`).  ``python -m repro_torch.obs.device_time trace.json``
prints, per phase, every span name that carries ``device_s`` with its
host and device totals: the reading for a kernel A/B.
:mod:`repro_torch.obs.report` (the reference's report, unchanged) gives
the host's self time per stage.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.report import by_phase
from repro_torch.obs.trace import load_trace


def device_table(spans: List[Dict[str, Any]]) -> List[Tuple[str, str, int, float, float]]:
    """Aggregate the spans that carry ``device_s`` to ``(tier, name, count,
    total_dur_s, total_device_s)`` rows, by device time descending."""
    agg: Dict[Tuple[str, str], List[float]] = {}
    for s in spans:
        if "device_s" not in s["attrs"]:
            continue
        row = agg.setdefault((s["tier"], s["name"]), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s["dur"]
        row[2] += float(s["attrs"]["device_s"])
    rows = [(tier, name, int(c), dur, dev) for (tier, name), (c, dur, dev) in agg.items()]
    rows.sort(key=lambda r: -r[4])
    return rows


def render(spans: List[Dict[str, Any]], top: int = 20) -> str:
    """One table a phase of the spans that carry ``device_s``; empty when
    none does (a CPU run, or a trace of the reference)."""
    lines: List[str] = []
    phases = by_phase(spans)
    for phase in sorted(phases):
        rows = device_table(phases[phase])
        if not rows:
            continue
        lines.append(f"== device time, phase: {phase} (CUDA events; host_ms is the launch) ==")
        lines.append(f"{'tier':<8} {'span':<28} {'count':>7} {'host_ms':>10} "
                     f"{'device_ms':>10} {'device_us/call':>15}")
        for tier, name, cnt, dur, dev in rows[:top]:
            lines.append(f"{tier:<8} {name:<28} {cnt:>7} {dur * 1e3:>10.3f} "
                         f"{dev * 1e3:>10.3f} {dev / cnt * 1e6:>15.1f}")
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: ``python -m repro_torch.obs.device_time trace.json``."""
    ap = argparse.ArgumentParser(description="Device time of a port trace's kernel spans")
    ap.add_argument("trace", help="Chrome-trace JSON written by TRACER.save()")
    ap.add_argument("--top", type=int, default=20, help="rows per table")
    args = ap.parse_args(argv)
    text = render(load_trace(args.trace), top=args.top)
    print(text or f"{args.trace}: no span carries device_s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
