"""Per-stage breakdown reports over a saved trace.

``python -m repro.obs.report trace.json`` aggregates *self time* (span
duration minus the duration of its children) per stage name and prints a
breakdown table per phase, naming the dominant stage.  When the trace
contains both a ``serial`` and a ``batched`` phase (the serving benchmark
emits these) it additionally prints a per-request gap table: the stages
whose per-request self time grew the most going from serial to batched —
the direct diagnosis for a batched-vs-serial slowdown.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import load_trace

#: Span name counted as one end-to-end request when normalising per request.
REQUEST_SPAN = "request"


def self_times(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Annotate each span with ``self`` = dur minus the dur of its children."""
    child_dur: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["parent"]:
            child_dur[s["parent"]] += s["dur"]
    out = []
    for s in spans:
        t = dict(s)
        t["self"] = max(s["dur"] - child_dur.get(s["id"], 0.0), 0.0)
        out.append(t)
    return out


def by_phase(spans: Iterable[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    """Group spans by their ``attrs["phase"]`` tag ("-" when untagged)."""
    phases: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for s in spans:
        phases[str(s["attrs"].get("phase", "-"))].append(s)
    return phases


def stage_table(spans: List[Dict[str, Any]]) -> List[Tuple[str, str, int, float, float]]:
    """Aggregate to ``(tier, name, count, total_self_s, total_dur_s)`` rows.

    Rows are sorted by total self time, descending — the first row is the
    dominant stage.
    """
    agg: Dict[Tuple[str, str], List[float]] = {}
    for s in spans:
        key = (s["tier"], s["name"])
        row = agg.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s["self"]
        row[2] += s["dur"]
    rows = [(tier, name, int(c), st, dur) for (tier, name), (c, st, dur) in agg.items()]
    rows.sort(key=lambda r: -r[3])
    return rows


def request_count(spans: List[Dict[str, Any]]) -> int:
    """Count end-to-end ``request`` spans in a phase (0 when absent)."""
    return sum(1 for s in spans if s["name"] == REQUEST_SPAN)


def gap_table(
    a: List[Dict[str, Any]], b: List[Dict[str, Any]]
) -> List[Tuple[str, str, float, float, float]]:
    """Per-request self-time deltas between phase *a* and phase *b*.

    Returns ``(tier, name, a_ms_per_req, b_ms_per_req, delta_ms)`` sorted
    by delta descending; positive delta means the stage costs more per
    request in phase *b*.
    """
    na, nb = max(request_count(a), 1), max(request_count(b), 1)

    def per_req(spans: List[Dict[str, Any]], n: int) -> Dict[Tuple[str, str], float]:
        out: Dict[Tuple[str, str], float] = defaultdict(float)
        for s in spans:
            if s["name"] == REQUEST_SPAN:
                continue
            out[(s["tier"], s["name"])] += s["self"] / n
        return out

    pa, pb = per_req(a, na), per_req(b, nb)
    rows = []
    for key in set(pa) | set(pb):
        va, vb = pa.get(key, 0.0), pb.get(key, 0.0)
        rows.append((key[0], key[1], va * 1e3, vb * 1e3, (vb - va) * 1e3))
    rows.sort(key=lambda r: -r[4])
    return rows


def render(spans: List[Dict[str, Any]], top: int = 20) -> str:
    """Render the full breakdown report for raw spans as text."""
    lines: List[str] = []
    annotated = self_times(spans)
    phases = by_phase(annotated)
    for phase in sorted(phases):
        ps = phases[phase]
        rows = stage_table(ps)
        total_self = sum(r[3] for r in rows) or 1.0
        n_req = request_count(ps)
        lines.append(f"== phase: {phase}  ({len(ps)} spans"
                     + (f", {n_req} requests" if n_req else "") + ") ==")
        lines.append(f"{'tier':<8} {'stage':<28} {'count':>7} {'self_ms':>10} "
                     f"{'share':>7} {'total_ms':>10}")
        for tier, name, cnt, st, dur in rows[:top]:
            lines.append(
                f"{tier:<8} {name:<28} {cnt:>7} {st * 1e3:>10.3f} "
                f"{st / total_self:>6.1%} {dur * 1e3:>10.3f}"
            )
        if rows:
            dom = rows[0]
            lines.append(
                f"-> dominant stage [{phase}]: {dom[1]} ({dom[0]}) — "
                f"{dom[3] * 1e3:.3f} ms self, {dom[3] / total_self:.1%} of phase"
            )
        lines.append("")
    if "serial" in phases and "batched" in phases:
        rows = gap_table(phases["serial"], phases["batched"])
        lines.append("== batched-vs-serial gap (per-request self time) ==")
        lines.append(f"{'tier':<8} {'stage':<28} {'serial_ms':>10} "
                     f"{'batched_ms':>11} {'delta_ms':>10}")
        for tier, name, va, vb, dv in rows[:top]:
            lines.append(f"{tier:<8} {name:<28} {va:>10.3f} {vb:>11.3f} {dv:>+10.3f}")
        pos = [r for r in rows if r[4] > 0]
        if pos:
            dom = pos[0]
            lines.append(
                f"-> dominant stage of the batched-vs-serial gap: {dom[1]} "
                f"({dom[0]}) — +{dom[4]:.3f} ms per request"
            )
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: ``python -m repro.obs.report trace.json``."""
    ap = argparse.ArgumentParser(description="Per-stage breakdown of a repro trace")
    ap.add_argument("trace", help="Chrome-trace JSON written by TRACER.save()")
    ap.add_argument("--top", type=int, default=20, help="rows per table")
    args = ap.parse_args(argv)
    spans = load_trace(args.trace)
    if not spans:
        print(f"{args.trace}: no spans")
        return 0
    print(render(spans, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
