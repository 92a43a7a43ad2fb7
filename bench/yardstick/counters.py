"""Per-batch reads of the program's own counters and spans.

With the tracer on, the program copies its ``compute.search`` span's
counters into each batch's ``stats`` (``walk_steps``, ``host_syncs``,
``sync_wait_s``, ...).  The profiler (CUPTI) slows every launch of the
batches it covers, so the readers here take the batches after the
profiled part of the window, and every batch where the profiler covered
them all.  A program without the counters gives no value (None).
"""
from __future__ import annotations

SEARCH_ROOT = "compute.search"


def quiet(ctx) -> list:
    """Indices of the batches the profiler did not cover; all of them
    where it covered every one."""
    rest = [i for i, b in enumerate(ctx.batches) if not b["profiled"]]
    return rest or list(range(len(ctx.batches)))


def mean_per_batch(ctx, key: str, scale: float = 1.0):
    """``scale`` times the mean of ``stats[key]`` over the quiet batches
    that have it."""
    xs = [ctx.batches[i]["stats"][key] for i in quiet(ctx)
          if key in ctx.batches[i]["stats"]]
    return scale * sum(xs) / len(xs) if xs else None


def quiet_spans(ctx) -> list:
    """The spans under the quiet batches' ``compute.search`` roots.  The
    roots close in batch order, one a batch; where their count is not the
    number of batches (a ring that dropped spans, a stand-in program),
    every span."""
    roots = [s["id"] for s in ctx.spans if s["name"] == SEARCH_ROOT]
    if len(roots) != len(ctx.batches):
        return list(ctx.spans)
    keep = {roots[i] for i in quiet(ctx)}
    parent = {s["id"]: s["parent"] for s in ctx.spans}
    top = {}

    def root(sid):
        """The outermost recorded span above ``sid`` (itself at a root)."""
        if sid not in top:
            p = parent.get(sid, 0)
            top[sid] = sid if p not in parent else root(p)
        return top[sid]
    return [s for s in ctx.spans if root(s["id"]) in keep]
