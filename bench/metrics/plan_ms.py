"""plan_ms: host ms a batch of the round planner on the exact path
(``core/scheduler.py plan_batch``), the program's ``stats["plan_s"]``.
Mean over the window's exact-tier batches (the int8 path's ``plan_s`` is
its row plan: ``row_plan_ms``)."""


def read(ctx):
    xs = [b["stats"]["plan_s"] for b in ctx.batches
          if "quant" not in b["stats"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
