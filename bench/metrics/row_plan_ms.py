"""row_plan_ms: host ms a batch of the int8 path's stage-2 row plan
(``pool/compute.py _search_quant``: the candidates read back, deduplicated
and charged, the exact tier's admissions), the program's
``stats["plan_s"]``.  Mean over the window's int8 batches; the flat view's
one-off sync is paid in warm-up."""


def read(ctx):
    xs = [b["stats"]["plan_s"] for b in ctx.batches
          if "quant" in b["stats"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
