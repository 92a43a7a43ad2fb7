"""serve_ms: host ms a batch of serve and merge on the exact path
(``core/device_store.py serve_and_merge``), the program's
``stats["sub_s"]``: the rounds' serve calls with the walk's own host syncs,
and the final copy of the results.  Mean over the window's exact-tier
batches."""


def read(ctx):
    xs = [b["stats"]["sub_s"] for b in ctx.batches
          if "quant" not in b["stats"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
