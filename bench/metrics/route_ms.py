"""route_ms: host ms a batch of meta-HNSW routing (``core/search.py
meta_route``), the program's ``stats["meta_s"]``: its clock stops after
the partition ids are read back to the host.  Mean over the window's
batches that routed."""


def read(ctx):
    xs = [b["stats"]["meta_s"] for b in ctx.batches
          if b["stats"].get("meta_s", 0.0) > 0.0]
    return 1e3 * sum(xs) / len(xs) if xs else None
