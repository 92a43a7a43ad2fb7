"""cache_hit_share: % of the exact path's (query, partition) needs that
the partition cache (``LRUCacheState``) held, summed over the window:
``cache_hits / (cache_hits + n_fetches)``."""


def read(ctx):
    st = [b["stats"] for b in ctx.batches if "quant" not in b["stats"]]
    hits = sum(s["cache_hits"] for s in st)
    total = hits + sum(s["n_fetches"] for s in st)
    return 100.0 * hits / total if total else None
