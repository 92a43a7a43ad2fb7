"""host_syncs: the times a batch the host waits for the card, counted by
the program where each happens (``stats["host_syncs"]``): the walks'
per-step ``bool(active.any())``, the gather's out-of-range check, every
readback, every upload from host memory (it waits for the stream), the
int8 path's synchronize before its row plan.  Mean over the batches after
the profiled part of the window (all of them where it covered every
one)."""
from bench.yardstick import counters as C


def read(ctx):
    return C.mean_per_batch(ctx, "host_syncs")
