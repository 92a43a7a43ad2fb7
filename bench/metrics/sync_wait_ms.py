"""sync_wait_ms: host ms a batch spent blocked at the program's host syncs
(``stats["sync_wait_s"]``: each sync's own clock, read around the call
that waits).  The rest of a batch's wall is the host issuing work and
planning.  Mean over the batches after the profiled part of the window
(all of them where it covered every one)."""
from bench.yardstick import counters as C


def read(ctx):
    return C.mean_per_batch(ctx, "sync_wait_s", scale=1e3)
