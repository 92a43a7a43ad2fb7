"""gather_roofline: % of the fetch layer's bound that its device time
reaches (``pool/local.py read_spans`` -> ``kernels/gather_blocks``, then
the spans' install into the cache slots).

Counted from the work, not from the kernels that do it, nor from the
padded layout they read.  The work of a fetch is to move the fetched
partitions' rows from the pool's region into the partition cache: for
each fetched partition, its base rows (graph entry as int32, vector as
float32) and the overflow rows in use in its group (global id and
vector), read once and written once.  The padding of every span to the
largest partition and the unused overflow slots are not work.  The bound
is those bytes over the HBM peak.  The device time is that of every
operation launched inside the program's exact-tier ``compute.fetch``
spans in the profiled window; the partitions are those the runner noted
for the profiled batches.
"""
from bench.yardstick import peaks


def exact_fetch(span) -> bool:
    return not span["attrs"].get("quant")


def read(ctx):
    t = ctx.trace
    part = ctx.layout.get("partition_bytes")
    if t is None or part is None:
        return None
    dev_s = t.layer_device_s("compute.fetch", keep=exact_fetch)
    nbytes = sum(int(part[pids].sum()) for b in ctx.batches
                 if b["profiled"] for pids in b.get("fetched", ()))
    if not dev_s or not nbytes:
        return None
    return 100.0 * 2 * nbytes / peaks.HBM_BYTES_S / dev_s
