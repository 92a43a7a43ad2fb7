"""fetch_useful_share: % of the bytes the exact path's span reads move on
the wire that the fetched partitions' rows hold.

The useful bytes are each exact ``compute.fetch`` span's ``row_bytes``
(the program's count from its meta table: base rows with graph entry and
vector, the overflow rows in use in the group); the wire bytes are the
``bytes`` of the ``pool.read_spans`` events under those spans (each span
padded to the largest partition, with the whole shared overflow region).
Summed over the batches after the profiled part of the window."""
from bench.yardstick import counters as C


def read(ctx):
    spans = C.quiet_spans(ctx)
    fetch = {s["id"] for s in spans if s["name"] == "compute.fetch"
             and not s["attrs"].get("quant") and "row_bytes" in s["attrs"]}
    useful = sum(s["attrs"]["row_bytes"] for s in spans if s["id"] in fetch)
    wire = sum(s["attrs"]["bytes"] for s in spans
               if s["name"] == "pool.read_spans" and s["parent"] in fetch)
    return 100.0 * useful / wire if useful and wire else None
