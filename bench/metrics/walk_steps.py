"""walk_steps: beam steps a batch of the sub-HNSW walks
(``core/search.py batched_beam_search`` called from
``core/device_store.py search_decoded_graph``), counted by the program
(``stats["walk_steps"]``: one a loop iteration over every lane of a
round's pairs; the meta-HNSW route counts apart, as ``route_steps``).
Mean over the batches after the profiled part of the window."""
from bench.yardstick import counters as C


def read(ctx):
    return C.mean_per_batch(ctx, "walk_steps")
