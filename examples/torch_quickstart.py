"""Quickstart on the PyTorch/CUDA port: build a d-HNSW index, run batched
queries, insert vectors.

    python examples/torch_quickstart.py [--device cuda|cpu]

The twin of ``examples/quickstart.py`` through ``repro_torch``: the same
pipeline, settings and printed lines.  Walks the paper's full pipeline
on a laptop-sized dataset: meta-HNSW routing (§3.1), RDMA-friendly
layout + doorbell fetches (§3.2), query-aware batched loading with an
LRU cache (§3.3), and dynamic insertion into the shared overflow
regions.  The engine runs on ``--device`` (the card by default; asking
for ``cuda`` without one raises).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (DHNSWEngine, EngineConfig,  # noqa: E402
                              recall_at_k)
from repro_torch.core.cost_model import RDMA_100G  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("generating SIFT-like dataset (20k x 128d)...")
    ds = sift_like(n=20_000, n_queries=256, seed=0)

    print("building d-HNSW (meta-HNSW + sub-HNSWs + serialized layout)...")
    eng = DHNSWEngine(EngineConfig(
        mode="full",            # the paper's scheme (vs naive/no_doorbell)
        search_mode="graph",    # faithful sub-HNSW walk ("scan" = flat)
        n_rep=128,              # partitions (paper: 500 on 1M vectors)
        b=4,                    # partitions probed per query
        ef=48,                  # efSearch
        cache_frac=0.10,        # compute-pool cache: 10% of partitions
        doorbell=16,            # span reads per doorbell batch
        fabric=RDMA_100G),      # price network events like the testbed
        device=args.device)
    eng.build(ds.data)
    print(f"  store: {eng.store.total_bytes()/1e6:.1f} MB in "
          f"{eng.store.spec.n_blocks} blocks; meta-HNSW cached in the "
          f"compute pool: {eng.meta.size_bytes()/1e6:.3f} MB")

    print("searching (batched, top-10)...")
    d, g, st = eng.search(ds.queries, k=10)
    print(f"  recall@10: {recall_at_k(g, ds.gt_ids[:, :10]):.3f}")
    print(f"  round trips/query: {st['round_trips_per_query']:.4f} "
          f"(naive would be ~{eng.cfg.b:.1f})")
    print(f"  modeled network latency: "
          f"{st['net']['latency_s']*1e6/len(ds.queries):.1f} us/query")

    print("inserting 100 new vectors (shared overflow regions)...")
    new = ds.data[:100] + 0.01
    gids = eng.insert(new)
    _, gi, _ = eng.search(new[:20], k=1)
    hits = np.mean([gids[i] in gi[i] for i in range(20)])
    print(f"  inserted ids immediately searchable: {hits*100:.0f}%")

    print("second batch (warm cache)...")
    _, _, st2 = eng.search(ds.queries, k=10)
    print(f"  cache hits: {st2['cache_hits']}, fetches: {st2['n_fetches']} "
          f"(first batch fetched {st['n_fetches']})")


if __name__ == "__main__":
    main()
