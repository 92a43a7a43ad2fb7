"""Distributed memory pool on the PyTorch/CUDA port: the d-HNSW store
sharded across ranks.

    python examples/torch_distributed_search.py [--device cuda|cpu]

The twin of ``examples/distributed_search.py`` through ``repro_torch``:
the same steps and printed lines.  Where the reference fakes 8 XLA host
devices and a (2, 4) ``("data", "model")`` mesh, this spawns the 8 ranks
itself (gloo, meeting through a file) and builds the same mesh over
them: the serialized block region shards over the ``model`` group
(``ShardedStore``: each rank = one memory instance), the meta-HNSW +
metadata replicate into every "compute instance", and a doorbell batch
becomes ONE collective launch.  With ``--device cuda`` every rank keeps
its shard on the one card and gloo reduces the CUDA tensors; with
``--device cpu`` CPU tensors.  Also demos straggler rebalancing and
elastic rescale planning (host-side plans, printed by rank 0).
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.core import (LayoutSpec, Store, build_meta,  # noqa: E402
                              build_store)
from repro_torch.core.distributed import ShardedStore  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.pool.placement import (plan_store_migration,  # noqa: E402
                                        rebalance_partitions)

MESH = (2, 4)                 # ("data", "model"), the reference's mesh


def rank_main(rank: int, world: int, tmp: str, device: str):
    """One rank: the store from the parent's file (not through the spawn's
    pipe, which each child drains only once it has imported torch, so
    the starts would queue behind each other)."""
    a = np.load(os.path.join(tmp, "store.npz"))
    store = Store(spec=LayoutSpec(**{k[5:]: int(a[k]) for k in a.files
                                     if k.startswith("spec_")}),
                  graph_buf=a["graph_buf"], vec_buf=a["vec_buf"],
                  meta_table=a["meta_table"], n_base=a["n_base"])
    dist.init_process_group("gloo",
                            init_method=f"file://{os.path.join(tmp, 'rdv')}",
                            world_size=world, rank=rank)
    try:
        run(rank, store, device)
    finally:
        dist.destroy_process_group()


def run(rank: int, store, device: str):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    ss = ShardedStore(store, group=mesh.get_group("model"), device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"store: {store.spec.n_blocks} blocks sharded over "
        f"{ss.world} memory instances ({ss.per_shard} blocks each)")

    # one doorbell batch: fetch partitions 3, 10, 17 in ONE collective
    pids = [3, 10, 17]
    ids = np.concatenate([store.span_block_ids(p) for p in pids])
    g, v = ss.fetch(ids)
    ok = np.array_equal(g.cpu().numpy(), store.graph_buf[ids])
    if not ok:
        raise AssertionError(f"rank {rank}: the fetched blocks differ from "
                             f"the store's")
    say(f"doorbell fetch of partitions {pids}: one collective launch, "
        f"{ids.size} blocks, correct={ok}")

    owners = ss.partition_owners(store)
    say(f"partition->owner map (first 12): {owners[:12].tolist()}")

    # memory instance 2 goes slow: migrate its partitions
    new_owners, moves = rebalance_partitions(owners, sick={2}, n_owners=4)
    say(f"straggler rebalance off owner 2: {len(moves)} group moves "
        f"(each a contiguous span copy)")

    # elastic rescale 4 -> 6 owners
    plan = plan_store_migration(store.spec.n_blocks, old_tp=4, new_tp=6)
    moved = sum(n for _, _, _, n in plan)
    say(f"elastic 4->6 owners: {len(plan)} contiguous moves, "
        f"{moved}/{store.spec.n_blocks} blocks relocate "
        f"({moved * store.spec.block_bytes() / 1e6:.1f} MB)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # raises for cuda without a card
    world = MESH[0] * MESH[1]
    print(f"devices: {world}")
    ds = sift_like(n=8000, n_queries=16, seed=0)
    meta = build_meta(ds.data, 32, seed=0)
    store = build_store(ds.data, meta)
    with tempfile.TemporaryDirectory(prefix="torch_dsearch_") as tmp:
        np.savez(os.path.join(tmp, "store.npz"), graph_buf=store.graph_buf,
                 vec_buf=store.vec_buf, meta_table=store.meta_table,
                 n_base=store.n_base,
                 **{f"spec_{f.name}": getattr(store.spec, f.name)
                    for f in dataclasses.fields(store.spec)})
        sys.stdout.flush()
        mp.spawn(rank_main, args=(world, tmp, args.device), nprocs=world,
                 join=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
