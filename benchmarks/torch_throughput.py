"""Throughput and ablations through the PyTorch/CUDA port (the port of
``benchmarks/throughput.py``):

  * QPS vs batch size (batching is the paper's §3.3 lever);
  * cache-capacity ablation (hit rate and bytes vs cache_frac);
  * doorbell-width ablation (§3.2's NIC-scalability trade-off);
  * the ``distance_topk`` kernel against its plain version on
    ``queries[:128]`` x ``data[:4096]``, k=10.

    PYTHONPATH=src python -m benchmarks.torch_throughput [--device cpu]

Runs on the card unless ``--device cpu``; on CPU tensors the kernel's
wrapper runs its plain version, so that row then times the plain version
twice.  ``run()`` takes an already built index ``(meta, store, data)``
and then serves every engine from it (``adopt_built``) instead of
rebuilding it eight times; the build is deterministic by seed, so the
counted rows do not change.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from benchmarks.torch_common import P, batched_queries, dataset, emit
from repro_torch import DHNSWEngine, EngineConfig
from repro_torch.core.cost_model import RDMA_100G


def _mk(p: dict, ds, index, device, **kw):
    cfg = dict(mode="full", search_mode="scan", b=4, ef=48,
               n_rep=min(p["n_rep"], ds.data.shape[0] // 16),
               cache_frac=0.10, doorbell=16, fabric=RDMA_100G, seed=0)
    cfg.update(kw)
    eng = DHNSWEngine(EngineConfig(**cfg), device=device)
    if index is None:
        return eng.build(ds.data)
    meta, store, data = index
    if meta.n_partitions != cfg["n_rep"]:
        raise ValueError(f"index has {meta.n_partitions} partitions, the "
                         f"preset asks for {cfg['n_rep']}")
    return eng.adopt_built(meta, dataclasses.replace(store), data)


def run(index=None, *, preset: dict | None = None, ds=None,
        device="cuda") -> list[dict]:
    """Every section's rows (also printed as CSV lines).  ``preset``
    defaults to ``P``, ``ds`` to the preset's sift dataset."""
    p = P if preset is None else preset
    ds = dataset("sift", p) if ds is None else ds
    rows = []
    # ---- QPS vs batch
    eng = _mk(p, ds, index, device)
    for batch in (64, 256, 1024):
        if batch > 4 * len(ds.queries):
            continue
        q = batched_queries(ds, batch)
        eng.search(q, k=10)          # warm
        t0 = time.perf_counter()
        _, _, st = eng.search(q, k=10)
        wall = time.perf_counter() - t0
        total = st["net"]["latency_s"] + st["sub_s"] + st["meta_s"]
        row = dict(name=f"throughput/batch{batch}",
                   us_per_call=round(total / batch * 1e6, 2),
                   qps_model=int(batch / total), qps_wall=int(batch / wall),
                   rtpq=round(st["round_trips_per_query"], 5))
        rows.append(row)
        emit(dict(row))

    # ---- cache-capacity ablation
    for frac in (0.02, 0.10, 0.30):
        eng = _mk(p, ds, index, device, cache_frac=frac)
        q = batched_queries(ds, p["batch"])
        eng.search(q, k=10)
        _, _, st = eng.search(q, k=10)
        row = dict(name=f"cache/frac{frac}", us_per_call="",
                   hits=st["cache_hits"], fetches=st["n_fetches"],
                   bytes=int(st["net"]["bytes"]))
        rows.append(row)
        emit(dict(row))

    # ---- doorbell-width ablation (the first batch on a fresh engine)
    for db in (1, 4, 16, 64):
        eng = _mk(p, ds, index, device, doorbell=db)
        q = batched_queries(ds, p["batch"])
        _, _, st = eng.search(q, k=10)
        row = dict(name=f"doorbell/width{db}", us_per_call="",
                   trips=st["net"]["round_trips"],
                   net_us=round(st["net"]["latency_s"] * 1e6, 1),
                   bytes=int(st["net"]["bytes"]), hits=st["cache_hits"],
                   fetches=st["n_fetches"])
        rows.append(row)
        emit(dict(row))

    # ---- kernel vs its plain version on the hot loop
    from repro_torch.kernels.distance_topk.ops import distance_topk
    dev = eng.device
    q = torch.as_tensor(ds.queries[:128], device=dev)
    x = torch.as_tensor(ds.data[:4096], device=dev)
    impl = "cuda" if dev.type == "cuda" else "plain"
    for use_ref in (True, False):
        distance_topk(q, x, 10, use_ref=use_ref)      # build / warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            distance_topk(q, x, 10, use_ref=use_ref)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / 5
        row = dict(name=f"kernel/distance_topk/{'ref' if use_ref else impl}",
                   us_per_call=round(dt * 1e6, 1),
                   note=("host clock over 5 calls on "
                         + (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "the CPU")))
        rows.append(row)
        emit(dict(row))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: the card)")
    run(device=ap.parse_args().device)


if __name__ == "__main__":
    main()
