"""Disaggregated-memory boundary: MemoryPool transports + ComputeClient.

The port has the in-process transport (``LocalPool``, with the write
verbs and the 1/N compacted staging); the simulated RDMA, sharded and
remote transports raise until they are ported (ROADMAP "Modules to port"
items 6 and 7).
"""
from repro_torch.pool.compute import ComputeClient
from repro_torch.pool.local import LocalPool
from repro_torch.pool.protocol import MemoryPool, span_wire_bytes

__all__ = ["MemoryPool", "LocalPool", "ComputeClient", "make_pool_factory",
           "span_wire_bytes"]


def make_pool_factory(cfg, device):
    """Store -> MemoryPool, per ``EngineConfig.pool``, staged on
    ``device``."""
    if cfg.pool == "local":
        return lambda store: LocalPool(
            store, device=device, use_gather_kernel=cfg.use_gather_kernel)
    if cfg.pool in ("sim_rdma", "sharded"):
        raise NotImplementedError(
            f"pool={cfg.pool!r} is ported with the multi-node pools "
            "(ROADMAP 'Modules to port' item 6)")
    if cfg.pool == "remote":
        raise NotImplementedError(
            "pool='remote' is ported with net/ (ROADMAP 'Modules to port' "
            "item 7)")
    raise ValueError(f"unknown pool transport {cfg.pool!r}")
