"""Disaggregated-memory boundary: MemoryPool transports + ComputeClient.

Port of ``repro/pool``.  Transports:

* ``LocalPool``         — in-process device tensors, with the write verbs
                          and the 1/N compacted staging;
* ``SimulatedRDMAPool`` — + a per-verb latency/bandwidth model;
* ``ShardedPool``       — the region split group-granularly across N
                          child pools with per-shard doorbell fan-out,
                          pluggable (migrating) placement, replication
                          and failover;
* ``RemotePool``        — (``repro_torch/net``) the verbs marshaled over
                          the loopback or TCP bearer to a memory node
                          that holds the region in host memory, measured
                          wire bytes cross-checked against the model.

Every pool and every child serves the engine's ``device``.
"""
from repro_torch.pool.compute import ComputeClient
from repro_torch.pool.local import LocalPool
from repro_torch.pool.placement import (FrequencyAwarePlacement,
                                        PlacementPolicy,
                                        RoundRobinPlacement,
                                        SizeBalancedPlacement,
                                        make_placement)
from repro_torch.pool.protocol import MemoryPool, span_wire_bytes
from repro_torch.pool.sharded import ShardedPool
from repro_torch.pool.sim_rdma import (SimulatedRDMAPool, fabric_params,
                                       fanout_dt)

__all__ = ["MemoryPool", "LocalPool", "SimulatedRDMAPool", "ShardedPool",
           "ComputeClient", "PlacementPolicy", "RoundRobinPlacement",
           "SizeBalancedPlacement", "FrequencyAwarePlacement",
           "make_placement", "make_pool_factory", "span_wire_bytes",
           "fanout_dt", "fabric_params"]


def make_pool_factory(cfg, device):
    """Store -> MemoryPool, per ``EngineConfig.pool``, serving
    ``device``."""
    if cfg.pool == "local":
        return lambda store: LocalPool(
            store, device=device, use_gather_kernel=cfg.use_gather_kernel)
    if cfg.pool == "sim_rdma":
        return lambda store: SimulatedRDMAPool(
            store, device=device, fabric=cfg.fabric,
            use_gather_kernel=cfg.use_gather_kernel)
    if cfg.pool == "remote":
        # lazy import: the net subsystem is only needed when it is used
        from repro_torch.net.client import RemotePool
        if cfg.bearer == "loopback":
            # in-process HostRegion behind the same verbs/QP path — no
            # endpoints, no sockets (the conformance bearer)
            return lambda store: RemotePool(store, None, device=device,
                                            fabric=cfg.fabric,
                                            bearer="loopback")
        eps = tuple(cfg.endpoints or ())
        if not eps:
            raise ValueError("pool='remote' needs EngineConfig.endpoints")
        if len(eps) == 1:
            return lambda store: RemotePool(store, eps[0], device=device,
                                            fabric=cfg.fabric)
        # several server processes: shard over one RemotePool per node
        children = [lambda store, ep=ep: RemotePool(
            store, ep, device=device, fabric=cfg.fabric) for ep in eps]
        return lambda store: ShardedPool(
            store, children, device=device,
            placement=make_placement(cfg.placement),
            parallel=cfg.shard_parallel, replication=cfg.replication,
            shard_budgets=cfg.shard_budgets,
            straggler_check_every=cfg.straggler_check_every)
    if cfg.pool == "sharded":
        def child(fabric, ep=None):
            if cfg.shard_transport == "local":
                return lambda store: LocalPool(
                    store, device=device,
                    use_gather_kernel=cfg.use_gather_kernel)
            if cfg.shard_transport == "sim_rdma":
                return lambda store: SimulatedRDMAPool(
                    store, device=device, fabric=fabric,
                    use_gather_kernel=cfg.use_gather_kernel)
            if cfg.shard_transport == "remote":
                from repro_torch.net.client import RemotePool
                return lambda store: RemotePool(
                    store, ep, device=device, fabric=fabric,
                    bearer=cfg.bearer)
            raise ValueError(
                f"unknown shard transport {cfg.shard_transport!r}")

        fabrics = (cfg.shard_fabrics if cfg.shard_fabrics is not None
                   else (cfg.fabric,) * cfg.n_shards)
        if len(fabrics) != cfg.n_shards:
            raise ValueError(f"shard_fabrics has {len(fabrics)} entries "
                             f"for n_shards={cfg.n_shards}")
        if cfg.shard_transport == "remote" and cfg.bearer == "tcp":
            eps = tuple(cfg.endpoints or ())
            if len(eps) != cfg.n_shards:
                raise ValueError(f"endpoints has {len(eps)} entries "
                                 f"for n_shards={cfg.n_shards}")
        else:
            # in-process children never take endpoints — ignore any so
            # zip below can't silently truncate the shard list
            eps = (None,) * cfg.n_shards
        children = [child(f, ep) for f, ep in zip(fabrics, eps)]
        return lambda store: ShardedPool(
            store, children, device=device,
            placement=make_placement(cfg.placement),
            parallel=cfg.shard_parallel,
            replication=cfg.replication, shard_budgets=cfg.shard_budgets,
            straggler_check_every=cfg.straggler_check_every)
    raise ValueError(f"unknown pool transport {cfg.pool!r}")
