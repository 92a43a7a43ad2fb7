"""The remote transport of the memory-pool boundary.

* ``wire.py``   — the length-prefixed binary framing of every
                  ``MemoryPool`` verb (a copy of the reference's); the
                  verbs layer (``rdma/verbs.py wr_frame``) frames WR lists
                  through it.
* ``server.py`` — ``PoolServer``: a memory-node process
                  (``python -m repro_torch.net.server``) that holds a
                  region in host memory and serves the verbs over TCP,
                  plus ``HostRegion`` (the loopback bearer's in-process
                  node) and the ``spawn_pool_servers`` harness (a copy of
                  the reference's: host-only numpy, it never touches the
                  card).
* ``client.py`` — ``RemotePool``: the ``MemoryPool`` that marshals verbs
                  to a server, decodes the responses on the host and
                  uploads each returned tensor to the engine's device once
                  a call, so the serve path on the card cannot tell it
                  from ``LocalPool``.
"""
from repro_torch.net import wire
from repro_torch.net.client import (PoolUnavailableError, RemotePool,
                                    parse_endpoint)
from repro_torch.net.server import HostRegion, PoolServer, spawn_pool_servers

__all__ = ["wire", "RemotePool", "PoolUnavailableError", "parse_endpoint",
           "PoolServer", "HostRegion", "spawn_pool_servers"]
