"""The wire framing of the memory-pool verbs (``wire.py``, a copy of the
reference's): the verbs layer (``rdma/verbs.py wr_frame``) frames WR
lists through it.  The remote transport (``RemotePool``, ``PoolServer``,
``spawn_pool_servers``) is ported with ROADMAP "Modules to port" item 7.
"""
from repro_torch.net import wire

__all__ = ["wire"]
