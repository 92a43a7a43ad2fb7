"""RDMA-verbs bearer subsystem: MR/WR/QP/CQ over pluggable bearers.

The paper's transport is one-sided RDMA: compute nodes register the
memory pool's serialized region and move bytes with READ/WRITE work
requests — the memory side stays passive.  This package is that
abstraction for the repro, factored so TCP framing is just one *bearer*
among several:

* ``verbs``    — the API: :class:`MemoryRegion`, :class:`WorkRequest`,
  :class:`QueuePair` (``post_send`` of a WR list == one doorbell
  batch), :class:`CompletionQueue`, and the shared WR-list -> frame
  mapping;
* ``mr``       — host-side registered MRs (numpy views over the region)
  that serve one-sided READs without per-verb server logic;
* ``loopback`` — in-process bearer (synchronous completions) and the
  accounting-only model bearer the simulated transport posts through;
* ``tcp``      — the TCP-emulated bearer over ``repro/net`` framing to
  a ``PoolServer``.

``RemotePool(bearer="loopback"|"tcp")`` and ``SimulatedRDMAPool`` issue
every verb through a :class:`QueuePair`; ``wire_vs_model`` and the
LocalPool bit-identity conformance suite gate all of it.
"""
from repro_torch.rdma.loopback import LoopbackBearer, ModelBearer
from repro_torch.rdma.mr import HostMR, QuantRowMR, RowMR, SpanMR, host_mrs
from repro_torch.rdma.tcp import TcpBearer
from repro_torch.rdma.verbs import (READ, RKEY_OVERFLOW, RKEY_QROWS, RKEY_REGION,
                              RKEY_ROWS, RKEY_SPANS, SEND, WRITE,
                              WRITE_WITH_IMM, Completion, CompletionQueue,
                              MemoryRegion, QueuePair, WorkRequest,
                              read_wr, region_mrs, send_wr, wr_frame,
                              write_imm_wr, write_wr)

__all__ = [
    "READ", "WRITE", "WRITE_WITH_IMM", "SEND",
    "RKEY_SPANS", "RKEY_ROWS", "RKEY_QROWS", "RKEY_OVERFLOW", "RKEY_REGION",
    "MemoryRegion", "WorkRequest", "Completion", "CompletionQueue",
    "QueuePair", "wr_frame", "region_mrs",
    "read_wr", "write_wr", "write_imm_wr", "send_wr",
    "HostMR", "SpanMR", "RowMR", "QuantRowMR", "host_mrs",
    "LoopbackBearer", "ModelBearer", "TcpBearer",
]
