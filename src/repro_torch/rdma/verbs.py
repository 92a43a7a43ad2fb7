"""ibverbs-style verbs API for the memory-pool transport.

The paper's memory nodes are passive: a compute node *registers* the
remote region once and then moves bytes with one-sided work requests —
no per-verb server logic, no request handlers, just READ/WRITE against
``(rkey, addr, len)`` triples.  This module is that abstraction for the
repro:

* :class:`MemoryRegion` — a registered region slice named by an
  ``rkey``; addresses inside it are *logical* (partition ids for the
  span MR, region row addresses for the row MRs, block ids for the
  block MR) so the layout's indirection — NOT the transport — decides
  where bytes physically live.
* :class:`WorkRequest` — one descriptor: an opcode (``READ`` / ``WRITE``
  / ``WRITE_WITH_IMM`` / ``SEND``), a target ``(rkey, addr, length)``,
  optional immediate data and an inline payload for writes.
* :class:`QueuePair` — ``post_send`` of a WR *list* is exactly one
  doorbell batch: the whole list becomes one bearer submission (one
  wire frame on the TCP bearer), which is what keeps measured frames ==
  modeled round trips (``wire_vs_model``).
* :class:`CompletionQueue` — ``poll`` returns completions in posting
  order; a remote verb error surfaces as a completion with nonzero
  ``status`` (never an exception mid-drain, so pipelined batches behind
  the failure still complete).

Bearers (``rdma/loopback.py``, ``rdma/tcp.py``) move the framed bytes;
they share the WR-list -> frame mapping in :func:`wr_frame`, so the
in-process and TCP paths are byte-identical by construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ------------------------------------------------------------- opcodes

#: one-sided read from a registered region
READ = 1
#: one-sided write into a registered region
WRITE = 2
#: one-sided write whose completion carries immediate data (the control
#: notification the passive side consumes — e.g. an append's (gid, pid))
WRITE_WITH_IMM = 3
#: two-sided control-plane message (attach / stats / ping); ``imm``
#: names the message type
SEND = 4

OPCODE_NAMES = {READ: "READ", WRITE: "WRITE",
                WRITE_WITH_IMM: "WRITE_WITH_IMM", SEND: "SEND"}

# ------------------------------------------------------------- rkeys
# Deterministic rkeys, one per addressable view of the serialized
# region.  Logical addressing per MR: the span MR is addressed by
# partition id, the row MRs by region row address, the block MR by
# block id — the same indirection the layout's metadata table encodes,
# so a remote node can validate every address against its own region.

RKEY_SPANS = 0x10    #: span MR — addr = partition id, len = span bytes
RKEY_ROWS = 0x20     #: f32 row MR — addr = region row address
RKEY_QROWS = 0x30    #: int8 row MR — addr = region row address
RKEY_OVERFLOW = 0x40  #: shared-overflow write MR — addr = partition id
RKEY_REGION = 0x50   #: block-granular write MR — addr = block id

RKEY_NAMES = {RKEY_SPANS: "spans", RKEY_ROWS: "rows",
              RKEY_QROWS: "quant_rows", RKEY_OVERFLOW: "overflow",
              RKEY_REGION: "region"}

# completion status
WC_SUCCESS = 0
WC_REMOTE_ERROR = 1


@dataclass(frozen=True)
class MemoryRegion:
    """A registered region slice: ``(rkey, addr, length)`` + a name.

    ``addr`` is the base logical address and ``length`` the addressable
    extent in that MR's units (partitions, rows, or blocks); ``nbytes``
    is the physical size one unit resolves to.  Host-side MRs
    additionally carry live numpy views (``rdma/mr.py``); client-side
    registrations (:func:`region_mrs`) are descriptors only — exactly
    like an rkey handed to a remote peer.
    """

    rkey: int
    addr: int
    length: int
    nbytes: int
    name: str = ""


def region_mrs(spec, *, quant: bool = False) -> dict:
    """Client-side MR table for a region with layout ``spec``.

    Returns ``{rkey: MemoryRegion}`` describing every addressable view
    of the remote region — what a real verbs stack would receive from
    the remote's registration exchange.  ``quant`` adds the int8-mirror
    row MR.
    """
    n_rows = spec.n_blocks * spec.slot_vecs
    mrs = {
        RKEY_SPANS: MemoryRegion(RKEY_SPANS, 0, spec.n_partitions,
                                 spec.partition_bytes(), "spans"),
        RKEY_ROWS: MemoryRegion(RKEY_ROWS, 0, n_rows, spec.row_bytes(),
                                "rows"),
        RKEY_OVERFLOW: MemoryRegion(RKEY_OVERFLOW, 0, spec.n_partitions,
                                    spec.row_bytes() + 8, "overflow"),
        RKEY_REGION: MemoryRegion(RKEY_REGION, 0, spec.n_blocks,
                                  spec.block_bytes(), "region"),
    }
    if quant:
        nq = spec.dim + (spec.dim // spec.quant_group) * 4
        mrs[RKEY_QROWS] = MemoryRegion(RKEY_QROWS, 0, n_rows, nq,
                                       "quant_rows")
    return mrs


@dataclass
class WorkRequest:
    """One work descriptor of a doorbell batch.

    ``opcode`` is one of READ / WRITE / WRITE_WITH_IMM / SEND; ``rkey``
    + ``addr`` name the target inside a registered MR; ``length`` the
    bytes the request moves.  ``flags`` carries verb modifiers (the wire
    layer's quant/graph flags); ``payload`` is the inline data of a
    write; ``imm`` the immediate value (WRITE_WITH_IMM) or the message
    type (SEND).
    """

    opcode: int
    rkey: int = 0
    addr: int = 0
    length: int = 0
    flags: int = 0
    payload: bytes = b""
    imm: int = 0


@dataclass
class Completion:
    """One work completion, delivered in posting order.

    ``status`` is :data:`WC_SUCCESS` or :data:`WC_REMOTE_ERROR` (with
    ``error`` carrying the remote's message); ``data`` is the bytes a
    READ (or a control SEND's response) returned, ``flags`` the
    response's wire flags, and ``nbytes`` the payload bytes that moved.
    """

    opcode: int
    status: int = WC_SUCCESS
    data: bytes = b""
    error: str = ""
    flags: int = 0
    nbytes: int = 0


class CompletionQueue:
    """Poll-driven completion delivery, strictly in posting order.

    The queue drains its bearer lazily: ``poll`` asks the bearer for the
    next in-order completion only when called, so a caller can decode
    batch ``r`` while batch ``r+1``'s response is still in flight — the
    double-buffered doorbell submission ``RemotePool`` exploits.
    """

    def __init__(self, bearer):
        self._bearer = bearer
        self._outstanding = 0

    @property
    def outstanding(self) -> int:
        """Posted doorbell batches whose completion was not yet polled."""
        return self._outstanding

    def _posted(self) -> None:
        self._outstanding += 1

    def poll(self, n: int = 1) -> list:
        """Return the next ``n`` completions (blocking on the bearer)."""
        if n > self._outstanding:
            raise RuntimeError(
                f"polling {n} completions with {self._outstanding} "
                f"outstanding")
        out = []
        for _ in range(n):
            op, flags, payload = self._bearer.complete()
            self._outstanding -= 1
            if flags & _FLAG_ERROR:
                out.append(Completion(opcode=op, status=WC_REMOTE_ERROR,
                                      error=payload.decode("utf-8"),
                                      flags=flags))
            else:
                out.append(Completion(opcode=op, data=payload, flags=flags,
                                      nbytes=len(payload)))
        return out


class QueuePair:
    """A send queue over one bearer + its completion queue.

    ``post_send`` of a WR list is ONE doorbell batch: the list maps to a
    single bearer submission (:func:`wr_frame`), so frames == doorbell
    batches == modeled round trips.  ``post_recv`` exists for API shape
    (both bearers deliver responses without pre-posted buffers).
    """

    def __init__(self, bearer):
        self.bearer = bearer
        self.cq = CompletionQueue(bearer)

    def post_send(self, wrs, *, prefix: bytes = b"") -> int:
        """Submit one doorbell batch (a WR list) -> bytes submitted.

        ``prefix`` is an opaque trace-context prepended outside the verb
        payload (never priced).  The completion lands on ``self.cq`` in
        posting order.

        When a :class:`repro.rdma.inject.WRInjector` is attached to the
        bearer (``bearer.injector``) it is consulted here, before the
        list is framed or submitted: injected latency accrues on the
        injector (transports fold it into their observed clocks) and an
        injected fault raises before anything is posted, so a failed
        post charges nothing.
        """
        inj = getattr(self.bearer, "injector", None)
        if inj is not None:
            inj.on_post(wrs)
        if getattr(self.bearer, "frames", True):
            op, payload, flags = wr_frame(wrs)
        else:                       # accounting-only bearer: skip framing
            op, payload, flags = 0, b"", 0
        n = self.bearer.submit(op, payload, flags, prefix=prefix, wrs=wrs)
        self.cq._posted()
        return n

    def post_recv(self, n: int = 1) -> None:
        """Register receive capacity (a no-op on both bearers: responses
        are matched to sends by sequence, not to posted buffers)."""

    def close(self) -> None:
        """Close the underlying bearer (idempotent)."""
        self.bearer.close()


# ------------------------------------------------- WR-list <-> framing
# The TCP-emulated bearer maps WR lists onto the existing repro/net
# framing; the loopback bearer feeds the same frames to an in-process
# HostRegion.  Keeping the mapping HERE (shared) is what makes the two
# bearers byte-identical.

_FLAG_ERROR = 0x8000     # == wire.FLAG_ERROR (response error frames)


def _wire():
    # deferred: repro.net imports this package, so the wire module is
    # bound at first use, not at import time
    from repro_torch.net import wire as W
    return W


_READ_OPS = None


def _read_ops():
    global _READ_OPS
    if _READ_OPS is None:
        W = _wire()
        _READ_OPS = {RKEY_SPANS: (W.OP_READ_SPANS, W.enc_pids),
                     RKEY_ROWS: (W.OP_READ_ROWS, W.enc_rows),
                     RKEY_QROWS: (W.OP_READ_QUANT_ROWS, W.enc_rows)}
    return _READ_OPS


def wr_frame(wrs) -> tuple:
    """Map one posted WR list (one doorbell batch) -> one wire frame.

    Returns ``(op, payload, flags)``:

    * a READ list (homogeneous rkey) becomes one read frame whose
      payload is the flat logical-address batch — addresses ship to the
      remote, so IT resolves and validates them against its region;
    * a write list (WRITEs closed by one WRITE_WITH_IMM) becomes one
      write frame carrying the concatenated inline payloads;
    * a single SEND becomes the control frame its ``imm`` names.

    Exactly one frame per list is the invariant the accounting rests on.
    """
    if not wrs:
        raise ValueError("empty work-request list")
    W = _wire()
    first = wrs[0]
    if first.opcode == READ:
        rkey = first.rkey
        op_enc = _read_ops().get(rkey)
        if op_enc is None or any(w.opcode != READ or w.rkey != rkey
                                 for w in wrs):
            raise ValueError("READ list must share one registered rkey")
        op, enc = op_enc
        flags = 0
        for w in wrs:
            flags |= w.flags
        return op, enc(np.asarray([w.addr for w in wrs], np.int64)), flags
    if first.opcode == SEND:
        if len(wrs) != 1:
            raise ValueError("SEND posts one WR per doorbell")
        return first.imm, first.payload, first.flags
    last = wrs[-1]
    if last.opcode != WRITE_WITH_IMM or any(
            w.opcode not in (WRITE, WRITE_WITH_IMM) for w in wrs):
        raise ValueError("write list must close with WRITE_WITH_IMM")
    op = {RKEY_OVERFLOW: W.OP_APPEND,
          RKEY_REGION: W.OP_WRITE_BLOCKS}.get(last.rkey)
    if op is None:
        raise ValueError(f"no write mapping for rkey {last.rkey:#x}")
    flags = 0
    for w in wrs:
        flags |= w.flags
    return op, b"".join(w.payload for w in wrs), flags


# --------------------------------------------------- WR constructors

def read_wr(rkey: int, addr: int, length: int, *,
            flags: int = 0) -> WorkRequest:
    """One one-sided READ descriptor against a registered MR."""
    return WorkRequest(READ, rkey=rkey, addr=int(addr), length=int(length),
                       flags=flags)


def write_wr(rkey: int, addr: int, payload: bytes = b"", *,
             length: int = 0, flags: int = 0) -> WorkRequest:
    """One one-sided WRITE descriptor (inline payload)."""
    return WorkRequest(WRITE, rkey=rkey, addr=int(addr),
                       length=length or len(payload), payload=payload,
                       flags=flags)


def write_imm_wr(rkey: int, addr: int, payload: bytes, imm: int, *,
                 flags: int = 0) -> WorkRequest:
    """The closing WRITE_WITH_IMM of a write batch: data + the immediate
    control word the passive side is notified with."""
    return WorkRequest(WRITE_WITH_IMM, rkey=rkey, addr=int(addr),
                       length=len(payload), payload=payload,
                       imm=int(imm), flags=flags)


def send_wr(op: int, payload: bytes = b"", *, flags: int = 0) -> WorkRequest:
    """A two-sided control SEND; ``op`` is the message type (wire op)."""
    return WorkRequest(SEND, payload=payload, imm=int(op), flags=flags)
