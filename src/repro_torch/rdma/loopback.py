"""In-process bearers: loopback (real region) and model (accounting).

:class:`LoopbackBearer` completes every doorbell batch synchronously
against an in-process region (any object with the ``HostRegion.handle``
contract): the registered MRs are numpy views onto the same address
space, so a "one-sided READ" is a function call that gathers from them
— zero copies beyond the response encode, no sockets, no server
process.  Byte-for-byte it speaks the same frames as the TCP bearer
(the mapping lives in ``verbs.wr_frame``), which is what lets the
conformance suite run identical assertions across both.

:class:`ModelBearer` carries no bytes at all: it counts doorbells, work
requests and requested lengths so ``SimulatedRDMAPool`` can issue its
modeled verbs through the same QueuePair interface the real transports
use, while its clock stays priced by the fabric model.
"""
from __future__ import annotations

from collections import deque

from repro_torch.rdma.verbs import _wire


class LoopbackBearer:
    """Synchronous in-process bearer over a duck-typed host region.

    ``region`` needs one method — ``handle(op, flags, payload, seq) ->
    (resp, rflags)`` — and the bearer mirrors the TCP server's error
    contract around it: a verb exception becomes an error *completion*
    (FLAG_ERROR + message), never a raised exception, so pipelined
    batches behind a failure still drain.  ``counters`` (shared with the
    pool's ``wire`` dict) sees the same frame/byte accounting a socket
    would, headers included.
    """

    #: bearer consumes framed submissions (see ``QueuePair.post_send``)
    frames = True

    def __init__(self, region, counters=None):
        self.region = region
        self.wire = counters if counters is not None else {}
        for k in ("frames_tx", "frames_rx", "bytes_tx", "bytes_rx"):
            self.wire.setdefault(k, 0)
        self._ready: deque = deque()
        self._seq = 0
        self.closed = False

    def submit(self, op: int, payload: bytes, flags: int = 0, *,
               prefix: bytes = b"", wrs=None) -> int:
        """Frame one doorbell batch and complete it synchronously."""
        if self.closed:
            raise ConnectionError("loopback bearer closed")
        W = _wire()
        pflags = flags | (W.FLAG_TRACE if prefix else 0)
        self._seq = (self._seq + 1) & 0xFFFFFFFF
        nb = W.HEADER_BYTES + len(prefix) + len(payload)
        self.wire["frames_tx"] += 1
        self.wire["bytes_tx"] += nb
        if op == W.OP_SHUTDOWN:
            # connection-level op on the socket path; in-process there
            # is no server to stop — ack and keep serving
            resp, rflags = b"", 0
        else:
            try:
                resp, rflags = self.region.handle(op, pflags,
                                                  prefix + payload,
                                                  self._seq)
            except Exception as e:        # verb error -> error completion
                resp, rflags = str(e).encode("utf-8"), W.FLAG_ERROR
        self._ready.append((op, rflags, resp))
        return nb

    def flush(self) -> None:
        """No-op: loopback submissions complete at post time."""

    def complete(self):
        """Next in-order completion -> ``(op, flags, payload)``."""
        if not self._ready:
            raise RuntimeError("no outstanding loopback work")
        W = _wire()
        op, rflags, resp = self._ready.popleft()
        self.wire["frames_rx"] += 1
        self.wire["bytes_rx"] += W.HEADER_BYTES + len(resp)
        return op, rflags, resp

    def close(self) -> None:
        """Mark the bearer closed (further submits raise)."""
        self.closed = True


class ModelBearer:
    """Accounting-only bearer for the simulated transport.

    Never frames or moves bytes (``frames = False`` short-circuits the
    WR -> frame mapping): each posted WR list is tallied — one doorbell,
    ``len(wrs)`` descriptors, ``sum(length)`` requested bytes — and
    completes immediately and empty.  The fabric model prices the clock
    from the verb's charge, exactly as before the QP re-plumb.
    """

    frames = False

    def __init__(self):
        self.doorbells = 0
        self.descriptors = 0
        self.req_bytes = 0
        self._ready: deque = deque()
        self.closed = False

    def submit(self, op: int, payload: bytes, flags: int = 0, *,
               prefix: bytes = b"", wrs=None) -> int:
        """Tally one doorbell batch; completes instantly."""
        n = len(wrs) if wrs else 1
        nb = int(sum(w.length for w in wrs)) if wrs else 0
        self.doorbells += 1
        self.descriptors += n
        self.req_bytes += nb
        self._ready.append((op, 0, b""))
        return nb

    def flush(self) -> None:
        """No-op: nothing is buffered."""

    def complete(self):
        """Next in-order (empty) completion."""
        if not self._ready:
            raise RuntimeError("no outstanding modeled work")
        return self._ready.popleft()

    def close(self) -> None:
        """Mark the bearer closed."""
        self.closed = True

    def snapshot(self) -> dict:
        """Cumulative doorbell/descriptor/byte tallies."""
        return {"doorbells": int(self.doorbells),
                "descriptors": int(self.descriptors),
                "req_bytes": int(self.req_bytes)}
