"""TCP-emulated bearer: WR frames over the ``repro/net`` socket wire.

Maps each posted doorbell batch onto exactly one ``wire.py`` frame and
moves it over a pipelined TCP connection to a ``PoolServer``.  The
server side needs no per-verb logic for reads — it resolves the frame's
logical address batch against its registered MRs (``rdma/mr.py``) —
which is what makes this an *emulation of one-sided access* rather than
an RPC protocol: the frame is the WR list, the response is the remote
memory, and ordering is the QP's submission order.

Batching: submissions accumulate in an output buffer and are flushed in
one ``sendall`` at the first completion poll (or an explicit
``flush()``), so a k-batch doorbell pipeline costs one syscall out and
k framed responses in — identical bytes and syscall pattern to the
pre-verbs ``RemotePool`` transport, byte-counted the same way (headers
in ``bytes_tx``/``bytes_rx``, payloads separate so the model cross-check
sees pure data bytes).

Failures surface as the exceptions the socket raises (``ConnectionError``
/ ``socket.timeout`` / ``OSError``); the pool above maps them to
``PoolUnavailableError``.  An out-of-sequence response is a
``ConnectionError`` — the connection is desynchronized and unusable.
"""
from __future__ import annotations

import socket
from collections import deque
from typing import Optional

from repro_torch.rdma.verbs import _wire


class TcpBearer:
    """Pipelined frame bearer over one TCP connection.

    ``counters`` (usually the owning pool's ``wire`` dict, shared by
    reference) accumulates ``frames_tx``/``frames_rx``/``bytes_tx``/
    ``bytes_rx``; the bearer owns the socket, the sequence numbers and
    the in-order response matching.
    """

    #: bearer consumes framed submissions (see ``QueuePair.post_send``)
    frames = True

    def __init__(self, endpoint: tuple, *, timeout_s: float = 60.0,
                 connect_timeout_s: float = 10.0, counters=None):
        self.endpoint = endpoint
        self.wire = counters if counters is not None else {}
        for k in ("frames_tx", "frames_rx", "bytes_tx", "bytes_rx"):
            self.wire.setdefault(k, 0)
        self._sock: Optional[socket.socket] = socket.create_connection(
            endpoint, timeout=connect_timeout_s)
        self._sock.settimeout(timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0
        self._out = bytearray()
        self._pending: deque = deque()

    @property
    def closed(self) -> bool:
        """True once the connection is gone (submits will raise)."""
        return self._sock is None

    def submit(self, op: int, payload: bytes, flags: int = 0, *,
               prefix: bytes = b"", wrs=None) -> int:
        """Frame one doorbell batch into the output buffer.

        Nothing hits the socket yet — the k frames of a pipelined
        exchange coalesce into one ``sendall`` at the first
        :meth:`complete`.  Returns the framed bytes (header + trace
        prefix + payload), which is what ``bytes_tx`` records.
        """
        if self._sock is None:
            raise ConnectionError("bearer connection closed")
        W = _wire()
        pflags = flags | (W.FLAG_TRACE if prefix else 0)
        self._seq += 1
        buf = W.pack_frame(op, prefix + payload, flags=pflags,
                           seq=self._seq)
        self._out += buf
        self._pending.append((op, self._seq))
        self.wire["frames_tx"] += 1
        self.wire["bytes_tx"] += len(buf)
        return len(buf)

    def flush(self) -> None:
        """Push every buffered frame to the socket in one write."""
        if self._out and self._sock is not None:
            out, self._out = self._out, bytearray()
            self._sock.sendall(bytes(out))

    def complete(self):
        """Blocking read of the next in-order response.

        Flushes first (the doorbell ring), then receives exactly one
        frame and matches it against the oldest outstanding submission
        -> ``(op, flags, payload)``.
        """
        if not self._pending:
            raise RuntimeError("no outstanding work on this bearer")
        if self._sock is None:
            raise ConnectionError("bearer connection closed")
        W = _wire()
        self.flush()
        rop, rflags, rseq, payload = W.recv_frame(self._sock)
        op, seq = self._pending.popleft()
        self.wire["frames_rx"] += 1
        self.wire["bytes_rx"] += W.HEADER_BYTES + len(payload)
        if rseq != (seq & 0xFFFFFFFF) or rop != op:
            raise ConnectionError(
                f"out-of-order response (seq {rseq} != {seq})")
        return rop, rflags, payload

    def close(self) -> None:
        """Drop the connection (idempotent)."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._out = bytearray()
                self._pending.clear()
