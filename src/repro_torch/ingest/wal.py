"""Write-ahead log for pool-server mutations.

Every state-mutating verb a ``PoolServer`` acks (``attach``,
``attach_quant``, ``append``, ``write_blocks``) is first appended here
as one record.  A record carries the verb's *wire encoding* verbatim —
``(op, flags, payload)`` exactly as it arrived in the frame — so replay
is re-dispatch through the same handler table, and the WAL needs no
codec of its own beyond framing:

    record := u32 body_len | u32 crc32(body) | body
    body   := u8 op | u16 flags | payload bytes

Torn-tail semantics: a crash mid-append leaves a short or CRC-broken
final record; ``iter_records`` stops cleanly at the first bad record and
reports how many trailing bytes it abandoned, so recovery replays every
fully-committed mutation and nothing else.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Tuple

from repro_torch.obs.trace import TRACER

_HDR = struct.Struct("<II")     # body_len, crc32(body)
_BODY = struct.Struct("<BH")    # op, flags

#: Upper bound on one record body (64 MiB) — a corrupt length prefix
#: must not allocate unbounded memory during replay.
MAX_BODY = 64 << 20


@dataclass(frozen=True)
class WalRecord:
    """One replayable mutation: the verb's wire triple."""

    op: int
    flags: int
    payload: bytes


def encode_record(op: int, flags: int, payload: bytes) -> bytes:
    """Frame one mutation as a self-checking WAL record."""
    if not 0 <= op <= 0xFF:
        raise ValueError(f"op {op} out of u8 range")
    if not 0 <= flags <= 0xFFFF:
        raise ValueError(f"flags {flags} out of u16 range")
    body = _BODY.pack(op, flags) + bytes(payload)
    return _HDR.pack(len(body), zlib.crc32(body)) + body


def iter_records(buf: bytes) -> Iterator[WalRecord]:
    """Yield committed records from a log image, stopping cleanly at a
    torn tail (short header, short body, oversized length, or CRC
    mismatch — all treated as end-of-log, never an exception)."""
    off = 0
    n = len(buf)
    while off + _HDR.size <= n:
        body_len, crc = _HDR.unpack_from(buf, off)
        if body_len < _BODY.size or body_len > MAX_BODY:
            return
        end = off + _HDR.size + body_len
        if end > n:
            return
        body = buf[off + _HDR.size:end]
        if zlib.crc32(body) != crc:
            return
        op, flags = _BODY.unpack_from(body)
        yield WalRecord(op, flags, body[_BODY.size:])
        off = end


def read_wal(path: str) -> Tuple[List[WalRecord], int]:
    """Read a log file -> (committed records, torn tail bytes dropped).

    A missing file reads as an empty log (fresh server).
    """
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return [], 0
    records = list(iter_records(buf))
    consumed = sum(_HDR.size + _BODY.size + len(r.payload) for r in records)
    return records, len(buf) - consumed


class WriteAheadLog:
    """Append-only mutation log with durable-before-ack semantics.

    ``fsync=True`` makes every append an fsync (crash-safe against power
    loss); the default flushes to the OS (crash-safe against process
    death — the kill -9 case the tests exercise) without paying a disk
    sync per verb.
    """

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "ab")
        self.records = 0           # appended this session
        self.bytes = self._f.tell()

    def append(self, op: int, flags: int, payload: bytes) -> int:
        """Durably append one mutation; returns the session record index.

        Emits an ``ingest.wal_append`` trace event when tracing is on.
        """
        rec = encode_record(op, flags, payload)
        t0 = time.perf_counter()
        self._f.write(rec)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.records += 1
        self.bytes += len(rec)
        if TRACER.enabled:
            TRACER.add("ingest.wal_append", "ingest", t0,
                       time.perf_counter() - t0, op=int(op),
                       bytes=len(rec))
        return self.records - 1

    def truncate(self) -> None:
        """Reset the log (a checkpoint just made its records redundant)."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = open(self.path, "ab")
        self.bytes = 0

    def close(self) -> None:
        """Flush and release the log file handle."""
        try:
            self._f.flush()
            self._f.close()
        except ValueError:          # already closed
            pass
