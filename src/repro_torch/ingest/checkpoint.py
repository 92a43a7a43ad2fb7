"""Atomic region checkpoints + the per-server durability orchestrator.

A checkpoint is one self-checking file holding the full serialized
region — literally the wire ``ATTACH`` payload (``net/wire.enc_attach``)
with a small header — committed with the write-temp-fsync-rename idiom
(the same discipline as ``train/checkpoint.py``), so a reader sees
either the old checkpoint or the new one, never a torn file.

``Durability`` glues checkpointing to the WAL for a ``PoolServer``
running with ``--data-dir``:

* every mutating verb is logged (``log``) before the server acks;
* ``maybe_checkpoint`` snapshots the region every ``checkpoint_every``
  logged records and *rotates* the WAL — the new log file is named by
  the total records already folded into the checkpoint, so a crash
  between the checkpoint rename and the rotation can never replay a
  record twice (the stale log's name no longer matches);
* ``recover`` loads the checkpoint (if any) and returns the committed
  WAL tail for the caller to replay through its verb handlers.

Data-dir layout::

    <data_dir>/checkpoint.bin     the region snapshot (atomic)
    <data_dir>/wal.<applied>.log  mutations since that snapshot
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import List, Optional, Tuple

from repro_torch.ingest.wal import WalRecord, WriteAheadLog, read_wal
from repro_torch.obs.trace import TRACER

MAGIC = b"dHCK"
VERSION = 1
_HDR = struct.Struct("<4sHHQIQ")   # magic, version, flags, applied, crc, len

CKPT_FILE = "checkpoint.bin"


def _wal_path(data_dir: str, applied: int) -> str:
    return os.path.join(data_dir, f"wal.{applied:012d}.log")


def save_checkpoint(data_dir: str, store, *, applied: int = 0) -> int:
    """Atomically snapshot ``store`` into ``<data_dir>/checkpoint.bin``.

    ``applied`` is the total mutation count folded into this snapshot
    (the WAL rotation key).  Returns bytes written.
    """
    from repro_torch.net import wire as W
    payload, flags = W.enc_attach(store)
    hdr = _HDR.pack(MAGIC, VERSION, flags, applied, zlib.crc32(payload),
                    len(payload))
    path = os.path.join(data_dir, CKPT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(hdr)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    dirfd = os.open(data_dir, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return len(hdr) + len(payload)


def load_checkpoint(data_dir: str):
    """Load a checkpoint -> ``(store, applied)``, or ``None`` if absent.

    Raises ``IOError`` on a corrupt file (bad magic, version, or CRC) —
    corruption must be surfaced, not silently served.
    """
    from repro_torch.net import wire as W
    path = os.path.join(data_dir, CKPT_FILE)
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return None
    if len(buf) < _HDR.size:
        raise IOError(f"checkpoint {path}: truncated header")
    magic, version, flags, applied, crc, plen = _HDR.unpack_from(buf)
    if magic != MAGIC or version != VERSION:
        raise IOError(f"checkpoint {path}: bad magic/version")
    payload = buf[_HDR.size:]
    if len(payload) != plen or zlib.crc32(payload) != crc:
        raise IOError(f"checkpoint {path}: checksum mismatch")
    return W.dec_attach(payload, flags), applied


class Durability:
    """WAL + checkpoint lifecycle for one pool server's region."""

    def __init__(self, data_dir: str, *, checkpoint_every: int = 256,
                 fsync: bool = False):
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.checkpoint_every = checkpoint_every
        self.fsync = fsync
        self.replaying = False       # suppress log() during replay
        self.applied = 0             # total mutations (ckpt + WAL)
        self._ckpt_base = 0          # mutations folded into the ckpt
        self.n_checkpoints = 0
        self.checkpoint_bytes = 0
        self.replayed_records = 0
        self.torn_bytes = 0
        self.recovered = False
        self._wal: Optional[WriteAheadLog] = None

    # ------------------------------------------------------------ recovery

    def recover(self) -> Tuple[Optional[object], List[WalRecord]]:
        """Load the checkpoint + committed WAL tail -> (store, tail).

        The caller replays ``tail`` through its verb handlers (wrapped
        in :meth:`replay_guard` so replay is never re-logged), then
        normally calls :meth:`checkpoint` to fold the tail in.  Stale
        WAL files from an interrupted rotation are deleted here.
        """
        store = None
        ck = load_checkpoint(self.data_dir)
        if ck is not None:
            store, self._ckpt_base = ck
            self.recovered = True
        tail_path = _wal_path(self.data_dir, self._ckpt_base)
        records, torn = read_wal(tail_path)
        self.torn_bytes = torn
        self.replayed_records = len(records)
        if records:
            self.recovered = True
        for name in os.listdir(self.data_dir):
            p = os.path.join(self.data_dir, name)
            if name.startswith("wal.") and p != tail_path:
                os.remove(p)        # pre-checkpoint log: already folded in
        self.applied = self._ckpt_base + len(records)
        self._wal = WriteAheadLog(tail_path, fsync=self.fsync)
        return store, records

    def replay_guard(self):
        """Context manager marking handler dispatch as replay (no log)."""
        dur = self

        class _Guard:
            def __enter__(self):
                dur.replaying = True
                return dur

            def __exit__(self, *exc):
                dur.replaying = False
                return False

        return _Guard()

    # ------------------------------------------------------------ logging

    def log(self, op: int, flags: int, payload: bytes) -> None:
        """Append one mutating verb to the WAL (no-op during replay)."""
        if self.replaying:
            return
        if self._wal is None:
            self._wal = WriteAheadLog(
                _wal_path(self.data_dir, self._ckpt_base), fsync=self.fsync)
        self._wal.append(op, flags, payload)
        self.applied += 1

    def pending(self) -> int:
        """Mutations logged since the last checkpoint."""
        return self.applied - self._ckpt_base

    def maybe_checkpoint(self, store) -> bool:
        """Checkpoint when the cadence says so; returns True if it did."""
        if self.checkpoint_every <= 0 or store is None:
            return False
        if self.pending() < self.checkpoint_every:
            return False
        self.checkpoint(store)
        return True

    def checkpoint(self, store) -> int:
        """Snapshot the region now and rotate the WAL.  Returns bytes."""
        t0 = time.perf_counter()
        n = save_checkpoint(self.data_dir, store, applied=self.applied)
        old = self._wal
        self._ckpt_base = self.applied
        self._wal = WriteAheadLog(_wal_path(self.data_dir, self._ckpt_base),
                                  fsync=self.fsync)
        if old is not None:
            old.close()
            if old.path != self._wal.path and os.path.exists(old.path):
                os.remove(old.path)
        self.n_checkpoints += 1
        self.checkpoint_bytes += n
        if TRACER.enabled:
            TRACER.add("ingest.checkpoint", "ingest", t0,
                       time.perf_counter() - t0, bytes=n,
                       applied=self.applied)
        return n

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Durability counters for the STATS verb / Prometheus export."""
        return {
            "applied": self.applied,
            "wal_records": 0 if self._wal is None else self._wal.records,
            "wal_bytes": 0 if self._wal is None else self._wal.bytes,
            "checkpoints": self.n_checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "replayed_records": self.replayed_records,
            "torn_bytes": self.torn_bytes,
            "recovered": self.recovered,
        }

    def close(self) -> None:
        """Release the WAL handle (server shutdown)."""
        if self._wal is not None:
            self._wal.close()
