"""Streaming ingestion and durability for the port's memory pool.

Copies of ``repro/ingest`` (they import no framework) with only the
imports rewritten:

* ``wal.py``        — a length-prefixed, CRC-checked write-ahead log of
                      the state-mutating verbs; records reuse the wire
                      codecs verbatim, so replay is just re-dispatch.
* ``checkpoint.py`` — atomic region snapshots (write-temp-fsync-rename)
                      plus ``Durability``, the per-server orchestrator a
                      ``PoolServer --data-dir`` runs: log every mutation
                      before acking, checkpoint on a cadence, recover
                      checkpoint + WAL tail on restart.
* ``loader.py``     — out-of-core bulk loading: stream vectors in bounded
                      chunks, spill them to disk, and serialize the region
                      group by group, bit-identical to an in-memory build
                      (``DHNSWEngine.build_streaming``).
* ``compactor.py``  — the compaction daemon that watches per-group
                      overflow through the pool's mutation hooks and
                      issues ``repack`` verbs under a rate budget.
"""
from repro_torch.ingest.checkpoint import (Durability, load_checkpoint,
                                           save_checkpoint)
from repro_torch.ingest.compactor import CompactionPolicy, Compactor
from repro_torch.ingest.loader import BulkLoader, LoadReport, chunked_source
from repro_torch.ingest.wal import (WalRecord, WriteAheadLog, encode_record,
                                    iter_records, read_wal)

__all__ = ["WriteAheadLog", "WalRecord", "encode_record", "iter_records",
           "read_wal", "save_checkpoint", "load_checkpoint", "Durability",
           "BulkLoader", "LoadReport", "chunked_source", "Compactor",
           "CompactionPolicy"]
