"""Bulk loading and compaction for the port's memory pool.

Copies of ``repro/ingest/loader.py`` and ``repro/ingest/compactor.py``
(they import no framework) with only the imports rewritten:

* ``loader.py``    — out-of-core bulk loading: stream vectors in bounded
                     chunks, spill them to disk, and serialize the region
                     group by group, bit-identical to an in-memory build
                     (``DHNSWEngine.build_streaming``).
* ``compactor.py`` — the compaction daemon that watches per-group
                     overflow through the pool's mutation hooks and
                     issues ``repack`` verbs under a rate budget.

The write-ahead log and checkpoints (``wal.py``, ``checkpoint.py``) serve
the network pool server and come with it.
"""
from repro_torch.ingest.compactor import CompactionPolicy, Compactor
from repro_torch.ingest.loader import BulkLoader, LoadReport, chunked_source

__all__ = ["BulkLoader", "LoadReport", "chunked_source", "Compactor",
           "CompactionPolicy"]
