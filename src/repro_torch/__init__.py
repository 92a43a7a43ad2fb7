"""PyTorch/CUDA port of the d-HNSW system (``repro`` is the JAX reference).

The package mirrors ``repro``'s layout and names.  Host-side modules
(HNSW build, meta index, region layout, round scheduler, cost model,
codec, tracer, synthetic data) are framework-free copies; the device
path (routing, span decode, in-partition search, merge, the int8 flat
stage 1, the insert path's device scatters) is plain PyTorch, bulk
loading and compaction (``ingest``) are framework-free copies, and the
two kernels on that path
(``kernels/gather_blocks``, ``kernels/quant_topk``) are CUDA C++ for
Hopper built with ``nvcc`` and bound through ``ctypes``.

Entry points run on the card: ``DHNSWEngine(cfg)`` places every tensor
on ``"cuda"`` unless the caller passes ``device="cpu"``; asking for
``"cuda"`` on a machine without a card raises.
"""
from repro_torch.core.engine import DHNSWEngine, EngineConfig

__all__ = ["DHNSWEngine", "EngineConfig"]
