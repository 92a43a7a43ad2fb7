"""d-HNSW core: host-side build (hnsw, meta, layout), the round scheduler,
the network cost model, and the torch device path (search, device_store)."""
