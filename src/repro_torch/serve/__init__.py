"""Serving tier of the port: ``SearchServer`` / ``MicroBatcher`` (copies of
the reference's, over the port's engine) and ``RagServeEngine``, d-HNSW
retrieval in front of an LM's prefill and greedy decode."""
