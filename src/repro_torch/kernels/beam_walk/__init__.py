"""Sub-HNSW beam walk (one launch a pair chunk): CUDA kernel (csrc/) +
plain torch version."""
