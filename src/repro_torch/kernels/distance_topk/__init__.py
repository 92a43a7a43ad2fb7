"""Fused f32 L2 distance + top-k: CUDA kernel (csrc/) + plain torch
version."""
