"""Fused int8 dequant + L2 distance + top-k: CUDA kernel (csrc/) + plain
torch version."""
