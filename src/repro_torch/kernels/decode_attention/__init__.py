"""GQA flash-decode attention: CUDA kernel (csrc/) + plain torch
version."""
