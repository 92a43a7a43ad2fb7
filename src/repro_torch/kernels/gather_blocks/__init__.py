"""Doorbell block gather: CUDA kernel (csrc/) + plain torch version."""
