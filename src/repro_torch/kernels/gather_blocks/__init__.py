"""Doorbell span gather (one launch per span read, over one to three
buffers): CUDA kernel (csrc/) + plain torch version."""
