"""Symmetric int8 per-group codec (host half) for the quantized tier."""
from repro_torch.quant.codec import (QuantizedBlocks, dequantize_groups,
                                     quantize_blocks, quantize_groups)

__all__ = ["QuantizedBlocks", "quantize_groups", "dequantize_groups",
           "quantize_blocks"]
