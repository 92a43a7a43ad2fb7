"""Symmetric int8 per-group codec for the quantized resident tier.

Encoding: values are split into contiguous groups of ``group`` floats;
each group stores ``scale = absmax / 127`` in a codebook array and codes
``round(x / scale)`` clipped to [-127, 127].  Symmetric means the
zero-point is identically 0 (stored implicitly) — dequantization is a
single fused multiply, which is what lets the device serve path
dequantize in registers right before the MXU matmul.

The group size must divide the vector dimensionality so that group
boundaries never straddle two vectors of a serialized partition span
(``layout.py`` flattens vectors back-to-back inside each block); per-
vector-segment scales are what makes the codec density-aware: a dense,
small-magnitude vector is not forced onto the range of an outlier
neighbour in the same block.

Wire format per block (the doorbell/DMA granularity): ``vblk`` int8
codes + ``vblk / group`` f32 scales appended as codebook blocks —
``layout.LayoutSpec.quant_block_bytes`` prices it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EPS = 1e-12          # guards all-zero groups (scale 0 would divide by 0)
QMAX = 127.0


@dataclass(frozen=True)
class QuantizedBlocks:
    """A quantized mirror of a block buffer: lockstep (n_blocks, ...)"""

    codes: np.ndarray    # (n_blocks, vblk) int8
    scales: np.ndarray   # (n_blocks, vblk // group) f32
    group: int


def quantize_groups(x: np.ndarray, group: int):
    """(..., D) f32 -> codes (..., D) int8, scales (..., D // group) f32.

    ``group`` must divide the trailing dimension.
    """
    x = np.asarray(x, np.float32)
    d = x.shape[-1]
    assert d % group == 0, (d, group)
    gx = x.reshape(*x.shape[:-1], d // group, group)
    scales = np.abs(gx).max(axis=-1) / QMAX
    codes = np.rint(gx / np.maximum(scales, EPS)[..., None])
    codes = np.clip(codes, -QMAX, QMAX).astype(np.int8)
    return codes.reshape(x.shape), scales.astype(np.float32)


def dequantize_groups(codes: np.ndarray, scales: np.ndarray, group: int):
    """Inverse of ``quantize_groups`` (lossy): codes * scale per group."""
    c = np.asarray(codes, np.float32)
    d = c.shape[-1]
    gx = c.reshape(*c.shape[:-1], d // group, group)
    return (gx * scales[..., None]).reshape(c.shape).astype(np.float32)


def quantize_blocks(vec_buf: np.ndarray, group: int) -> QuantizedBlocks:
    """Quantize a whole (n_blocks, vblk) block buffer in one shot."""
    codes, scales = quantize_groups(vec_buf, group)
    return QuantizedBlocks(codes=codes, scales=scales, group=group)


# ------------------------------------------------------------- device twin

def quantize_row_torch(vec, group: int):
    """torch twin of ``quantize_groups`` for one (D,) f32 row, on the row's
    device — the insert path's device scatter of a quantized overflow
    write.  Returns (codes (D,) int8, scales (D//group,) f32), equal bit
    for bit to ``quantize_groups``: the same f32 divides, ``torch.round``
    rounds half to even as ``np.rint`` does, and the clip to +-127.  The
    divisor 127 is a tensor: on the card torch turns a division by a
    host scalar into a product with its reciprocal, which rounds
    differently.
    """
    import torch
    d = vec.shape[-1]
    gx = vec.to(torch.float32).reshape(d // group, group)
    amax = gx.abs().amax(dim=-1)
    scales = amax / torch.full_like(amax, QMAX)
    codes = torch.round(gx / torch.clamp(scales, min=EPS)[:, None])
    codes = torch.clamp(codes, -QMAX, QMAX).to(torch.int8)
    return codes.reshape(d), scales
