"""Public wrapper for the doorbell block gather.

``gather_blocks`` runs the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/gather_blocks.cu``) for tensors on the
card; there is no fallback from one to the other.  ``launches`` counts
kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_blocks.ref import gather_blocks_ref

launches = 0


def _launch(buf: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
            bad: torch.Tensor) -> None:
    """Launch the kernel into ``out`` (no checks, not counted).  The
    kernel sets ``bad`` (one int32 on the card) to 1 if an id is out of
    range."""
    lib = _build.library()
    err = lib.gather_blocks_launch(
        buf.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
        buf.shape[1] * buf.element_size(), buf.shape[0], bad.data_ptr(),
        _build.stream_handle(buf.device))
    _build.check(err, "gather_blocks")


def gather_blocks(buf: torch.Tensor, block_ids: torch.Tensor):
    """One doorbell batch: fetch ``block_ids`` rows of ``buf`` in a single
    launch.  buf (n_blocks, blk) of any dtype; block_ids (m,) -> (m, blk).

    An id outside ``[0, n_blocks)`` raises ``IndexError`` on both
    devices; on the card that check waits for the launch to finish."""
    global launches
    if buf.dim() != 2:
        raise ValueError(f"buf must be 2-D, got {tuple(buf.shape)}")
    if block_ids.dim() != 1:
        raise ValueError(f"block_ids must be 1-D, got {tuple(block_ids.shape)}")
    if buf.device != block_ids.device:
        raise ValueError(f"buf on {buf.device}, block_ids on "
                         f"{block_ids.device}")
    if buf.device.type == "cpu":
        return gather_blocks_ref(buf, block_ids)
    if buf.device.type != "cuda":
        raise ValueError(f"gather_blocks: unsupported device {buf.device}")
    buf = buf.contiguous()
    ids = block_ids.to(torch.int32).contiguous()
    out = torch.empty((ids.shape[0], buf.shape[1]), dtype=buf.dtype,
                      device=buf.device)
    if ids.shape[0] and buf.shape[1]:
        bad = torch.zeros(1, dtype=torch.int32, device=buf.device)
        _launch(buf, ids, out, bad)
        launches += 1
        if bad.item():
            raise IndexError(f"gather_blocks: a block id is outside "
                             f"[0, {buf.shape[0]})")
    return out
