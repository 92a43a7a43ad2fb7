"""Public wrappers for the doorbell span gather.

``gather_spans`` fetches the same block ids from one to three staged
buffers (one span read of the pool); ``gather_blocks`` is its one-buffer
case.  Both run the plain version for tensors on the CPU and launch the
CUDA kernel (``csrc/gather_blocks.cu``) for tensors on the card, one
launch per call whatever the number of buffers; there is no fallback from
one to the other.  ``launches`` counts kernel launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_blocks.ref import gather_spans_ref
from repro_torch.obs.trace import TRACER

launches = 0
MAX_BUFS = 3
# the out-of-range flag per (device, stream), as the launches on one stream
# run in order: zeroed once, and again by the call that reads it set
_flags: dict = {}


def flag(device) -> torch.Tensor:
    """The out-of-range flag of PyTorch's current stream on ``device`` (one
    int32 on the card), 0 between calls."""
    key = (device, _build.stream_handle(device))
    buf = _flags.get(key)
    if buf is None:
        buf = _flags[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return buf


def _launch(bufs, ids: torch.Tensor, outs, bad: torch.Tensor) -> None:
    """Launch the kernel into ``outs`` (no checks, not counted).  The
    kernel sets ``bad`` (one int32 on the card) to 1 if an id is out of
    range for a buffer."""
    table = (ctypes.c_longlong * (4 * len(bufs)))(*[
        x for buf, out in zip(bufs, outs)
        for x in (buf.data_ptr(), out.data_ptr(),
                  buf.shape[1] * buf.element_size(), buf.shape[0])])
    err = _build.library().gather_spans_launch(
        table, len(bufs), ids.data_ptr(), ids.shape[0], bad.data_ptr(),
        _build.stream_handle(ids.device))
    _build.check(err, "gather_spans")


def _check(bufs, ids) -> None:
    if not 1 <= len(bufs) <= MAX_BUFS:
        raise ValueError(f"1 to {MAX_BUFS} buffers, got {len(bufs)}")
    for buf in bufs:
        if buf.dim() != 2:
            raise ValueError(f"buf must be 2-D, got {tuple(buf.shape)}")
        if buf.device != ids.device:
            raise ValueError(f"buf on {buf.device}, block_ids on "
                             f"{ids.device}")
    if ids.dim() != 1:
        raise ValueError(f"block_ids must be 1-D, got {tuple(ids.shape)}")


def gather_spans(bufs, block_ids: torch.Tensor) -> list:
    """One span read: fetch ``block_ids`` rows of every buffer of ``bufs``
    in a single launch.  bufs: 1 to 3 tensors (n_blocks_j, blk_j) of any
    dtype; block_ids (m,) -> [(m, blk_j)], one per buffer.

    An id outside a buffer's ``[0, n_blocks_j)`` raises ``IndexError`` on
    both devices; on the card that check reads the stream's flag, so every
    call waits for its launch to finish."""
    global launches
    bufs = list(bufs)
    _check(bufs, block_ids)
    if block_ids.device.type == "cpu":
        return gather_spans_ref(bufs, block_ids)
    if block_ids.device.type != "cuda":
        raise ValueError(f"gather_spans: unsupported device "
                         f"{block_ids.device}")
    bufs = [buf.contiguous() for buf in bufs]
    ids = block_ids.to(torch.int32).contiguous()
    outs = [torch.empty((ids.shape[0], buf.shape[1]), dtype=buf.dtype,
                        device=buf.device) for buf in bufs]
    if ids.shape[0] and any(buf.shape[1] for buf in bufs):
        bad = flag(ids.device)
        _launch(bufs, ids, outs, bad)
        launches += 1
        with TRACER.wait("gather_check"):
            out_of_range = bad.item()
        if out_of_range:
            bad.zero_()
            raise IndexError(f"gather_spans: a block id is outside "
                             f"[0, n_blocks) of a buffer "
                             f"({[buf.shape[0] for buf in bufs]})")
    return outs


def gather_blocks(buf: torch.Tensor, block_ids: torch.Tensor):
    """One doorbell batch from one buffer: ``gather_spans([buf],
    block_ids)[0]``.  buf (n_blocks, blk) of any dtype; block_ids (m,) ->
    (m, blk)."""
    return gather_spans([buf], block_ids)[0]
