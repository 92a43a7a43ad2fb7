"""Plain torch version of the doorbell span gather."""
from __future__ import annotations

import torch


def gather_blocks_ref(buf: torch.Tensor, block_ids: torch.Tensor):
    """buf (n_blocks, blk); block_ids (m,) int -> (m, blk)."""
    return buf.index_select(0, block_ids.long())


def gather_spans_ref(bufs, block_ids: torch.Tensor) -> list:
    """One span read: ``gather_blocks_ref`` of every buffer with the same
    ids -> [(m, blk_j)]."""
    return [gather_blocks_ref(buf, block_ids) for buf in bufs]
