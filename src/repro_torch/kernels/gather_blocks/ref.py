"""Plain torch version of the doorbell block gather."""
from __future__ import annotations

import torch


def gather_blocks_ref(buf: torch.Tensor, block_ids: torch.Tensor):
    """buf (n_blocks, blk); block_ids (m,) int -> (m, blk)."""
    return buf.index_select(0, block_ids.long())
