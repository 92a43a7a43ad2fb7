"""AdamW with a cosine schedule and global-norm clipping, on torch.

Port of ``repro/train/adamw.py``: plain functions over the same nested
dict trees as the params.  The reference donates params and state to a
jitted step and gets new arrays back; here ``update`` writes the params,
``m``, ``v`` and the step counter in place under ``torch.no_grad()``, so
a step allocates no second copy of the state (the f32 masters, m and v
of qwen3-8b at 4 layers are 24.2 GB).  The arithmetic is the
reference's, in its order: the same f32 expressions per leaf, the
schedule on the int32 step, the squares summed leaf by leaf in tree
order.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any
    v: Any


def init(params) -> AdamWState:
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = T.leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      T.tree_map(z, params), T.tree_map(z, params))


def cosine_lr(step, *, peak=3e-4, warmup=100, total=10_000, floor=0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``; ``step`` an int32 tensor."""
    warm = peak * (step + 1) / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the leaves' squares summed, leaf by leaf in order (the
    reference's Python ``sum`` over ``jax.tree.leaves``)."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm=1.0):
    """(``grads`` scaled to a global norm of at most ``max_norm``, the
    norm before)."""
    norm = global_norm(T.leaves(grads))
    scale = _clip_scale(norm, max_norm)
    return T.tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr_fn=cosine_lr,
           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0):
    """One AdamW step, in place: ``params``, ``state.m``, ``state.v`` and
    ``state.step`` are written.  Returns (params, state, {"lr",
    "grad_norm"}).  As in the reference, the schedule reads the already
    incremented step."""
    g_leaves = [g.float() for g in T.leaves(grads)]
    if clip:
        gnorm = global_norm(g_leaves)
        scale = _clip_scale(gnorm, clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32,
                            device=state.step.device)
        scale = None
    state.step.add_(1)
    step = state.step
    lr = lr_fn(step)
    b1c = 1 - b1 ** step.float()
    b2c = 1 - b2 ** step.float()
    for p, g, m, v in zip(T.leaves(params), g_leaves, T.leaves(state.m),
                          T.leaves(state.v)):
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        del g
        # p32 - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p32)
        p32 = p.float()
        u = m.div(b1c).div_(v.div(b2c).sqrt_().add_(eps))
        u.add_(weight_decay * p32).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p32.sub_(u))
    return params, state, {"lr": lr, "grad_norm": gnorm}
