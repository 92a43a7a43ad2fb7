"""Gradient compression for the data-parallel all-reduce, on torch.

Port of ``repro/distributed/compression.py``: int8 quantization with
**error feedback** (residual carry).  Each step quantizes ``g + e`` per
leaf with a scale shared by every rank, all-reduces the int8 payload
(summed as int32, so it cannot overflow), dequantizes, and keeps the
local quantization error in ``e``.  The reference's ``lax.pmax`` /
``lax.psum`` inside a ``shard_map`` become ``all_reduce(MAX)`` /
``all_reduce(SUM)`` over a ``torch.distributed`` group (gloo on the
CPU, NCCL with a card a rank; the caller initialises it).  Rounding is
half to even on both sides (``jnp.round``, ``torch.round``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import tree as T


class ErrorState(NamedTuple):
    residual: Any  # tree like the grads (f32)


def init_error_state(grads_like) -> ErrorState:
    return ErrorState(T.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 payload, per-leaf scale)."""
    absmax = g.abs().max()
    # a tensor divisor: on the card torch divides by a Python scalar as a
    # product with its reciprocal; the reference's eager quantize divides
    scale = torch.clamp(absmax, min=1e-12) / absmax.new_tensor(127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g, e):
    """(grad, residual) -> (int8, scale, the quantized target g + e)."""
    target = g.float() + e
    q, scale = quantize(target)
    return q, scale, target


def _f32_reciprocal(n) -> float:
    """1 / n rounded to f32.  The reference's reduce is always compiled,
    and XLA turns a division by a constant into a product with its f32
    reciprocal (for 127, 1 ulp from the quotient for some absmax);
    ``quantize`` runs eagerly there and divides."""
    return torch.tensor(1.0 / n, dtype=torch.float32).item()


INV_127 = _f32_reciprocal(127)


def _residual(target, q, scale):
    """The local quantization error ``target - q * scale`` rounded once,
    as the reference's compiled code computes it (XLA contracts it into
    one fused multiply-add).  In f64 the product of an int8 and an f32 is
    exact, and so is the difference where q != 0 (|target| >= scale / 2
    keeps it within 53 bits; where q == 0 it is target itself), so the
    cast back to f32 is the fused result's one rounding on any
    compiler."""
    return (target.double() - q.double() * scale.double()).float()


def compressed_grad_reduce(grads, err: ErrorState, group=None):
    """The mean over ``group``'s ranks (the default group when None) of
    each rank's local ``grads``, through int8: returns (dequantized mean
    grads, the new ``ErrorState``).  Two collectives a leaf: the shared
    absmax, then the int32 sum of the payloads."""
    n = dist.get_world_size(group)

    def leaf(g, e):
        target = g.float() + e
        # a SHARED scale: the int8 payloads then share one codebook, so
        # the int32 sum dequantizes exactly (a per-rank scale would not)
        absmax = target.abs().max()
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(absmax, min=1e-12) * INV_127
        q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
        acc = q.to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        g_hat = acc.float() * scale * _f32_reciprocal(n)
        return g_hat, _residual(target, q, scale)

    out = [leaf(g, e) for g, e in zip(T.leaves(grads),
                                      T.leaves(err.residual))]
    return (T.unflatten(grads, [g for g, _ in out]),
            ErrorState(T.unflatten(grads, [e for _, e in out])))


def wire_bytes_saved(grads) -> dict:
    """Accounting helper: f32 vs int8(+scale) all-reduce payload."""
    n = sum(int(g.numel()) for g in T.leaves(grads))
    return {"f32_bytes": 4 * n, "int8_bytes": n + 4,
            "ratio": 4 * n / (n + 4)}
