"""The training step, on torch.

Port of ``repro/train/train_step.py``'s ``loss_fn`` and
``make_train_step``.  The reference's step is a function for
``jax.jit`` with shardings over a mesh; here it is a function that runs
the forward (each layer recomputed in the backward), autograd through
the flash backward and the chunked cross-entropy, and AdamW in place.
Gradients accumulate in the f32 masters' ``.grad`` (the reference's f32
accumulator of its micro-step scan), are divided by ``micro_steps``, and
are dropped after the update.

``REPRO_CAST_PARAMS_ONCE=1`` casts the f32 matrices (leaves of 2 or
more dims) to the compute dtype once at the top of the step, as the
reference does without a mesh too; gradients reach the masters through
the cast, and a matrix used more than once (the unembed across CE
chunks) then meets its gradients in the compute dtype, as there.  The
reference's ``REPRO_LOSS_UNEMBED_TP`` and ``REPRO_SHARDED_CE`` act on a
mesh only and have no counterpart on one card; ``make_prefill_step``,
``make_decode_step`` and ``make_step`` belong with the mesh machinery.
"""
from __future__ import annotations

import os

import torch

from repro_torch import tree as T
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import compute_dtype
from repro_torch.train import adamw


def loss_fn(cfg, params, batch, aux_weight=0.01):
    """(loss + aux_weight * moe aux, {"loss", "aux"}).  A vlm batch with
    patches scores only the text positions (the patches are
    prepended)."""
    hidden, aux = M.forward(cfg, params, batch, return_hidden=True)
    if cfg.family == "vlm" and batch.get("patches") is not None:
        hidden = hidden[:, batch["patches"].shape[1]:]
    loss = L.chunked_cross_entropy(hidden, params["unembed"],
                                   batch["labels"],
                                   softcap=cfg.logit_softcap)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def cast_tree(params, dtype):
    """The f32 leaves of 2 or more dims cast to ``dtype`` (differentiably),
    the others as they are."""
    return T.tree_map(lambda x: x.to(dtype) if (
        x.dtype == torch.float32 and x.ndim >= 2) else x, params)


def accumulate_grads(cfg, params, batch, *, micro_steps: int = 1,
                     cast_once: bool = False) -> dict:
    """Backward of ``loss_fn`` into the masters' ``.grad`` over
    ``micro_steps`` slices of the batch (each the next B / micro_steps
    rows), the sums divided by ``micro_steps``; the metrics, averaged
    over the micro-steps.  The masters must require grad, with ``.grad``
    None."""
    B = batch["tokens"].shape[0]
    if B % micro_steps:
        raise ValueError(f"batch {B} is not a multiple of {micro_steps} "
                         f"micro-steps")
    mb = B // micro_steps
    ms = []
    for i in range(micro_steps):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        p = cast_tree(params, compute_dtype(cfg)) if cast_once else params
        total, metrics = loss_fn(cfg, p, part)
        total.backward()
        ms.append({k: v.detach() for k, v in metrics.items()})
    for leaf in T.leaves(params):
        if leaf.grad is None:     # unused here (vlm patch_proj, no patches)
            leaf.grad = torch.zeros_like(leaf)
        elif micro_steps > 1:
            leaf.grad.div_(micro_steps)
    if micro_steps == 1:
        return ms[0]
    return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}


def make_train_step(cfg: ModelConfig, shape: InputShape,
                    micro_steps: int = 1):
    """The step ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: params and opt_state are updated in place (and
    returned); metrics holds 0-d tensors ``loss``, ``aux``, ``lr`` and
    ``grad_norm``.  ``shape`` is the cell the step is made for, as in the
    reference (its batch must divide into ``micro_steps``)."""
    if shape.global_batch % micro_steps:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {micro_steps} micro-steps")
    cast_once = bool(os.environ.get("REPRO_CAST_PARAMS_ONCE"))

    def train_step(params, opt_state, batch):
        masters = T.leaves(params)
        for leaf in masters:
            leaf.requires_grad_(True)
            leaf.grad = None
        try:
            metrics = accumulate_grads(cfg, params, batch,
                                       micro_steps=micro_steps,
                                       cast_once=cast_once)
            grads = T.tree_map(lambda leaf: leaf.grad, params)
            params, opt_state, opt_metrics = adamw.update(grads, opt_state,
                                                          params)
        finally:
            for leaf in masters:
                leaf.grad = None
                leaf.requires_grad_(False)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
