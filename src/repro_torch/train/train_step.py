"""train/prefill/decode step factories, on torch.

Port of ``repro/train/train_step.py``.  ``make_train_step`` returns the
step: a function that runs the forward (each layer recomputed in the
backward), autograd through the flash backward and the chunked
cross-entropy, and AdamW in place.  Gradients accumulate in the working
params' ``.grad`` (the reference's f32 accumulator of its micro-step
scan), are divided by ``micro_steps``, and are dropped after the update.
``make_prefill_step``, ``make_decode_step`` and ``make_step`` return
``(fn, in_shardings, out_shardings, abstract_args)`` as the reference's
factories do (``make_step`` for a train cell too); the shardings are
None without a mesh.

With a ``DeviceMesh`` the same step takes DTensors placed as
``in_shardings`` say (``NamedSharding``s of the reference's logical
specs; ``abstract_args`` are meta tensors) and runs SPMD on local
tensors, as the reference's ``shard_map`` regions do: each rank's batch
shard; every weight keeps its ``model`` shard and is gathered over
``data`` (FSDP) only, and the work it feeds splits over ``model`` as its
placement does (``_keeps``): attention heads, the MLP's ``d_ff``, the
vocabulary, mamba2's heads, the experts (which keep ``data`` too when
``_moe_shardmap`` gathers their ``ff`` shards in bf16 itself).  The
leaves whose work this slice does not split (``M.whole_leaves``) are
gathered whole and their work runs replicated over ``model``.  The
serving steps take the cache where it lies (no gather of it).  A
gradient is summed over the batch axes and cut back to its parameter's
placement (a reduce-scatter over ``data``), and AdamW runs on the shards
with the global norm summed over the ranks.  Micro-steps
keep the reference's micro-batches (global rows ``[i B/m, (i+1) B/m)``),
each split over the batch ranks as the reference's ``shard_map`` regions
take it (a rank's B/(m n) rows of every micro-batch: the moe capacity
counts the reference's tokens; the batch is gathered first), or, where
the ranks do not divide a micro-batch, cut at its bounds; each rank
weighs its rows of one by that micro-batch's global count of valid
labels, so the loss is the reference's.  On a mesh of one rank no
collective runs and the step is the unmeshed one, bit for bit.

``REPRO_CAST_PARAMS_ONCE=1`` casts the f32 matrices (leaves of 2 or
more dims) to the compute dtype once at the top of the step, as the
reference does; gradients reach the masters through the cast, and a
matrix used more than once (the unembed across CE chunks) then meets its
gradients in the compute dtype, as there.  The reference's
``REPRO_LOSS_UNEMBED_TP`` and ``REPRO_SHARDED_CE`` ask its partitioner
for the vocab-parallel loss that the port's meshed step always runs
(``layers`` says so); neither changes a result there, and the port does
not read them.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.mesh import axis_names, axis_size, coordinate
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (BATCH_AXES, NamedSharding,
                                       abstract_params, batch_sum,
                                       compute_dtype, contiguous_stride,
                                       gather_local, param_shardings,
                                       reduce_to, resolve_spec)
from repro_torch.train import adamw

EXPERTS = ("we_g", "we_u", "we_d")


def _shard(mesh, logical, shape) -> Optional[NamedSharding]:
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(logical, shape, mesh))


AUX_WEIGHT = 0.01


def loss_fn(cfg, params, batch, mesh=None, aux_weight=AUX_WEIGHT):
    """(loss + aux_weight * moe aux, {"loss", "aux"}).  A vlm batch with
    patches scores only the text positions (the patches are
    prepended)."""
    hidden, aux = M.forward(cfg, params, batch, mesh=mesh, return_hidden=True)
    if cfg.family == "vlm" and batch.get("patches") is not None:
        hidden = hidden[:, batch["patches"].shape[1]:]
    loss = L.chunked_cross_entropy(hidden, params["unembed"],
                                   batch["labels"],
                                   softcap=cfg.logit_softcap,
                                   mesh=L.vocab_mesh(cfg, mesh))
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


def cast_tree(params, dtype):
    """The f32 leaves of 2 or more dims cast to ``dtype`` (differentiably),
    the others as they are."""
    return T.tree_map(lambda x: x.to(dtype) if (
        x.dtype == torch.float32 and x.ndim >= 2) else x, params)


def _local(t):
    """The local tensor of a DTensor; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _batch_ranks(mesh) -> tuple:
    """(this rank's index over the batch axes, their count)."""
    idx, n = 0, 1
    for a in BATCH_AXES:
        if a in axis_names(mesh):
            idx = idx * axis_size(mesh, a) + coordinate(mesh, a)
            n *= axis_size(mesh, a)
    return idx, n


def _spread(batch_rows: int, micro_steps: int, mesh) -> bool:
    """Whether each micro-batch splits evenly over the batch ranks (the
    step then gathers the batch and each rank takes its share of every
    micro-batch)."""
    n = _batch_ranks(mesh)[1]
    return (micro_steps > 1 and n > 1
            and batch_rows % (micro_steps * n) == 0)


def _micro_pieces(rows: int, micro_steps: int, mesh, spread: bool = False):
    """This rank's rows of each of the reference's micro-batches (global
    rows ``[i B/m, (i+1) B/m)``): [(micro-batch, start, stop)] in its
    ``rows`` local rows, cut at the micro-batch bounds; with ``spread``
    ``rows`` is the whole batch and the rank takes its ``1/n`` of every
    micro-batch.  ``mesh`` None: the rows are the whole batch."""
    idx, n = _batch_ranks(mesh) if mesh is not None else (0, 1)
    B = rows if spread else rows * n
    if B % micro_steps:
        raise ValueError(f"batch {B} is not a multiple of {micro_steps} "
                         f"micro-steps")
    mb = B // micro_steps
    if spread:
        per = mb // n
        return [(i, i * mb + idx * per, i * mb + (idx + 1) * per)
                for i in range(micro_steps)], mb
    lo = idx * rows
    out = []
    for i in range(micro_steps):
        a, b = max(lo, i * mb), min(lo + rows, (i + 1) * mb)
        if a < b:
            out.append((i, a - lo, b - lo))
    return out, mb


def accumulate_grads(cfg, params, batch, *, micro_steps: int = 1,
                     cast_once: bool = False, mesh=None,
                     split: bool = False, spread: bool = False) -> dict:
    """Backward of ``loss_fn`` into ``params``' ``.grad`` over
    ``micro_steps`` micro-batches, the sums divided by ``micro_steps``;
    the metrics, averaged over the micro-steps.  ``params`` must require
    grad, with ``.grad`` None.  Under a ``mesh`` they are the rank's
    working copies; with ``split`` the batch is this rank's shard of the
    batch axes' rows, each rank weighs its rows of a micro-batch by that
    micro-batch's global count of valid labels, and the metrics are
    summed over the batch ranks, so the loss is the reference's.  With
    ``spread`` the batch is the whole (gathered) batch and the rank's
    rows are its share of every micro-batch (``_micro_pieces``)."""
    pieces, rows = _micro_pieces(batch["tokens"].shape[0], micro_steps,
                                 mesh if split else None, spread)
    whole = not split or _batch_ranks(mesh)[1] == 1   # pieces = micro-batches
    labels = batch["labels"]
    if not whole:
        # each micro-batch's count of valid labels over all batch ranks
        counts = torch.zeros(micro_steps, dtype=torch.float32,
                             device=labels.device)
        for i, a, b in pieces:
            counts[i] += (labels[a:b] != -1).sum()
        counts = batch_sum(counts, mesh)
    per = [{} for _ in range(micro_steps)]
    for i, a, b in pieces:
        part = {k: v[a:b] for k, v in batch.items()}
        p = cast_tree(params, compute_dtype(cfg)) if cast_once else params
        total, metrics = loss_fn(cfg, p, part, mesh=mesh)
        if not whole:           # this rank's share of micro-batch i
            metrics = {"loss": metrics["loss"] * (
                (labels[a:b] != -1).sum() / torch.clamp(counts[i], min=1.0)),
                "aux": metrics["aux"] * ((b - a) / rows)}
            total = metrics["loss"] + AUX_WEIGHT * metrics["aux"]
        total.backward()
        for k, v in metrics.items():
            v = v.detach()
            per[i][k] = per[i][k] + v if k in per[i] else v
    for leaf in T.leaves(params):
        if leaf.grad is None:     # unused here (vlm patch_proj, no patches)
            leaf.grad = torch.zeros_like(leaf)
        elif micro_steps > 1:
            leaf.grad.div_(micro_steps)
    if split:
        zero = torch.zeros((), device=labels.device)
        per = [{k: batch_sum(m.get(k, zero), mesh) for k in ("loss", "aux")}
               for m in per]
    if micro_steps == 1:
        return per[0]
    return {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}


def make_train_step(cfg: ModelConfig, shape: InputShape, mesh=None,
                    micro_steps: int = 1):
    """The step ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: params and opt_state are updated in place (and
    returned); metrics holds 0-d tensors ``loss``, ``aux``, ``lr`` and
    ``grad_norm``.  ``shape`` is the cell the step is made for, as in the
    reference (its batch must divide into ``micro_steps``).  With a
    ``mesh`` the step takes DTensors placed as ``make_step``'s
    ``in_shardings`` say; ``make_step`` returns the reference's
    ``(fn, in_shardings, out_shardings, abstract_args)``."""
    if shape.global_batch % micro_steps:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {micro_steps} micro-steps")
    cast_once = bool(os.environ.get("REPRO_CAST_PARAMS_ONCE"))
    keeps, split, sharded, spread = None, False, False, False
    if mesh is not None:
        keeps = _keeps(cfg, M.param_defs(cfg), mesh)
        # a batch that the batch axes don't divide is replicated (the
        # reference's resolve_spec): every rank then runs all of it
        split = bool(_batch_shardings(cfg, shape, mesh)["tokens"].spec)
        sharded = any(axis_size(mesh, a) > 1 for a in axis_names(mesh))
        spread = split and _spread(shape.global_batch, micro_steps, mesh)

    def train_step(params, opt_state, batch):
        work = _working(params, keeps)
        leaves = T.leaves(work)
        for leaf in leaves:
            leaf.requires_grad_(True)
            leaf.grad = None
        try:
            metrics = accumulate_grads(
                cfg, work, {k: gather_local(v) if spread else _local(v)
                            for k, v in batch.items()},
                micro_steps=micro_steps, cast_once=cast_once, mesh=mesh,
                split=split, spread=spread)
            grads = [leaf.grad for leaf in leaves]
            if keeps is not None:
                grads = [reduce_to(g, like, keep, partial=split)
                         for g, like, keep in zip(grads, T.leaves(params),
                                                  T.leaves(keeps))]
        finally:
            for leaf in leaves:
                leaf.grad = None
                leaf.requires_grad_(False)
        st = adamw.AdamWState(_local(opt_state.step),
                              T.tree_map(_local, opt_state.m),
                              T.tree_map(_local, opt_state.v))
        _, _, opt_metrics = adamw.update(
            T.unflatten(params, grads), st, T.tree_map(_local, params),
            norm_fn=(_mesh_norm(T.leaves(params)) if sharded
                     else adamw.global_norm))
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------- the mesh


def _batch_shardings(cfg, shape, mesh) -> dict:
    in_sds = M.input_specs(cfg, shape)
    in_logical = M.input_logical_specs(cfg, shape)
    return {k: _shard(mesh, in_logical[k], in_sds[k].shape) for k in in_sds}


def _keeps(cfg, defs, mesh) -> dict:
    """Each leaf's mesh axes whose shards the step's work uses as they are
    (the rest are gathered before it): ``model`` wherever the leaf's
    placement shards over it, but on the leaves whose work this slice
    does not split (``M.whole_leaves``: vlm's ``patch_proj``, the
    attention's where its heads do not divide the ranks); the experts'
    are ``expert_keep``'s."""
    ek = moe_lib.expert_keep(cfg, mesh)
    whole = M.whole_leaves(cfg, mesh)

    def keep(path, d):      # a frozenset: a leaf of the tree, not a node
        if isinstance(d, dict):
            return {k: keep(k, v) for k, v in d.items()}
        if path in EXPERTS:
            return frozenset(ek)
        placed = "model" in resolve_spec(d.logical, d.shape, mesh)
        return frozenset(("model",) if placed and path not in whole else ())
    return keep(None, defs)


def _working(params, keeps):
    """The local working copies of a DTensor params tree (``params``
    itself without a mesh)."""
    if keeps is None:
        return params
    return T.tree_map(lambda t, k: gather_local(t, k), params, keeps)


def _mesh_norm(likes):
    """The global norm of f32 gradient shards placed as ``likes``: each
    leaf's squares summed over the axes it is sharded on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def sq(g, like):
        s = g.square().sum()
        pl = [Partial() if p.is_shard() else Replicate()
              for p in like.placements]
        if not any(p.is_shard() for p in like.placements):
            return s
        return DTensor.from_local(s, like.device_mesh, pl,
                                  run_check=False).full_tensor()

    def norm(g_leaves):
        return torch.sqrt(sum(sq(g, like) for g, like in zip(g_leaves, likes)))
    return norm


def _train_shardings(cfg, shape, mesh) -> tuple:
    """(in_shardings, out_shardings, abstract_args) of the train step."""
    defs = M.param_defs(cfg)
    abs_params = abstract_params(defs)
    abstract_args = (abs_params, adamw.abstract_state(abs_params),
                     M.input_specs(cfg, shape))
    if mesh is None:
        return None, None, abstract_args
    p_sh = param_shardings(defs, mesh)
    opt_sh = adamw.AdamWState(_shard(mesh, (), ()), p_sh, p_sh)
    return ((p_sh, opt_sh, _batch_shardings(cfg, shape, mesh)),
            (p_sh, opt_sh, None), abstract_args)


def _cache_shardings(mesh, cache_abs, cache_logical):
    if mesh is None:
        return None
    return tuple(_shard(mesh, lg, a.shape)
                 for a, lg in zip(cache_abs, cache_logical))


def _serve_setup(cfg, shape, mesh, cache_len: int):
    defs = M.serve_param_defs(cfg)
    tp = axis_size(mesh, "model") if mesh is not None else 1
    cache_abs = M.init_cache_abstract(cfg, shape.global_batch, cache_len)
    cache_sh = _cache_shardings(mesh, cache_abs,
                                M.cache_logical_spec(cfg, tp))
    return defs, abstract_params(defs), param_shardings(defs, mesh), \
        cache_abs, cache_sh


def _placed(local: torch.Tensor, sh: NamedSharding, shape: tuple):
    """This rank's part of a tensor as the DTensor ``sh`` places."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), sh.mesh, sh.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def make_prefill_step(cfg: ModelConfig, shape: InputShape, mesh=None):
    cache_len = shape.seq_len
    if cfg.family == "vlm":
        cache_len += cfg.n_patches
    defs, abs_params, p_sh, cache_abs, cache_sh = _serve_setup(
        cfg, shape, mesh, cache_len)
    batch_sh = (_batch_shardings(cfg, shape, mesh) if mesh is not None
                else None)
    in_sds = M.input_specs(cfg, shape)
    if mesh is None:
        def prefill_step(params, batch):
            return M.prefill(cfg, params, batch, cache_len)
    else:
        keeps = _keeps(cfg, defs, mesh)
        logit_sh = _shard(mesh, ("batch", None, None),
                          (shape.global_batch, 1, cfg.vocab_size))

        def prefill_step(params, batch):
            work = _working(params, keeps)
            local = {k: v.to_local() for k, v in batch.items()}
            logits, cache = M.prefill(cfg, work, local, cache_len, mesh=mesh)
            return (_placed(logits, logit_sh,
                            (shape.global_batch, 1, cfg.vocab_size)),
                    tuple(_placed(c, sh, a.shape)
                          for c, sh, a in zip(cache, cache_sh, cache_abs)))
    in_shardings = (p_sh, batch_sh)
    out_shardings = (None, cache_sh)
    return prefill_step, in_shardings, out_shardings, (abs_params, in_sds)


def make_decode_step(cfg: ModelConfig, shape: InputShape, mesh=None):
    defs, abs_params, p_sh, cache_abs, cache_sh = _serve_setup(
        cfg, shape, mesh, shape.seq_len)
    in_sds = M.input_specs(cfg, shape)
    tok_sh = _shard(mesh, ("batch",), in_sds["tokens"].shape)
    pos_sh = _shard(mesh, ("batch",), in_sds["pos"].shape)
    if mesh is None:
        def decode_step(params, cache, tokens, pos):
            return M.decode_step(cfg, params, cache, tokens, pos)
    else:
        keeps = _keeps(cfg, defs, mesh)
        kv = tfm.kv_layout(cfg, mesh, shape.seq_len)
        logit_sh = _shard(mesh, ("batch", None),
                          (shape.global_batch, cfg.vocab_size))

        def decode_step(params, cache, tokens, pos):
            work = _working(params, keeps)
            # the cache where it lies, written in place
            logits, _ = M.decode_step(
                cfg, work, tuple(c.to_local() for c in cache),
                tokens.to_local(), pos.to_local(), mesh=mesh, kv=kv)
            return (_placed(logits, logit_sh,
                            (shape.global_batch, cfg.vocab_size)), cache)
    in_shardings = (p_sh, cache_sh, tok_sh, pos_sh)
    out_shardings = (None, cache_sh)
    abstract_args = (abs_params, cache_abs, in_sds["tokens"], in_sds["pos"])
    return decode_step, in_shardings, out_shardings, abstract_args


def make_step(cfg, shape, mesh=None, micro_steps: int = 1):
    """``(fn, in_shardings, out_shardings, abstract_args)`` of the cell's
    kind (the shardings None without a mesh)."""
    if shape.kind == "train":
        return (make_train_step(cfg, shape, mesh, micro_steps=micro_steps),
                *_train_shardings(cfg, shape, mesh))
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh)
    return make_decode_step(cfg, shape, mesh)
