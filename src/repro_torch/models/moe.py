"""Mixture-of-Experts FFN, on torch.

Port of ``repro/models/moe.py``'s two paths: top-k routing with
softmax-renormalised gates, capacity-factor token dropping (order of
arrival within each expert), a one-buffer dispatch, the three expert
products and the gated combine; each returns ``(y, aux_loss)`` with the
Switch/GShard load-balance loss.

* ``_moe_shardmap`` — a mesh with a ``model`` axis of more than one rank
  that divides the experts: expert parallel.  Tokens are replicated over
  ``model``; each rank holds ``E/ep`` experts, selects its own tokens
  (stable sort, rank within the expert below the capacity), all-gathers
  its experts' ``ff`` shards over ``data`` in the compute dtype when they
  are FSDP-sharded, and one ``all_reduce(SUM)`` over ``model`` combines
  the outputs (the reference's ``psum``).  Only ``all_reduce``,
  ``all_gather`` and their reduce-scatter transpose, so it runs on gloo.
* ``_moe_dense`` — no mesh, or one the experts don't divide.

Three choices keep the numbers the reference's:

* ``lax.top_k`` puts the lower expert first on equal probabilities; a
  stable descending sort does the same (``torch.topk`` on the card does
  not promise it).
* The dispatch buffer is written by ``index_copy_``: every kept
  assignment has a slot of its own, and the dropped ones all land in the
  dump row, which is cut off.
* A token's k weighted expert outputs are summed over a ``(T, k, d)``
  view, in one fixed order, not by an accumulating scatter.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import axis_names, axis_size, coordinate
from repro_torch.models.params import (ParamDef, gather_data, reduce_model,
                                       to_model)


def moe_param_defs(cfg, Lx, st):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    return {
        "router": ParamDef(Lx + (d, E), st + (None, None)),
        "we_g": ParamDef(Lx + (E, d, f), st + ("tp", None, "fsdp")),
        "we_u": ParamDef(Lx + (E, d, f), st + ("tp", None, "fsdp")),
        "we_d": ParamDef(Lx + (E, f, d), st + ("tp", "fsdp", None)),
    }


def _route(cfg, xf, router):
    """xf: (T, d) -> (top_p, top_i) each (T, k) and aux load-balance loss.
    The router product is f32 (TF32 off, as torch's default is)."""
    logits = xf.float() @ router.float()
    probs = F.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux: E * sum_e mean(frac_e) * mean(prob_e)
    E = cfg.n_experts
    counts = _counts(top_i.reshape(-1), E).float()
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    aux = E * torch.sum(frac * probs.mean(0))
    return top_p, top_i, aux


def _capacity(cfg, n_tokens: int, ep: int = 1) -> int:
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, 4)


def _expert_mm(buf, wg, wu, wd, dt):
    """buf: (E, C, d); weights (E, d, f) / (E, f, d)."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd).to(dt)


def _counts(fe, E: int):
    """Assignments per expert.  (``torch.bincount`` reads its input's
    maximum back to the host on the card; a scatter-add does not.)"""
    return torch.zeros(E, dtype=torch.int64, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))


def _ranks(fe, E: int):
    """Each assignment's rank among those of its expert, in order of
    arrival (the reference's cumsum over a one-hot), by a stable sort."""
    order = torch.argsort(fe, stable=True)
    counts = _counts(fe, E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(fe)
    rank[order] = torch.arange(fe.numel(), device=fe.device) - first[fe[order]]
    return rank


def _moe_dense(cfg, p, x):
    dt = x.dtype
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    top_p, top_i, aux = _route(cfg, xf, p["router"])
    k, E = cfg.moe_top_k, cfg.n_experts
    C = _capacity(cfg, T)
    fe = top_i.reshape(-1)  # (T*k,)
    fp = top_p.reshape(-1)
    ft = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    rank = _ranks(fe, E)
    keep = rank < C
    slot = torch.where(keep, fe * C + rank, E * C)  # E*C = dump row
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device)
    buf.index_copy_(0, slot, xf[ft])
    out = _expert_mm(buf[:-1].view(E, C, d), p["we_g"].to(dt),
                     p["we_u"].to(dt), p["we_d"].to(dt), dt)
    flat = torch.cat([out.reshape(E * C, d),
                      torch.zeros((1, d), dtype=dt, device=x.device)])
    contrib = flat[slot] * (fp * keep)[:, None].to(dt)
    y = contrib.view(T, k, d).sum(1)
    return y.reshape(B, S, d), aux


# --------------------------------------------------------- shard_map path


def _shard_f(cfg, mesh) -> bool:
    """Whether the experts' ff dim is FSDP-sharded over ``data``."""
    return ("data" in axis_names(mesh)
            and cfg.expert_d_ff % axis_size(mesh, "data") == 0)


def expert_keep(cfg, mesh) -> tuple:
    """The mesh axes whose shards of the expert weights ``_moe_shardmap``
    takes as they are (the rest are gathered before the step): ``model``
    (expert parallel) and ``data`` when it gathers the ff shards itself."""
    if not use_shardmap(cfg, mesh):
        return ()
    return ("model", "data") if _shard_f(cfg, mesh) else ("model",)


def _moe_shardmap(cfg, p, x, mesh):
    """x: (B_loc, S, d), this rank's batch shard, the same on every
    ``model`` rank; p's experts: this rank's (E/ep, d, f[/fsdp])."""
    dt = x.dtype
    ep = axis_size(mesh, "model")
    E = cfg.n_experts
    assert E % ep == 0, f"experts {E} not divisible by EP size {ep}"
    E_loc = E // ep
    B_loc, S, d = x.shape
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    top_p, top_i, aux = _route(cfg, xf, p["router"])
    k = cfg.moe_top_k
    C = _capacity(cfg, T, ep)
    my = coordinate(mesh, "model")
    fe = top_i.reshape(-1)
    ft = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    order = torch.argsort(fe, stable=True)
    se, stk = fe[order], ft[order]
    sp = to_model(top_p, mesh).reshape(-1)[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(T * k, device=x.device) - first
    keep = rank < C
    rel = se - my * E_loc
    mine = (rel >= 0) & (rel < E_loc) & keep
    slot = torch.where(mine, rel * C + rank, E_loc * C)
    buf = torch.zeros((E_loc * C + 1, d), dtype=dt, device=x.device)
    buf = buf.index_copy(0, slot, to_model(xf, mesh)[stk]
                         * mine[:, None].to(dt))
    wg, wu, wd = (p[n].to(dt) for n in ("we_g", "we_u", "we_d"))
    if _shard_f(cfg, mesh):     # FSDP: gather the ff shards (compute dtype)
        wg, wu = gather_data(wg, 2, mesh), gather_data(wu, 2, mesh)
        wd = gather_data(wd, 1, mesh)
    out = _expert_mm(buf[:-1].view(E_loc, C, d), wg, wu, wd, dt)
    flat = torch.cat([out.reshape(E_loc * C, d),
                      torch.zeros((1, d), dtype=dt, device=x.device)])
    contrib = flat[slot] * (sp * mine)[:, None].to(dt)
    # back to arrival order, each token's k contributions summed in one
    # fixed order (as the dense path does)
    y = torch.empty_like(contrib).index_copy(0, order, contrib)
    y = reduce_model(y.view(T, k, d).sum(1), mesh)
    return y.reshape(B_loc, S, d), aux


def use_shardmap(cfg, mesh) -> bool:
    """The reference's condition (moe.py:168-173)."""
    return (mesh is not None
            and "model" in axis_names(mesh)
            and axis_size(mesh, "model") > 1
            and cfg.n_experts % axis_size(mesh, "model") == 0)


def moe_ffn(cfg, p, x, mesh=None):
    """x: (B, S, d) -> (y, aux_loss)."""
    if use_shardmap(cfg, mesh):
        return _moe_shardmap(cfg, p, x, mesh)
    return _moe_dense(cfg, p, x)
