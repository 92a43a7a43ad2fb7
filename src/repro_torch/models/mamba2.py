"""Mamba-2 (SSD, state-space duality) mixer and LM, on torch.

Port of ``repro/models/mamba2.py``.  Prefill runs the chunked SSD
algorithm (quadratic within Q-token chunks, a linear recurrence across
chunks, which the reference's ``lax.scan`` and a Python loop here both
walk in order); decode is the O(1) recurrent update.  Projections follow
mamba2: in_proj -> (z, x, B, C, dt), a depthwise causal conv over (x, B,
C), a gated RMSNorm before out_proj.  None of it is a Pallas kernel in
the reference (plain jnp einsums), so plain torch is its counterpart.

The cache is O(1) in the sequence: each layer's conv tails ``(B, C,
W-1)`` in the compute dtype and its SSM state ``(B, nh, hp, N)`` in f32.
``prefill`` allocates it once and ``decode_step`` writes it in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import (ParamDef, compute_dtype, layer,
                                       zeros_of)

CHUNK = 256
F32 = torch.float32


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim


def mixer_param_defs(cfg: ModelConfig, Lx, st):
    d = cfg.d_model
    d_in, nh, g, N, hp = dims(cfg)
    w = cfg.ssm_conv
    return {
        "norm": ParamDef(Lx + (d,), st + (None,), init="zeros"),
        "in_zx": ParamDef(Lx + (d, 2 * d_in), st + ("fsdp", "tp")),
        "in_bc": ParamDef(Lx + (d, 2 * g * N), st + ("fsdp", None)),
        "in_dt": ParamDef(Lx + (d, nh), st + ("fsdp", "tp")),
        "conv_x": ParamDef(Lx + (d_in, w), st + ("tp", None), scale=0.5),
        "conv_bc": ParamDef(Lx + (2 * g * N, w), st + (None, None), scale=0.5),
        "dt_bias": ParamDef(Lx + (nh,), st + (None,), init="zeros"),
        "A_log": ParamDef(Lx + (nh,), st + (None,), init="zeros"),
        "Dskip": ParamDef(Lx + (nh,), st + (None,), init="ones"),
        "gnorm": ParamDef(Lx + (d_in,), st + ("tp",), init="zeros"),
        "out_proj": ParamDef(Lx + (d_in, d), st + ("tp", "fsdp")),
    }


def param_defs(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": ParamDef((cfg.vocab_size, d), ("tp", "fsdp")),
        "blocks": mixer_param_defs(cfg, (cfg.n_layers,), (None,)),
        "final_norm": ParamDef((d,), (None,), init="zeros"),
        "unembed": ParamDef((d, cfg.vocab_size), ("fsdp", "tp")),
    }


# ------------------------------------------------------------- conv


def causal_depthwise_conv(x, w, state=None):
    """x: (B, S, C), w: (C, W).  Returns (y, new_state (B, C, W-1)).  The W
    taps are summed in f32 and rounded once to x's dtype."""
    B, S, C = x.shape
    W = w.shape[1]
    xt = x.transpose(1, 2)  # (B, C, S)
    if state is None:
        pad = torch.zeros((B, C, W - 1), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, xt], dim=-1)  # (B, C, S+W-1)
    wf = w.to(x.dtype).float()
    y = full[:, :, 0:S].float() * wf[:, 0, None]
    for j in range(1, W):
        y = y + full[:, :, j:j + S].float() * wf[:, j, None]
    y = y.to(x.dtype).transpose(1, 2)  # (B, S, C)
    new_state = (full[:, :, S:] if W > 1 else
                 torch.zeros((B, C, 0), dtype=x.dtype, device=x.device))
    return y, new_state


# ------------------------------------------------------------- SSD core


def _segsum(cs):
    """cs: (..., Q) cumulative sums -> (..., Q, Q) with [i,j]=cs[i]-cs[j],
    -inf above the diagonal."""
    Q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    ar = torch.arange(Q, device=cs.device)
    mask = ar[:, None] >= ar[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, init_state=None, chunk=CHUNK):
    """Chunked SSD scan.

    x: (B, S, nh, hp); dt: (B, S, nh); A: (nh,) (negative);
    Bm/Cm: (B, S, nh, N) (already group-expanded).
    Returns (y (B, S, nh, hp), final_state (B, nh, hp, N) f32).
    """
    Bb, S, nh, hp = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    xr = x.reshape(Bb, nc, Q, nh, hp).float()
    dtr = dt.reshape(Bb, nc, Q, nh).float()
    Br = Bm.reshape(Bb, nc, Q, nh, N).float()
    Cr = Cm.reshape(Bb, nc, Q, nh, N).float()
    dA = dtr * A.float()  # (B, nc, Q, nh)
    cs = torch.cumsum(dA, dim=2)
    Lmat = torch.exp(_segsum(cs.transpose(2, 3)))  # (B, nc, nh, Q, Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br)
    xdt = xr * dtr[..., None]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", CB * Lmat, xdt)
    del CB, Lmat
    # per-chunk new state contribution
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B, nc, Q, nh)
    S_c = torch.einsum("bcqhn,bcqhp->bchpn",
                       Br * (decay_to_end * dtr)[..., None], xr)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B, nc, nh)

    state = (torch.zeros((Bb, nh, hp, N), dtype=F32, device=x.device)
             if init_state is None else init_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    states_in = torch.stack(states_in, 1)  # (B, nc, nh, hp, N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cr * torch.exp(cs)[..., None], states_in)
    y = (y_intra + y_inter).reshape(Bb, S, nh, hp)
    return y.to(x.dtype), state


def ssd_decode(x, dt, A, Bm, Cm, state):
    """Single-token recurrence.  x: (B, nh, hp); dt: (B, nh);
    Bm/Cm: (B, nh, N); state: (B, nh, hp, N) f32."""
    dA = torch.exp(dt.float() * A.float())  # (B, nh)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt.float(), x.float(), Bm.float())
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Cm.float())
    return y.to(x.dtype), state


# ------------------------------------------------------------- mixer


def _project(cfg, p, h):
    dt0 = h.dtype
    zx = h @ p["in_zx"].to(dt0)
    z, xs = zx.chunk(2, dim=-1)
    bc = h @ p["in_bc"].to(dt0)
    dtv = h @ p["in_dt"].to(dt0)
    return z, xs, bc, dtv


def _expand_groups(bc, cfg):
    d_in, nh, g, N, hp = dims(cfg)
    B, S = bc.shape[:2]
    Bm, Cm = bc.chunk(2, dim=-1)
    rep = nh // g
    Bm = Bm.reshape(B, S, g, N).repeat_interleave(rep, dim=2)
    Cm = Cm.reshape(B, S, g, N).repeat_interleave(rep, dim=2)
    return Bm, Cm


def mixer(cfg, p, x, *, mode, cache=None):
    """x: (B, S, d).  cache = (conv_x_state, conv_bc_state, ssm_state), the
    layer's views, written in place at decode.  Returns (x + out, the new
    cache at prefill, the cache at decode, None in training mode)."""
    d_in, nh, g, N, hp = dims(cfg)
    dt0 = x.dtype
    B, S, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xs, bc, dtv = _project(cfg, p, h)
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dtv.float() + p["dt_bias"].float())

    if mode == "decode":
        conv_x_st, conv_bc_st, ssm_st = cache
        xs_c, cx = causal_depthwise_conv(xs, p["conv_x"], conv_x_st)
        bc_c, cbc = causal_depthwise_conv(bc, p["conv_bc"], conv_bc_st)
        xs_c, bc_c = F.silu(xs_c), F.silu(bc_c)
        Bm, Cm = _expand_groups(bc_c, cfg)
        y, st = ssd_decode(xs_c[:, 0].reshape(B, nh, hp), dt[:, 0], A,
                           Bm[:, 0], Cm[:, 0], ssm_st)
        conv_x_st.copy_(cx)
        conv_bc_st.copy_(cbc)
        ssm_st.copy_(st)
        y = y.reshape(B, 1, nh, hp)
        xs_res = xs_c.reshape(B, 1, nh, hp)
        new_cache = cache
    else:
        xs_c, conv_x_st = causal_depthwise_conv(xs, p["conv_x"])
        bc_c, conv_bc_st = causal_depthwise_conv(bc, p["conv_bc"])
        xs_c, bc_c = F.silu(xs_c), F.silu(bc_c)
        Bm, Cm = _expand_groups(bc_c, cfg)
        y, ssm_st = ssd_chunked(xs_c.reshape(B, S, nh, hp), dt, A, Bm, Cm)
        xs_res = xs_c.reshape(B, S, nh, hp)
        new_cache = ((conv_x_st, conv_bc_st, ssm_st) if mode == "prefill"
                     else None)

    y = y + xs_res * p["Dskip"].to(dt0)[None, None, :, None]
    y = y.reshape(B, -1, d_in)
    y = L.rms_norm(y * F.silu(z.float()).to(dt0), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt0)
    return x + out, new_cache


# ------------------------------------------------------------- full LM


def embed(cfg, params, tokens):
    return L.embed(params, tokens, compute_dtype(cfg))


def _train_mixer(cfg, p, x):
    return mixer(cfg, p, x, mode="train")[0]


def forward(cfg, params, tokens, *, remat=True, return_hidden=False):
    """-> (logits (B, S, V) f32, or the final normed hidden with
    ``return_hidden``; aux 0).  ``remat`` recomputes each layer in the
    backward."""
    x = embed(cfg, params, tokens)
    for l in range(cfg.n_layers):
        x = L.remat(remat, _train_mixer, cfg, layer(params["blocks"], l), x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params, x), aux


def init_cache_abstract(cfg, batch: int, cache_len: int):
    """The SSM 'cache' is O(1): conv tails and state, whatever
    ``cache_len`` is.  Meta tensors (shape and dtype, no storage)."""
    d_in, nh, g, N, hp = dims(cfg)
    w = cfg.ssm_conv
    dt0 = compute_dtype(cfg)
    Lr = cfg.n_layers
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return (meta((Lr, batch, d_in, w - 1), dt0),
            meta((Lr, batch, 2 * g * N, w - 1), dt0),
            meta((Lr, batch, nh, hp, N), F32))



def cache_logical_spec(cfg, tp_size: int):
    return (
        (None, "batch", "tp", None),
        (None, "batch", None, None),
        (None, "batch", "tp", None, None),
    )

def prefill(cfg, params, tokens, cache_len: int):
    """-> (last-token logits (B, 1, V) f32, cache (conv_x, conv_bc, ssm),
    each stacked over layers)."""
    x = embed(cfg, params, tokens)
    cache = zeros_of(init_cache_abstract(cfg, tokens.shape[0], cache_len),
                     x.device)
    for l in range(cfg.n_layers):
        x, c = mixer(cfg, layer(params["blocks"], l), x, mode="prefill")
        for dst, src in zip(cache, c):
            dst[l] = src
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x), cache


def decode_step(cfg, params, cache, tokens, pos):
    """One step; the cache is updated in place.  -> (logits (B, V) f32,
    cache)."""
    x = embed(cfg, params, tokens[:, None])
    for l in range(cfg.n_layers):
        x, _ = mixer(cfg, layer(params["blocks"], l), x, mode="decode",
                     cache=tuple(c[l] for c in cache))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params, x[:, 0]), cache
