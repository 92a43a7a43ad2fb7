"""Family dispatcher, on torch.

Port of ``repro/models/model.py``'s dispatch (``param_defs``,
``forward``, ``prefill``, ``decode_step``, ``init_cache_abstract``) for
all six families, ``input_specs`` (meta-device tensors in place of the
reference's ``ShapeDtypeStruct``s), the logical specs of the inputs
and caches (``input_logical_specs``, ``cache_logical_spec``),
``serve_param_defs`` and ``model_flops``.  As in the reference, an
``encdec`` batch must carry ``"frames"`` (a ``KeyError`` otherwise) and a
``vlm`` batch may carry ``"patches"``.  ``mesh`` reaches every family:
each splits its work over ``model`` as its weights' placements do, and
takes its cache as placed (``whole_leaves`` names the placed leaves whose
work does not split and that a meshed step gathers whole).

``stored_dtype`` says how a serving copy keeps each parameter: the
matrices that every product casts to the compute dtype
(``.astype(cfg.dtype)`` in the reference) are stored in it once, which
gives the same numbers (rounding once equals rounding at each use); the
embedding table, the router, ``A_log``, ``dt_bias`` and the norm scales
stay f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import encdec, hybrid, mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.params import ParamDef, compute_dtype

_FAMS = {
    "dense": tfm, "moe": tfm, "vlm": tfm,
    "ssm": mamba2, "hybrid": hybrid, "encdec": encdec,
}
# the matrices that the reference casts to the compute dtype before every
# product: transformer.py (_attn_block, _mlp_block, embed_tokens and the
# unembed), moe.py (_moe_dense), mamba2.py (_project, the conv, Dskip,
# out_proj) and encdec.py (_mha, _mlp, the cross K/V)
MATMUL_WEIGHTS = frozenset((
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "unembed",
    "we_g", "we_u", "we_d", "se_wg", "se_wu", "se_wd",
    "patch_proj",
    "in_zx", "in_bc", "in_dt", "out_proj", "conv_x", "conv_bc", "Dskip",
    "w1", "w2", "x_wq", "x_wk", "x_wv", "x_wo"))


def family_module(cfg: ModelConfig):
    return _FAMS[cfg.family]


def stored_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype a serving copy keeps parameter ``name`` in."""
    return compute_dtype(cfg) if name in MATMUL_WEIGHTS else torch.float32


def param_defs(cfg: ModelConfig):
    return family_module(cfg).param_defs(cfg)


def serve_param_defs(cfg: ModelConfig):
    """Serving stores bf16 weights, TP-sharded only (no per-token FSDP
    gathers at decode)."""
    def conv(d):
        if isinstance(d, dict):
            return {k: conv(v) for k, v in d.items()}
        logical = tuple(None if ax == "fsdp" else ax for ax in d.logical)
        return ParamDef(d.shape, logical, d.init, d.scale, torch.bfloat16)
    return conv(param_defs(cfg))


def whole_leaves(cfg, mesh) -> frozenset:
    # mamba2 splits every leaf placed over model (``mamba2.ssm_tp``)
    fn = getattr(family_module(cfg), "whole_leaves", None)
    return fn(cfg, mesh) if fn else frozenset()


def _inputs(cfg, batch: dict, mesh) -> dict:
    kw = {"mesh": mesh} if mesh is not None else {}
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch.get("patches")
    return kw


def forward(cfg, params, batch: dict, *, mesh=None, remat=True,
            return_hidden=False):
    """-> (logits (B, S, V) f32, or the final normed hidden with
    ``return_hidden``; moe aux loss)."""
    return family_module(cfg).forward(cfg, params, batch["tokens"],
                                      remat=remat,
                                      return_hidden=return_hidden,
                                      **_inputs(cfg, batch, mesh))


def prefill(cfg, params, batch: dict, cache_len: int, *, mesh=None):
    """-> (last-token logits (B, 1, V) f32, the family's cache)."""
    return family_module(cfg).prefill(cfg, params, batch["tokens"],
                                      cache_len, **_inputs(cfg, batch, mesh))


def decode_step(cfg, params, cache, tokens, pos, *, mesh=None, kv: str = ""):
    """-> (logits (B, V) f32, the cache, updated in place).  Under a mesh
    the cache is this rank's part, its kv cache placed as ``kv`` says
    (``transformer.kv_layout``)."""
    kw = {}
    if mesh is not None:
        kw["mesh"] = mesh
        if cfg.family != "ssm":
            kw["kv"] = kv
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos,
                                          **kw)


def init_cache_abstract(cfg, batch: int, cache_len: int):
    return family_module(cfg).init_cache_abstract(cfg, batch, cache_len)


def cache_logical_spec(cfg, tp_size: int):
    return family_module(cfg).cache_logical_spec(cfg, tp_size)


# --------------------------------------------------------------- inputs


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The model inputs of one cell as meta tensors (shape and dtype, no
    storage).  Keys depend on ``shape.kind``."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    i32, f32 = torch.int32, torch.float32
    out = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = meta((B, S), i32)
        if shape.kind == "train":
            out["labels"] = meta((B, S), i32)
        if cfg.family == "encdec":
            out["frames"] = meta((B, cfg.enc_seq, cfg.d_model), f32)
        if cfg.family == "vlm":
            out["patches"] = meta((B, cfg.n_patches, cfg.d_model), f32)
    else:  # decode: one new token against a cache of length S
        out["tokens"] = meta((B,), i32)
        out["pos"] = meta((B,), i32)
    return out


def input_logical_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Logical partition specs matching input_specs."""
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ("batch", None)}
        if shape.kind == "train":
            out["labels"] = ("batch", None)
        if cfg.family == "encdec":
            out["frames"] = ("batch", None, None)
        if cfg.family == "vlm":
            out["patches"] = ("batch", None, None)
        return out
    return {"tokens": ("batch",), "pos": ("batch",)}


# --------------------------------------------------------------- flops


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = batch
    tokens (one step).  Training counts fwd+bwd (x3 of 2ND)."""
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
