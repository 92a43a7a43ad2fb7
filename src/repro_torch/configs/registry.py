"""Arch registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig, shape_applicable

ARCH_IDS = [
    "mamba2-370m",
    "phi3-mini-3.8b",
    "gemma2-27b",
    "codeqwen1.5-7b",
    "qwen3-8b",
    "llama4-scout-17b-a16e",
    "qwen3-moe-30b-a3b",
    "whisper-tiny",
    "zamba2-2.7b",
    "pixtral-12b",
]

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma2-27b": "gemma2_27b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-8b": "qwen3_8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-2.7b": "zamba2_2_7b",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(shape_id: str) -> InputShape:
    return SHAPES[shape_id]


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config: small width/depth, tiny vocab — runs a
    real forward/train step on one CPU device."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=2,
        d_model=64,
        vocab_size=256,
        norm_eps=cfg.norm_eps,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2, head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.family in ("moe",):
        kw.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2), expert_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, n_layers=4)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=16)
    if cfg.family == "vlm":
        kw.update(n_patches=4)
    if cfg.local_global_pattern:
        kw.update(local_window=32)
    return cfg.replace(**kw)


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
            ok, why = shape_applicable(cfg, SHAPES[s])
            out.append((a, s, ok, why))
    return out
