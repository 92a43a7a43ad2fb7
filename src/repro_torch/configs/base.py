"""Config system: model configs, input shapes, and the arch registry.

Every assigned architecture gets one file in this package exporting
``CONFIG``.  ``registry.get_config(arch_id)`` resolves them.  Shapes are
global (paper brief): each LM arch is paired with the four LM shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  Only fields a family uses are read."""

    name: str
    family: str  # dense | ssm | moe | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    logit_softcap: float = 0.0  # final logits soft-capping (gemma2: 30)
    attn_softcap: float = 0.0  # attention-score soft-capping (gemma2: 50)
    local_window: int = 0  # sliding-window size for local layers
    local_global_pattern: bool = False  # gemma2: alternate local/global
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0  # per-expert hidden size (qwen3-moe: 768)
    shared_expert: bool = False  # llama4: one always-on shared expert
    capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block applied every k mamba blocks
    attn_every: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame-embedding length (conv frontend stub)

    # VLM (pixtral): number of stubbed patch-embedding tokens at prefill
    n_patches: int = 0

    # training
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master params

    def kv_dim(self) -> int:
        return self.n_kv_heads * self.the_head_dim()

    def the_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k?  Pure SSM / hybrid only (brief)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for 6ND model flops) ----
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.the_head_dim()
        n = 0
        # embeddings (+ untied unembed)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per_layer_mlp = 3 * d * self.d_ff if self.d_ff else 0
        if self.family == "ssm":
            n += self.n_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            n_attn_uses = self.n_layers // max(self.attn_every, 1)
            n += self.n_layers * self._ssm_layer_params()
            # one SHARED attention block (weights tied across uses)
            n += per_layer_attn + per_layer_mlp
            del n_attn_uses
        elif self.family in ("moe",):
            e = self.moe_top_k if active_only else self.n_experts
            per_moe = 3 * d * self.expert_d_ff * e
            if self.shared_expert:
                per_moe += 3 * d * self.d_ff
            n += self.n_layers * (per_layer_attn + per_moe + d * self.n_experts)
        elif self.family == "encdec":
            n += (self.n_enc_layers + self.n_layers) * (per_layer_attn + per_layer_mlp)
            n += self.n_layers * per_layer_attn  # cross-attention
        else:  # dense / vlm
            n += self.n_layers * (per_layer_attn + per_layer_mlp)
        return n

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        g, s = self.ssm_groups, self.ssm_state
        n = d * (2 * d_in + 2 * g * s + nh)  # in_proj (z, x, B, C, dt)
        n += d_in * self.ssm_conv  # depthwise conv
        n += nh * 2  # A_log, D
        n += d_in * d  # out_proj
        if self.d_ff:
            n += 3 * d * self.d_ff
        return n


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the brief's skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "full-attention arch: 500k ctx needs sub-quadratic mixing (skip per brief)"
    return True, ""
