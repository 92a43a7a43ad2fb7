"""qwen3-moe-30b-a3b — MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per the assignment table (per-expert hidden)
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    expert_d_ff=768,
    shared_expert=False,
)
