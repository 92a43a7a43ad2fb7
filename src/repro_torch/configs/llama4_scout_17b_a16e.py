"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # shared-expert / dense d_ff
    vocab_size=202_048,
    rope_theta=500_000.0,
    n_experts=16,
    moe_top_k=1,
    expert_d_ff=8192,
    shared_expert=True,
)
