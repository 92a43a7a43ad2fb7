"""qwen3-8b — dense, qk-norm, GQA(kv=8). [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    qk_norm=True,
)
