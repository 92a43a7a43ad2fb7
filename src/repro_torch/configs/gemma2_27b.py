"""gemma2-27b — dense, local/global alternating attention, logit softcap. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,  # gemma2 uses explicit head_dim (32*128 != d_model)
    d_ff=36_864,
    vocab_size=256_000,
    rope_theta=10_000.0,
    local_global_pattern=True,
    local_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
)
