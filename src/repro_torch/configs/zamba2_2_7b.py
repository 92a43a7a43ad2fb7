"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,  # shared-block MLP
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    attn_every=6,  # one SHARED attn+MLP block applied every 6 mamba blocks
)
