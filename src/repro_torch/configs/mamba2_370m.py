"""mamba2-370m — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # mamba2 has no separate MLP
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
)
