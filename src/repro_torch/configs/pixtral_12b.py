"""pixtral-12b — VLM: pixtral-ViT frontend (stubbed) + mistral-nemo backbone. [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    n_patches=256,  # stubbed patch-embedding tokens prepended at train/prefill
)
