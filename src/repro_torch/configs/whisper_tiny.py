"""whisper-tiny — encoder-decoder audio backbone; conv frontend stubbed. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    enc_seq=1500,  # precomputed log-mel frame embeddings (stub per brief)
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
)
