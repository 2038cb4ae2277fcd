"""whisper-medium: enc-dec audio transformer backbone (conv frontend STUB).

[arXiv:2212.04356; unverified] 24L d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865.  The audio conv frontend is stubbed: ``input_specs`` provides
precomputed frame embeddings of length ``encoder_len``.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    d_ff=4096,
    vocab=51865,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64),
    encoder_layers=24,
    encoder_len=1500,
    gated_mlp=False,          # whisper uses plain GELU MLP
    tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2212.04356",
)
