"""gemma3-27b: 5:1 local:global attention, 128k context class.

[hf:google/gemma-3-1b-pt; unverified] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, window 1024, period 6 (5 local : 1 global), QK-norm.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3_27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab=262144,
    attn=AttnConfig(n_heads=32, n_kv_heads=16, head_dim=128, window=1024,
                    local_global_period=6, qk_norm=True,
                    rope_theta=1_000_000.0),
    tie_embeddings=True,
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt (scaled)",
)
