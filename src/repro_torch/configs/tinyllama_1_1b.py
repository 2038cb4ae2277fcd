"""tinyllama-1.1b: llama2-architecture small dense LM.

[arXiv:2401.02385; hf] 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama_1_1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    d_ff=5632,
    vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=4, head_dim=64),
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
    source="arXiv:2401.02385",
)
