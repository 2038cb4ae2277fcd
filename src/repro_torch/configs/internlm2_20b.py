"""internlm2-20b: dense GQA LM.

[arXiv:2403.17297; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    d_ff=16384,
    vocab=92544,
    attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0),
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
    source="arXiv:2403.17297",
)
