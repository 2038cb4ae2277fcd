"""llava-next-34b: VLM; transformer BACKBONE only (anyres tiling STUB).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000.  ``input_specs`` provides precomputed
patch embeddings (n_prefix_tokens) standing in for the vision tower +
anyres tiling.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab=64000,
    attn=AttnConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                    rope_theta=5_000_000.0),
    n_prefix_tokens=576,      # one anyres tile of 24x24 patches (stub)
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
