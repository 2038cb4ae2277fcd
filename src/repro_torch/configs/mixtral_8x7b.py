"""mixtral-8x7b: 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8e top-2, SWA window 4096.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral_8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0, window=4096),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    tie_embeddings=False,
    supports_long_context=True,   # SWA -> bounded KV, sub-quadratic
    source="arXiv:2401.04088",
)
