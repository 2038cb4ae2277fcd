"""qwen3-moe-235b-a22b: 128-expert top-8 MoE (the paper's target model).

[hf:Qwen/Qwen3-30B-A3B; hf] 94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536
vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    d_ff=12288,               # unused (all layers MoE); kept for reference
    vocab=151936,
    attn=AttnConfig(n_heads=64, n_kv_heads=4, head_dim=128,
                    rope_theta=1_000_000.0, qk_norm=True),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention
    source="hf:Qwen/Qwen3-30B-A3B (scaled per arXiv:2505.09388)",
)
