"""zamba2-7b: Mamba2 backbone + shared attention blocks (hybrid).

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (MHA kv=32) d_ff=14336
vocab=32000, ssm_state=64.  A single *shared* attention+MLP block is applied
every ``hybrid_period`` mamba layers (weights reused each application).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=112),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128, n_groups=1),
    hybrid_period=6,
    supports_long_context=True,   # SSM backbone; sparse shared-attn blocks
    source="arXiv:2411.15242",
)
