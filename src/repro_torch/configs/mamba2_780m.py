"""mamba2-780m: attention-free SSD (state-space duality) LM.

[arXiv:2405.21060; unverified] 48L d_model=1536 d_ff=0 vocab=50280,
ssm_state=128.  SSD: d_inner = 2*d_model = 3072, head_dim=64 -> 48 heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128, n_groups=1),
    supports_long_context=True,   # O(1)-in-seq decode state
    source="arXiv:2405.21060",
)
