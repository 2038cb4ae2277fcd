"""gemma2-2b: local+global alternating attention, logit softcap.

[arXiv:2408.00118; hf] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
window 4096, alternating local/global (period 2), attn softcap 50, final
logit softcap 30.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2_2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab=256000,
    attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256, window=4096,
                    local_global_period=2, attn_softcap=50.0),
    logit_softcap=30.0,
    tie_embeddings=True,
    supports_long_context=True,   # local layers bounded; global linear decode
    source="arXiv:2408.00118",
)
