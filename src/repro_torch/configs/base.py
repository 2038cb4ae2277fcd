"""Model / shape configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; reduced
versions (for CPU smoke tests) are derived with ``.reduced()``.  The FULL
configs are only ever lowered AOT (ShapeDtypeStruct) by the dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    # Sliding window size (None = full attention everywhere).
    window: Optional[int] = None
    # Local:global alternating pattern period.  0 = uniform (all layers use
    # ``window`` if set, else full).  period=2 -> (local, global) alternating
    # (gemma2); period=6 -> 5 local + 1 global (gemma3).  Global layers use
    # full attention, local layers use ``window``.
    local_global_period: int = 0
    attn_softcap: float = 0.0
    qk_norm: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    router_jitter: float = 0.0
    # capacity factor for padded (sort-based) dispatch
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    # number of B/C groups (like GQA for SSM)
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a *shared* attention+MLP block applied every
    # ``hybrid_period`` ssm layers (weights reused at every application).
    hybrid_period: int = 0
    # enc-dec (whisper): number of encoder layers and fixed source length of
    # the (stubbed) audio frontend output.
    encoder_layers: int = 0
    encoder_len: int = 0
    # vlm (llava): number of (stubbed) image-patch prefix embeddings.
    n_prefix_tokens: int = 0
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    tie_embeddings: bool = True
    # llama-style gated MLP everywhere except whisper (gelu MLP)
    gated_mlp: bool = True
    # long_500k eligibility (sub-quadratic decode path); see DESIGN.md.
    supports_long_context: bool = False
    source: str = ""

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = self.attn.local_global_period if self.attn else 0
        n_layers = max(2, period) if period else 2
        if self.family == "hybrid":
            n_layers = 4
        attn = None
        if self.attn is not None:
            attn = dataclasses.replace(
                self.attn, n_heads=4, n_kv_heads=2, head_dim=16,
                window=(16 if self.attn.window else None))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_ff_expert=32)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=8,
                                      chunk=8)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=64, d_ff=128, vocab=512,
            attn=attn, moe=moe, ssm=ssm,
            hybrid_period=2 if self.hybrid_period else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_len=16 if self.encoder_len else 0,
            n_prefix_tokens=8 if self.n_prefix_tokens else 0,
            name=self.name + "-reduced")

    # ------------------------------------------------------------------
    # Analytic parameter counts (used for roofline MODEL_FLOPS = 6*N*D and
    # by the ChipLight traffic/memory models).
    def _attn_params(self) -> int:
        a = self.attn
        if a is None:
            return 0
        d = self.d_model
        return (d * a.n_heads * a.head_dim            # q
                + 2 * d * a.n_kv_heads * a.head_dim   # k, v
                + a.n_heads * a.head_dim * d)         # o

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.gated_mlp else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        if s is None:
            return 0
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        # in_proj produces [z, x, B, C, dt]
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        out_proj = di * d
        conv = s.conv_width * (di + 2 * s.n_groups * s.d_state)
        extra = nh * 3  # A_log, D, dt_bias
        return in_proj + out_proj + conv + extra

    def layer_params(self) -> int:
        """Parameters of one (decoder) layer, incl. norms."""
        d = self.d_model
        if self.family == "ssm":
            return self._ssm_params() + d
        if self.family == "hybrid":
            # ssm layer only; the shared block is counted once in param_count
            return self._ssm_params() + d
        p = self._attn_params() + 2 * d
        if self.moe is not None:
            router = d * self.moe.n_experts
            p += router + self.moe.n_experts * self._mlp_params(
                self.moe.d_ff_expert)
        else:
            p += self._mlp_params(self.d_ff)
        return p

    def param_count(self) -> int:
        p = self.n_layers * self.layer_params()
        p += self.vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            p += self.vocab * self.d_model
        p += self.d_model  # final norm
        if self.family == "hybrid":
            # one shared attention+MLP block
            p += self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
        if self.family == "encdec":
            enc_layer = self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
            cross = self._attn_params() + self.d_model
            p += self.encoder_layers * enc_layer + self.n_layers * cross
        return p

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense_layer = self._attn_params() + 2 * d + d * self.moe.n_experts
        active_ffn = self.moe.top_k * self._mlp_params(self.moe.d_ff_expert)
        p = self.n_layers * (dense_layer + active_ffn)
        p += self.vocab * d + d
        return p

    # FLOPs per token for a forward pass (2*active params + attention term)
    def fwd_flops_per_token(self, seq_len: int) -> float:
        base = 2.0 * self.active_param_count()
        if self.attn is not None:
            a = self.attn
            n_attn_layers = self.n_layers
            if self.family == "hybrid" and self.hybrid_period:
                n_attn_layers = self.n_layers // self.hybrid_period
            if self.family == "encdec":
                n_attn_layers = self.n_layers + self.encoder_layers
            # causal: average key length seq/2 per query
            eff = seq_len
            if a.window:
                frac_local = 1.0
                if a.local_global_period:
                    frac_local = (a.local_global_period - 1) / a.local_global_period
                eff = frac_local * min(a.window, seq_len) + (1 - frac_local) * seq_len
            base += n_attn_layers * 4.0 * a.n_heads * a.head_dim * (eff / 2.0)
        return base


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
