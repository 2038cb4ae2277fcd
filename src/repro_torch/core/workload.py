"""Training-workload description consumed by the ChipLight models.

Derived from the same ``ModelConfig`` the JAX model zoo executes — the
analytic traffic model and the compiled dry-run HLO therefore describe the
*same* workload (cross-validated in tests/test_traffic_vs_hlo.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class Workload:
    model: ModelConfig
    seq_len: int
    global_batch: int          # sequences per step
    bytes_act: int = 2         # bf16 activations
    bytes_grad: int = 4        # fp32 gradient all-reduce (Megatron default)
    bytes_param: int = 2

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return self.model.n_layers

    @property
    def d_model(self) -> int:
        return self.model.d_model

    @property
    def kv_bytes_per_token(self) -> int:
        a = self.model.attn
        if a is None:
            return 0
        return 2 * a.n_kv_heads * a.head_dim * self.bytes_act

    @property
    def n_attn_layers(self) -> int:
        m = self.model
        if m.attn is None:
            return 0
        if m.family == "hybrid" and m.hybrid_period:
            return m.n_layers // m.hybrid_period
        if m.family == "encdec":
            return m.n_layers + m.encoder_layers
        return m.n_layers

    @property
    def n_moe_layers(self) -> int:
        return self.model.n_layers if self.model.moe is not None else 0

    @property
    def total_params(self) -> int:
        return self.model.param_count()

    @property
    def active_params(self) -> int:
        return self.model.active_param_count()

    @property
    def expert_params(self) -> int:
        m = self.model.moe
        if m is None:
            return 0
        per_layer = m.n_experts * 3 * self.model.d_model * m.d_ff_expert
        return self.model.n_layers * per_layer

    @property
    def nonexpert_params(self) -> int:
        return self.total_params - self.expert_params

    def step_flops(self) -> float:
        """Total cluster FLOPs per training step (fwd+bwd ~ 3x fwd)."""
        return 3.0 * 2.0 * self.active_params * self.tokens_per_step \
            + 3.0 * self._attn_flops()

    def _attn_flops(self) -> float:
        a = self.model.attn
        if a is None:
            return 0.0
        s = self.seq_len
        eff = s
        if a.window:
            frac_local = 1.0
            if a.local_global_period:
                frac_local = ((a.local_global_period - 1)
                              / a.local_global_period)
            eff = frac_local * min(a.window, s) + (1 - frac_local) * s
        per_token = self.n_attn_layers * 4.0 * a.n_heads * a.head_dim \
            * (eff / 2.0)
        return per_token * self.tokens_per_step


# The paper's evaluation target (§V-A): Qwen3-235B-A22B, 10k context.
def paper_workload(global_batch: int = 512) -> Workload:
    from repro_torch.configs import get_config
    return Workload(model=get_config("qwen3_moe_235b_a22b"),
                    seq_len=10240, global_batch=global_batch)
