"""Prefill and serve step builders (counterpart of
``repro/launch/steps.py``; training is a later slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig


def _cast(model: torch.nn.Module, ex: ExecConfig) -> torch.nn.Module:
    # The reference casts the floating params to compute_dtype inside
    # every jitted call.  A module is mutable, so the port casts it in
    # place; after the first call this changes nothing.
    return model.to(ex.compute_dtype)


def make_prefill_step(cfg: ModelConfig, ex: ExecConfig):
    """prefill_step(model, batch, cache=None) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def prefill_step(model, batch, cache=None):
        return model_fns.prefill(_cast(model, ex), batch, ex, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ex: ExecConfig):
    """One decode step: (model, cache, tokens, pos) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def serve_step(model, cache, tokens, pos):
        return model_fns.decode_step(_cast(model, ex), cache, tokens, pos, ex)

    return serve_step
