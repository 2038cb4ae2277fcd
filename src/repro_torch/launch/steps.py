"""Prefill and serve step builders (counterpart of
``repro/launch/steps.py``; training is a later slice)."""
from __future__ import annotations

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``functional_call`` can swap the model's parameters for one call."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _call_cast(fn, model: torch.nn.Module, ex: ExecConfig, *args):
    """``fn(model, *args)`` with the model's floating parameters in
    ``ex.compute_dtype``: the module itself when they already are, else
    its parameters cast for this call only.  The caller's module keeps
    its ``param_dtype``, as the reference's parameters do (it casts them
    inside every call)."""
    params = dict(model.named_parameters())
    if all(p.dtype == ex.compute_dtype for p in params.values()
           if p.is_floating_point()):
        return fn(model, *args)
    cast = {f"model.{n}": p.to(ex.compute_dtype) if p.is_floating_point()
            else p for n, p in params.items()}
    return functional_call(_Bound(model, fn), cast, args)


def make_prefill_step(cfg: ModelConfig, ex: ExecConfig):
    """prefill_step(model, batch, cache=None) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def prefill_step(model, batch, cache=None):
        return _call_cast(model_fns.prefill, model, ex, batch, ex, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ex: ExecConfig):
    """One decode step: (model, cache, tokens, pos) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def serve_step(model, cache, tokens, pos):
        return _call_cast(model_fns.decode_step, model, ex, cache, tokens,
                          pos, ex)

    return serve_step
