"""Deterministic, resumable synthetic-token data pipeline (counterpart of
``repro/data/pipeline.py``).

Stateless batch generation — ``batch_at(step)`` is a pure function of
``(seed, step)``, so:
  * restart-after-crash resumes bit-exactly from the checkpointed step,
  * straggler mitigation by step-skipping needs no coordination.

Each batch is drawn on the host from a ``torch.Generator`` seeded by
``numpy.random.SeedSequence([seed, step])`` and then moved to the train
device, so the card and the CPU see the same tokens.  The draws are not
the reference's (it draws with ``jax.random.fold_in``, which the port
does not reproduce); the contract is: the same keys, shapes and dtypes,
tokens and labels from a u**2 zipf-ish marginal over the vocabulary, a
vlm's prefix embeddings 0.02 N(0, 1) with a loss mask that is zero over
the prefix, an encdec's encoder frames 0.1 N(0, 1), and every floating
tensor in ``ex.compute_dtype`` when an ``ExecConfig`` is given.  A real
corpus loader would slot in behind the same interface (the determinism
contract is the point — see ``runtime/fault_tolerance.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import check_device


@dataclass(frozen=True)
class PipelineState:
    seed: int
    step: int

    def advance(self, n: int = 1) -> "PipelineState":
        return PipelineState(self.seed, self.step + n)


class DataPipeline:
    """Synthetic LM batches with zipf-ish token statistics, on ``device``
    (default: ``ex.device`` when ``ex`` is given, else the card)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 ex=None, device=None):
        self.cfg = cfg
        self.shape = shape
        self.state = PipelineState(seed=seed, step=0)
        self.ex = ex
        if device is None:
            device = ex.device if ex is not None else "cuda"
        self.device = check_device(device)

    # ------------------------------------------------------------------
    def _generator(self, step: int) -> torch.Generator:
        ss = np.random.SeedSequence([self.state.seed, step])
        return torch.Generator().manual_seed(
            int(ss.generate_state(1, np.uint64)[0]))

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) -> batch dict."""
        cfg, shape = self.cfg, self.shape
        gen = self._generator(step)
        b, s = shape.global_batch, shape.seq_len
        # zipf-like marginal over the vocab via squared uniform
        u = torch.rand((b, s + 1), generator=gen)
        tokens_full = (u * u * (cfg.vocab - 1)).to(torch.int32)
        batch = {"tokens": tokens_full[:, :s].contiguous(),
                 "labels": tokens_full[:, 1:].contiguous()}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = 0.02 * torch.randn(
                (b, cfg.n_prefix_tokens, cfg.d_model), generator=gen)
            mask = torch.ones((b, s), dtype=torch.float32)
            mask[:, :cfg.n_prefix_tokens] = 0.0
            batch["loss_mask"] = mask
        if cfg.family == "encdec":
            batch["encoder_embeds"] = 0.1 * torch.randn(
                (b, cfg.encoder_len, cfg.d_model), generator=gen)
        if self.ex is not None:
            batch = {k: v.to(self.ex.compute_dtype)
                     if v.is_floating_point() else v
                     for k, v in batch.items()}
        return {k: v.to(self.device) for k, v in batch.items()}

    def __next__(self):
        batch = self.batch_at(self.state.step)
        self.state = self.state.advance()
        return batch

    def __iter__(self):
        return self

    # ------------------------------------------------------------------
    def checkpoint(self) -> dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore(self, ckpt: dict) -> None:
        self.state = PipelineState(seed=int(ckpt["seed"]),
                                   step=int(ckpt["step"]))
