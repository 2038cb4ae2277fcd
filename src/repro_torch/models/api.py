"""Unified model API: ``build_model(cfg)`` -> ModelFns (counterpart of
``repro/models/api.py``; every family: dense, MoE, hybrid, SSM, VLM and
encdec).

  init(seed, ex) -> model (an nn.Module holding the parameters)
  skeleton(dtype) -> the family's module on the meta device, its
      parameters unset (the dry run makes them fake on its device)
  prefill(model, batch, ex, cache=None) -> (logits, cache)
  decode_step(model, cache, tokens, pos, ex) -> (logits, cache)
  init_cache(batch, seq_len, ex) -> cache
  make_batch(seed, shape, ex, kind="prefill") -> synthetic batch ("train"
      adds labels, and for a vlm the loss mask over its prefix)
  loss(model, batch, ex) -> (loss, {"ce", "aux"})
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.common import check_device

# family -> (seeded init, cache allocator, module class)
_FAMILIES = {
    "dense": (transformer.lm_init, transformer.init_cache,
              transformer.Transformer),
    "moe": (transformer.lm_init, transformer.init_cache,
            transformer.Transformer),
    "hybrid": (hybrid.hybrid_init, hybrid.init_cache, hybrid.Hybrid),
    "ssm": (ssm_lm.ssm_lm_init, ssm_lm.init_cache, ssm_lm.SSMLM),
    "vlm": (transformer.lm_init, transformer.init_cache,
            transformer.Transformer),
    "encdec": (encdec.encdec_init, encdec.init_cache, encdec.EncDec),
}
PORTED_FAMILIES = tuple(_FAMILIES)
# family -> loss(model, batch, cfg, ex)
_LOSSES = {"dense": transformer.lm_loss, "moe": transformer.lm_loss,
           "vlm": transformer.lm_loss, "hybrid": hybrid.hybrid_loss,
           "ssm": ssm_lm.ssm_lm_loss, "encdec": encdec.encdec_loss}


@dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable
    skeleton: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    make_batch: Callable
    loss: Callable


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"ported: {PORTED_FAMILIES}")
    family_init, family_cache, family_module = _FAMILIES[cfg.family]

    def init(seed, ex):
        return family_init(cfg, ex, seed)

    def skeleton(dtype):
        return family_module(cfg, device="meta", dtype=dtype)

    def prefill(model, batch, ex, cache=None):
        # a vlm's prefix embeddings, an encdec's encoder frames
        extra = {k: batch[k] for k in ("prefix_embeds", "encoder_embeds")
                 if k in batch}
        return model.prefill(batch["tokens"], ex, cache, **extra)

    def decode_step(model, cache, tokens, pos, ex):
        return model.decode_step(cache, tokens, pos, ex)

    def init_cache(batch, seq_len, ex):
        return family_cache(cfg, batch, seq_len, ex.compute_dtype,
                            check_device(ex.device))

    def loss(model, batch, ex):
        return _LOSSES[cfg.family](model, batch, cfg, ex)

    def make_batch(seed, shape: ShapeConfig, ex, kind="prefill"):
        # drawn on the CPU so every device gets the same batch; a vlm
        # config's prefix embeddings (standing in for the vision tower) and
        # an encdec config's encoder frames (standing in for the audio
        # frontend) are standard normals from the same generator, in
        # compute dtype; "train" labels are drawn last, so the other
        # tensors do not depend on the kind; a vlm's "train" loss mask is
        # 0 over its prefix positions and 1 elsewhere (the reference's)
        if kind not in ("prefill", "train"):
            raise ValueError(f"kind must be 'prefill' or 'train', got "
                             f"{kind!r}")
        device = check_device(ex.device)
        gen = torch.Generator().manual_seed(seed)
        b, s = shape.global_batch, shape.seq_len
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
        batch = {"tokens": tokens.to(device)}
        if cfg.family == "vlm":
            prefix = torch.randn((b, cfg.n_prefix_tokens, cfg.d_model),
                                 generator=gen)
            batch["prefix_embeds"] = prefix.to(ex.compute_dtype).to(device)
        if cfg.family == "encdec":
            frames = torch.randn((b, cfg.encoder_len, cfg.d_model),
                                 generator=gen)
            batch["encoder_embeds"] = frames.to(ex.compute_dtype).to(device)
        if kind == "train":
            labels = torch.randint(0, cfg.vocab, (b, s), generator=gen)
            batch["labels"] = labels.to(device)
            if cfg.family == "vlm":
                mask = torch.ones((b, s), dtype=torch.float32)
                mask[:, :cfg.n_prefix_tokens] = 0.0
                batch["loss_mask"] = mask.to(device)
        return batch

    return ModelFns(cfg=cfg, init=init, skeleton=skeleton, prefill=prefill,
                    decode_step=decode_step, init_cache=init_cache,
                    make_batch=make_batch, loss=loss)
