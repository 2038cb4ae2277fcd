"""Architecture config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig, SHAPES,
                                ShapeConfig, SSMConfig)

ARCH_IDS = [
    "whisper_medium",
    "mamba2_780m",
    "llava_next_34b",
    "qwen3_moe_235b_a22b",
    "mixtral_8x7b",
    "zamba2_7b",
    "gemma2_2b",
    "gemma3_27b",
    "tinyllama_1_1b",
    "internlm2_20b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def canonical_arch(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch(name)}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config", "all_configs",
           "canonical_arch"]
