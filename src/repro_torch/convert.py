"""Parameters of the reference package -> the port's module state.

``params_from_jax(tree, cfg)`` takes the reference's parameter pytree as
numpy arrays (layers stacked on axis 0, linear weights laid out (in, out))
and returns a state dict for the port's model of ``cfg.family``
(``transformer.Transformer`` for dense, MoE and VLM, ``hybrid.Hybrid``,
``ssm_lm.SSMLM``, ``encdec.EncDec``), whose linear weights are (out, in):
each is transposed here.  The SSM's ``conv_w`` and the
experts' (E, in, out) ``w1``, ``w3``, ``w2`` keep their layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))   # a copy: jax's arrays are read-only


def _linear(a) -> torch.Tensor:
    return _t(np.asarray(a).T)


def _attn(attn: dict, idx, pre: str, cfg: ModelConfig) -> dict:
    sd = {pre + f"{name}.weight": _linear(attn[name][idx])
          for name in ("wq", "wk", "wv", "wo")}
    if cfg.attn.qk_norm:
        sd[pre + "q_norm"] = _t(attn["q_norm"][idx])
        sd[pre + "k_norm"] = _t(attn["k_norm"][idx])
    return sd


def _block(blk: dict, idx, pre: str, cfg: ModelConfig) -> dict:
    """One attention + MLP (or MoE) block; ``idx`` picks a layer of a
    stacked tree (``()`` takes the arrays as they are)."""
    sd = {pre + "ln1": _t(blk["ln1"][idx]), pre + "ln2": _t(blk["ln2"][idx])}
    sd.update(_attn(blk["attn"], idx, pre + "attn.", cfg))
    if "moe" in blk:
        moe = blk["moe"]
        sd[pre + "moe.router.weight"] = _linear(moe["router"][idx])
        for name in ("w1", "w2", "w3"):
            sd[pre + f"moe.{name}"] = _t(moe[name][idx])
        return sd
    mlp = blk["mlp"]
    for name in ("w1", "w2", "w3"):
        if name in mlp:
            sd[pre + f"mlp.{name}.weight"] = _linear(mlp[name][idx])
    return sd


def _ssm(p: dict, i: int, pre: str) -> dict:
    sd = {pre + "in_proj.weight": _linear(p["in_proj"][i]),
          pre + "out_proj.weight": _linear(p["out_proj"][i])}
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm"):
        sd[pre + name] = _t(p[name][i])
    return sd


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    sd = {"embed": _t(tree["embed"]), "final_norm": _t(tree["final_norm"])}
    if cfg.family == "encdec":
        sd["pos_embed"] = _t(tree["pos_embed"])
        sd["enc_norm"] = _t(tree["enc_norm"])
        for i in range(cfg.encoder_layers):
            sd.update(_block(tree["enc_layers"], i, f"enc_layers.{i}.", cfg))
        dec = tree["dec_layers"]
        for i in range(cfg.n_layers):
            pre = f"dec_layers.{i}."
            sd.update(_block(dec, i, pre, cfg))
            sd[pre + "ln_x"] = _t(dec["ln_x"][i])
            sd.update(_attn(dec["xattn"], i, pre + "xattn.", cfg))
        return sd
    layers = tree["layers"]
    if cfg.family in ("hybrid", "ssm"):
        for i in range(cfg.n_layers):
            sd[f"layers.{i}.ln"] = _t(layers["ln"][i])
            sd.update(_ssm(layers["ssm"], i, f"layers.{i}.ssm."))
        if cfg.family == "hybrid":
            sd.update(_block(tree["shared"], (), "shared.", cfg))
        return sd
    for i in range(cfg.n_layers):
        sd.update(_block(layers, i, f"layers.{i}.", cfg))
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _linear(tree["lm_head"])
    return sd


def train_state_from_jax(state, cfg: ModelConfig):
    """The reference's ``TrainState`` (params, opt = AdamWState(step, m,
    v)) -> (the port's model state dict, its ``AdamWState``), for every
    family.  Gradients and moments share the parameters' tree, so
    ``params_from_jax`` maps each (gradients too, in the tests): the
    router's (in, E) moments are transposed as its weight is."""
    from repro_torch.optim import AdamWState
    return params_from_jax(state.params, cfg), AdamWState(
        step=int(np.asarray(state.opt.step)),
        m=params_from_jax(state.opt.m, cfg),
        v=params_from_jax(state.opt.v, cfg))
