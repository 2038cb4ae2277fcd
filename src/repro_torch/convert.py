"""Parameters of the reference package -> the port's module state.

``params_from_jax(tree, cfg)`` takes the reference's dense-LM parameter
pytree as numpy arrays (layers stacked on axis 0, linear weights laid out
(in, out)) and returns a state dict for
``repro_torch.models.transformer.Transformer``, whose linear weights are
(out, in): each is transposed here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))   # a copy: jax's arrays are read-only


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    layers = tree["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    sd = {"embed": _t(tree["embed"]), "final_norm": _t(tree["final_norm"])}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        sd[pre + "ln1"] = _t(layers["ln1"][i])
        sd[pre + "ln2"] = _t(layers["ln2"][i])
        for name in ("wq", "wk", "wv", "wo"):
            sd[pre + f"attn.{name}.weight"] = _t(np.asarray(attn[name][i]).T)
        if cfg.attn.qk_norm:
            sd[pre + "attn.q_norm"] = _t(attn["q_norm"][i])
            sd[pre + "attn.k_norm"] = _t(attn["k_norm"][i])
        for name in ("w1", "w2", "w3"):
            if name in mlp:
                sd[pre + f"mlp.{name}.weight"] = _t(np.asarray(mlp[name][i]).T)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _t(np.asarray(tree["lm_head"]).T)
    return sd
