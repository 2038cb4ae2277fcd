"""Pure-SSM (Mamba2) language model: embed -> Mamba2 layers -> tied head
(counterpart of ``repro/models/ssm_lm.py``).

Prefill runs every layer's SSD scan with its final state and hands that
state and the conv window to decode, which carries them one token at a
time; the state is O(1) in the sequence, so the cache has no positions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, ssm


class SSMLM(torch.nn.Module):
    """Parameters of a Mamba2 LM; the head is tied to the embedding."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.layers = torch.nn.ModuleList(
            ssm.Layer(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))

    def hidden(self, tokens, ex):
        """The full-sequence forward without a state (the reference's
        ``ssm_lm_hidden``): tokens (B, S) -> final-normed hidden (B, S,
        D).  Each layer runs under ``ex.wrap_remat``, the reference's
        scan body."""
        cfg = self.cfg
        x = self.embed[tokens].to(ex.compute_dtype)
        body = ex.wrap_remat(self._layer)
        for i in range(len(self.layers)):
            x = body(x, i, ex)
        return common.norm(x, self.final_norm, cfg.norm_eps)

    def _layer(self, x, i: int, ex):
        lyr = self.layers[i]
        h = common.norm(x, lyr.ln, self.cfg.norm_eps)
        return x + ssm.ssm_train(lyr.ssm, h, self.cfg, ex)

    @torch.no_grad()
    def prefill(self, tokens, ex, cache=None):
        """tokens: (B, S) -> (last-position logits (B, V), cache).

        ``cache``: None allocates one; a cache from ``init_cache`` receives
        every layer's conv window and final SSD state in place (copies:
        decode updates them in place).
        """
        cfg = self.cfg
        b, _ = tokens.shape
        if cache is None:
            cache = init_cache(cfg, b, 0, ex.compute_dtype, tokens.device)
        x = self.embed[tokens].to(ex.compute_dtype)
        for i, lyr in enumerate(self.layers):
            h = common.norm(x, lyr.ln, cfg.norm_eps)
            y, conv, state = ssm.ssm_train_with_state(lyr.ssm, h, cfg, ex)
            x = x + y
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(state)
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self.embed.T, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, ex):
        """tokens: (B,) -> (logits (B, V), cache updated in place).  The
        state carries the position: ``pos`` is not read."""
        del pos
        cfg = self.cfg
        x = self.embed[tokens][:, None, :].to(ex.compute_dtype)
        for i, lyr in enumerate(self.layers):
            h = common.norm(x, lyr.ln, cfg.norm_eps)
            x = x + ssm.ssm_decode(lyr.ssm, h, cache["conv"][i],
                                   cache["ssm"][i], cfg)
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, 0] @ self.embed.T, cache


def ssm_lm_loss(model: SSMLM, batch, cfg: ModelConfig, ex):
    """-> ``common.tied_head_loss`` of the hidden states."""
    del cfg
    return common.tied_head_loss(model.hidden(batch["tokens"], ex),
                                 model.embed, batch)


def ssm_lm_init(cfg: ModelConfig, ex: common.ExecConfig, seed: int = 0
                ) -> SSMLM:
    """Seeded random weights, made on ``ex.device`` in ``ex.param_dtype``,
    with the reference's scales (whose jax.random draws differ)."""
    device = common.check_device(ex.device)
    model = SSMLM(cfg, device="meta", dtype=ex.param_dtype)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.02, generator=gen)
        model.final_norm.fill_(1.0)
        for lyr in model.layers:
            lyr.ln.fill_(1.0)
            lyr.ssm.init_weights(gen)
    return model


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """Zeroed decode state of every layer (``ssm.ssm_init_state``); its size
    does not depend on ``seq_len``."""
    del seq_len
    return ssm.ssm_init_state(cfg, cfg.n_layers, batch, dtype, device)
