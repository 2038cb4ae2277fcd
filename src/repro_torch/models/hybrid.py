"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention+MLP
block applied after every ``hybrid_period`` SSM layers, with the same
weights at every application (counterpart of ``repro/models/hybrid.py``).

The layers run in period groups: ``hybrid_period`` SSM layers, then the
shared block; the ``n_layers % hybrid_period`` leftover layers run
without it.  The shared block's KV cache has one entry per application.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ssm
from repro_torch.models.transformer import Block


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


class Hybrid(torch.nn.Module):
    """Parameters of a hybrid LM; the head is tied to the embedding."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.layers = torch.nn.ModuleList(
            ssm.Layer(cfg, **kw) for _ in range(cfg.n_layers))
        self.shared = Block(cfg, **kw)
        self.final_norm = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))

    def _schedule(self):
        """(layer index, shared-block application index after it or None),
        in order: the reference's period groups, then the leftovers."""
        p = self.cfg.hybrid_period
        n_apps = n_shared_applications(self.cfg)
        for i in range(self.cfg.n_layers):
            yield i, (i // p if i < n_apps * p and i % p == p - 1 else None)

    def _shared_mlp(self, x):
        cfg, blk = self.cfg, self.shared
        h = common.norm(x, blk.ln2, cfg.norm_eps)
        return x + common.mlp_apply(blk.mlp, h, cfg.gated_mlp)

    def _rope(self, x):
        a = self.cfg.attn
        return common.rope_angles(torch.arange(x.shape[1], device=x.device),
                                  a.head_dim, a.rope_theta)

    def _ssm_layer(self, i: int, x, ex):
        lyr = self.layers[i]
        h = common.norm(x, lyr.ln, self.cfg.norm_eps)
        return x + ssm.ssm_train(lyr.ssm, h, self.cfg, ex)

    def _shared_block(self, x, ex, rope):
        """The shared block over x -> (x after it, its (k, v))."""
        cfg = self.cfg
        h = common.norm(x, self.shared.ln1, cfg.norm_eps)
        att, kv = attention.attn_train(
            self.shared.attn, h, cfg.attn, window=None,
            norm_eps=cfg.norm_eps, rope=rope, ex=ex)
        return self._shared_mlp(x + att), kv

    def _layers(self, x, ex):
        """Every SSM layer over the full sequence x (B, S, D), each
        followed by the shared block where the schedule applies it, as a
        generator of (application index or None, x after them, the
        block's (k, v) (B, Hkv, S, hd) or None)."""
        rope = self._rope(x)
        for i, app in self._schedule():
            x = self._ssm_layer(i, x, ex)
            kv = None
            if app is not None:
                x, kv = self._shared_block(x, ex, rope)
            yield app, x, kv

    def _period(self, x, app: int, ex, rope):
        """Application ``app``'s period: its ``hybrid_period`` SSM layers,
        then the shared block -> x (the reference's scan body)."""
        p = self.cfg.hybrid_period
        for i in range(app * p, (app + 1) * p):
            x = self._ssm_layer(i, x, ex)
        return self._shared_block(x, ex, rope)[0]

    def hidden(self, tokens, ex):
        """The full-sequence forward without a cache (the reference's
        ``hybrid_hidden``): tokens (B, S) -> final-normed hidden (B, S,
        D).  The shared block's parameters take gradient from every
        application.  Each whole period runs under ``ex.wrap_remat``, as
        the reference's scan body; the leftover layers run without it."""
        x = self.embed[tokens].to(ex.compute_dtype)
        rope = self._rope(x)
        body = ex.wrap_remat(self._period)
        n_apps = n_shared_applications(self.cfg)
        for app in range(n_apps):
            x = body(x, app, ex, rope)
        for i in range(n_apps * self.cfg.hybrid_period, self.cfg.n_layers):
            x = self._ssm_layer(i, x, ex)
        return common.norm(x, self.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def prefill(self, tokens, ex, cache=None):
        """tokens: (B, S) -> (last-position logits (B, V), cache).

        ``cache``: None allocates one of S positions; a larger cache from
        ``init_cache`` receives each application's K/V in place at [0, S).
        """
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            cache = init_cache(cfg, b, s, ex.compute_dtype, tokens.device)
        x = self.embed[tokens].to(ex.compute_dtype)
        for app, x, kv in self._layers(x, ex):
            if app is not None:
                cache["k"][app, :, :, :s] = kv[0]
                cache["v"][app, :, :, :s] = kv[1]
        # The reference's prefill returns the SSM and conv states of
        # hybrid_init_cache, i.e. zeros (repro/models/hybrid.py:122-130),
        # so decode starts from an empty state; the port does the same.
        cache["conv"].zero_()
        cache["ssm"].zero_()
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self.embed.T, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, ex):
        """tokens: (B,); pos: int.  -> (logits (B, V), cache updated in
        place)."""
        cfg, a = self.cfg, self.cfg.attn
        x = self.embed[tokens][:, None, :].to(ex.compute_dtype)
        rope = common.rope_angles(
            torch.arange(pos, pos + 1, device=tokens.device), a.head_dim,
            a.rope_theta)
        for i, app in self._schedule():
            lyr = self.layers[i]
            h = common.norm(x, lyr.ln, cfg.norm_eps)
            x = x + ssm.ssm_decode(lyr.ssm, h, cache["conv"][i],
                                   cache["ssm"][i], cfg)
            if app is not None:
                h = common.norm(x, self.shared.ln1, cfg.norm_eps)
                att = attention.attn_decode(
                    self.shared.attn, h, cache["k"][app], cache["v"][app],
                    pos, a, window=None, norm_eps=cfg.norm_eps, rope=rope)
                x = self._shared_mlp(x + att)
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, 0] @ self.embed.T, cache


def hybrid_loss(model: Hybrid, batch, cfg: ModelConfig, ex):
    """-> ``common.tied_head_loss`` of the hidden states (the reference's
    ``hybrid_loss``)."""
    del cfg
    return common.tied_head_loss(model.hidden(batch["tokens"], ex),
                                 model.embed, batch)


def hybrid_init(cfg: ModelConfig, ex: common.ExecConfig, seed: int = 0
                ) -> Hybrid:
    """Seeded random weights, made on ``ex.device`` in ``ex.param_dtype``,
    with the reference's scales (whose jax.random draws differ)."""
    device = common.check_device(ex.device)
    model = Hybrid(cfg, device="meta", dtype=ex.param_dtype)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.02, generator=gen)
        model.final_norm.fill_(1.0)
        for lyr in model.layers:
            lyr.ln.fill_(1.0)
            lyr.ssm.init_weights(gen)
        for name, p in model.shared.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                common.dense_init(p, gen)
    return model


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """Zeroed cache: the shared block's K/V, one entry per application,
    (n_apps, B, Hkv, S, hd), and every SSM layer's conv and SSM state."""
    a = cfg.attn
    shape = (n_shared_applications(cfg), batch, a.n_kv_heads, seq_len,
             a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            **ssm.ssm_init_state(cfg, cfg.n_layers, batch, dtype, device)}
