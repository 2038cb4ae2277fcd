"""Decoder-only dense transformer LM (counterpart of
``repro/models/transformer.py``, dense family).

The layers are a Python loop over an ``nn.ModuleList``; local/global
window alternation (gemma) is a static window per layer.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common


class Block(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.ln2 = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = attention.Attention(cfg.d_model, cfg.attn, **kw)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, **kw)


class Transformer(torch.nn.Module):
    """Parameters of a dense LM.  Linear weights are stored (out, in), the
    transpose of the reference's (in, out) layout."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        a = cfg.attn
        if a is None or cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: not a dense LM")
        if a.window and a.local_global_period == 0:
            raise NotImplementedError(
                f"{cfg.name}: a uniform sliding window (rolling KV cache) "
                f"is not ported")
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.layers = torch.nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        torch.nn.Linear(cfg.d_model, cfg.vocab, bias=False,
                                        **kw))

    def is_global(self, i: int) -> bool:
        """Layer i uses full attention (the reference's layer_flags)."""
        p = self.cfg.attn.local_global_period
        return p == 0 or i % p == p - 1

    @torch.no_grad()
    def prefill(self, tokens, ex, cache=None):
        """tokens: (B, S) -> (last-position logits (B, V), cache).

        ``cache``: None allocates one of S positions; a larger cache from
        ``init_cache`` receives the prompt's K/V in place at [0, S).
        """
        cfg, a = self.cfg, self.cfg.attn
        b, s = tokens.shape
        if cache is None:
            cache = init_cache(cfg, b, s, ex.compute_dtype, tokens.device)
        x = self.embed[tokens].to(ex.compute_dtype)
        rope = common.rope_angles(torch.arange(s, device=tokens.device),
                                  a.head_dim, a.rope_theta)
        for i, blk in enumerate(self.layers):
            h = common.norm(x, blk.ln1, cfg.norm_eps)
            att, (k, v) = attention.attn_train(
                blk.attn, h, a, window=attention.layer_window(
                    a, self.is_global(i)),
                norm_eps=cfg.norm_eps, rope=rope, ex=ex)
            x = x + att
            h = common.norm(x, blk.ln2, cfg.norm_eps)
            x = x + common.mlp_apply(blk.mlp, h, cfg.gated_mlp)
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        logits = self._unembed(x[:, -1:])[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, ex):
        """tokens: (B,); pos: int.  -> (logits (B, V), cache updated in
        place)."""
        cfg, a = self.cfg, self.cfg.attn
        x = self.embed[tokens][:, None, :].to(ex.compute_dtype)
        rope = common.rope_angles(
            torch.arange(pos, pos + 1, device=tokens.device), a.head_dim,
            a.rope_theta)
        for i, blk in enumerate(self.layers):
            h = common.norm(x, blk.ln1, cfg.norm_eps)
            x = x + attention.attn_decode(
                blk.attn, h, cache["k"][i], cache["v"][i], pos, a,
                window=attention.layer_window(a, self.is_global(i)),
                norm_eps=cfg.norm_eps, rope=rope)
            h = common.norm(x, blk.ln2, cfg.norm_eps)
            x = x + common.mlp_apply(blk.mlp, h, cfg.gated_mlp)
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        logits = self._unembed(x[:, 0])
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits /
                                                    cfg.logit_softcap)
        return logits, cache

    def _unembed(self, x):
        if self.lm_head is None:
            return x @ self.embed.T
        return self.lm_head(x)


def lm_init(cfg: ModelConfig, ex: common.ExecConfig, seed: int = 0
            ) -> Transformer:
    """Seeded random weights, made on ``ex.device`` in ``ex.param_dtype``.

    Linear weights are normal * in**-0.5, the embedding normal * 0.02 and
    norm weights ones, as in the reference (whose jax.random draws differ).
    """
    device = common.check_device(ex.device)
    model = Transformer(cfg, device="meta", dtype=ex.param_dtype)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            elif name == "embed":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                common.dense_init(p, gen)
    return model


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """Zeroed KV cache for ``seq_len`` positions, (L, B, Hkv, S, hd)."""
    a = cfg.attn
    shape = (cfg.n_layers, batch, a.n_kv_heads, seq_len, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
