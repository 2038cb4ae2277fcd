"""Whisper-style encoder-decoder (counterpart of ``repro/models/encdec.py``;
the audio conv frontend is a stub in both packages).

The encoder takes precomputed frame embeddings (B, encoder_len, D) plus a
learned ``pos_embed`` and runs bidirectional attention; the decoder runs
causal self-attention, then cross-attention over the encoder output, then
the MLP.  As in the reference (not the published Whisper): rmsnorm, rope
in the encoder and in the decoder's self-attention, none on the cross K/V,
a tanh-GELU MLP and tied embeddings.  Prefill writes the decoder's self
K/V and the cross K/V into the preallocated cache in place; decode
updates the self K/V only and reads the cross K/V as they are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.transformer import Block


class DecBlock(Block):
    """A decoder layer: the encoder layer's ln1, attn, ln2 and mlp, and the
    cross-attention with its norm ``ln_x``."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.ln_x = torch.nn.Parameter(
            torch.empty(cfg.d_model, device=device, dtype=dtype))
        self.xattn = attention.Attention(cfg.d_model, cfg.attn,
                                         device=device, dtype=dtype)


class EncDec(torch.nn.Module):
    """Parameters of the encoder-decoder; linear weights (out, in), the
    transpose of the reference's layout."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = torch.nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.pos_embed = torch.nn.Parameter(
            torch.empty(cfg.encoder_len, cfg.d_model, **kw))
        self.enc_layers = torch.nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.dec_layers = torch.nn.ModuleList(
            DecBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.enc_norm = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.final_norm = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))

    def _rope(self, n: int, device):
        a = self.cfg.attn
        return common.rope_angles(torch.arange(n, device=device),
                                  a.head_dim, a.rope_theta)

    def _enc_layer(self, x, i: int, ex, rope):
        """Encoder layer i over x (the reference's encoder scan body)."""
        cfg, blk = self.cfg, self.enc_layers[i]
        h = common.norm(x, blk.ln1, cfg.norm_eps)
        att, _ = attention.attn_train(blk.attn, h, cfg.attn, window=None,
                                      norm_eps=cfg.norm_eps, rope=rope,
                                      ex=ex, causal=False)
        x = x + att
        h = common.norm(x, blk.ln2, cfg.norm_eps)
        return x + blk.ffn(h, cfg)[0]

    def _encode(self, frames, ex):
        """Each encoder layer runs under ``ex.wrap_remat``."""
        cfg = self.cfg
        shape = tuple(frames.shape)
        if len(shape) != 3 or shape[1:] != (cfg.encoder_len, cfg.d_model):
            raise ValueError(f"encoder_embeds {shape} must be (B, "
                             f"{cfg.encoder_len}, {cfg.d_model})")
        x = frames.to(ex.compute_dtype) + self.pos_embed
        rope = self._rope(cfg.encoder_len, frames.device)
        body = ex.wrap_remat(self._enc_layer)
        for i in range(len(self.enc_layers)):
            x = body(x, i, ex, rope)
        return common.norm(x, self.enc_norm, cfg.norm_eps)

    @torch.no_grad()
    def encode(self, frames, ex):
        """frames: (B, encoder_len, D) stub embeddings -> (B, len, D)."""
        return self._encode(frames, ex)

    def _dec_layer(self, i: int, x, enc, ex, rope):
        """Decoder layer i over the full sequence x (B, S, D) and the
        encoder output ``enc`` (the reference's decoder scan body) -> (x
        after it, its self (k, v) (B, Hkv, S, hd), its cross (k, v) (B,
        Hkv, encoder_len, hd))."""
        cfg, a, blk = self.cfg, self.cfg.attn, self.dec_layers[i]
        h = common.norm(x, blk.ln1, cfg.norm_eps)
        att, kv = attention.attn_train(
            blk.attn, h, a, window=None, norm_eps=cfg.norm_eps,
            rope=rope, ex=ex)
        x = x + att
        h = common.norm(x, blk.ln_x, cfg.norm_eps)
        xa, xkv = attention.attn_train(
            blk.xattn, h, a, window=None, norm_eps=cfg.norm_eps,
            rope=None, ex=ex, kv_source=enc)
        x = x + xa
        h = common.norm(x, blk.ln2, cfg.norm_eps)
        return x + blk.ffn(h, cfg)[0], kv, xkv

    def _dec_layers(self, x, enc, ex):
        """Every decoder layer, as a generator of (layer index, x after
        it, its self (k, v), its cross (k, v))."""
        rope = self._rope(x.shape[1], x.device)
        for i in range(len(self.dec_layers)):
            x, kv, xkv = self._dec_layer(i, x, enc, ex, rope)
            yield i, x, kv, xkv

    def hidden(self, tokens, encoder_embeds, ex):
        """The full-sequence forward without a cache (the reference's
        ``encdec_loss`` up to its head): tokens (B, S) and encoder_embeds
        (B, encoder_len, D) -> the decoder's final-normed hidden (B, S,
        D): the encoder, then causal self-attention and cross-attention
        over the encoder output (Sq != Sk) in every decoder layer.  Each
        encoder and each decoder layer runs under ``ex.wrap_remat``; only
        x leaves a decoder layer's body."""
        enc = self._encode(encoder_embeds, ex)
        x = self.embed[tokens].to(ex.compute_dtype)
        rope = self._rope(x.shape[1], x.device)
        body = ex.wrap_remat(
            lambda x, i: self._dec_layer(i, x, enc, ex, rope)[0])
        for i in range(len(self.dec_layers)):
            x = body(x, i)
        return common.norm(x, self.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def prefill(self, tokens, ex, cache=None, encoder_embeds=None):
        """tokens: (B, S); encoder_embeds: (B, encoder_len, D) -> (last-
        position logits (B, V), cache).  ``cache``: None allocates one of S
        positions; a larger cache from ``init_cache`` receives the prompt's
        self K/V in place at [0, S), and the cross K/V whole."""
        if encoder_embeds is None:
            raise ValueError("an encdec prefill needs encoder_embeds")
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            cache = init_cache(cfg, b, s, ex.compute_dtype, tokens.device)
        enc = self.encode(encoder_embeds, ex)
        x = self.embed[tokens].to(ex.compute_dtype)
        for i, x, (k, v), (xk, xv) in self._dec_layers(x, enc, ex):
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
            cache["xk"][i] = xk
            cache["xv"][i] = xv
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, -1] @ self.embed.T, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int, ex):
        """tokens: (B,); pos: int.  -> (logits (B, V), cache with the new
        self K/V written in place)."""
        cfg, a = self.cfg, self.cfg.attn
        x = self.embed[tokens][:, None, :].to(ex.compute_dtype)
        rope = common.rope_angles(
            torch.arange(pos, pos + 1, device=tokens.device), a.head_dim,
            a.rope_theta)
        for i, blk in enumerate(self.dec_layers):
            h = common.norm(x, blk.ln1, cfg.norm_eps)
            x = x + attention.attn_decode(
                blk.attn, h, cache["k"][i], cache["v"][i], pos, a,
                window=None, norm_eps=cfg.norm_eps, rope=rope)
            h = common.norm(x, blk.ln_x, cfg.norm_eps)
            x = x + attention.cross_decode(blk.xattn, h, cache["xk"][i],
                                           cache["xv"][i], a)
            h = common.norm(x, blk.ln2, cfg.norm_eps)
            x = x + blk.ffn(h, cfg)[0]
        x = common.norm(x, self.final_norm, cfg.norm_eps)
        return x[:, 0] @ self.embed.T, cache


def encdec_loss(model: EncDec, batch, cfg: ModelConfig, ex):
    """-> ``common.tied_head_loss`` of the decoder's hidden states (the
    reference's ``encdec_loss``)."""
    del cfg
    return common.tied_head_loss(
        model.hidden(batch["tokens"], batch["encoder_embeds"], ex),
        model.embed, batch)


def encdec_init(cfg: ModelConfig, ex: common.ExecConfig, seed: int = 0
                ) -> EncDec:
    """Seeded random weights, made on ``ex.device`` in ``ex.param_dtype``:
    linear weights normal * in**-0.5, the embedding and ``pos_embed``
    normal * 0.02, norm weights ones, as in the reference (whose
    jax.random draws differ)."""
    device = common.check_device(ex.device)
    model = EncDec(cfg, device="meta", dtype=ex.param_dtype)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            elif name in ("embed", "pos_embed"):
                p.normal_(0.0, 0.02, generator=gen)
            else:
                common.dense_init(p, gen)
    return model


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """Zeroed caches: the decoder's self K/V ``k``, ``v`` (L, B, Hkv,
    seq_len, hd) and the cross K/V ``xk``, ``xv`` (L, B, Hkv, encoder_len,
    hd), as the reference's ``encdec_init_cache``."""
    a = cfg.attn
    self_shape = (cfg.n_layers, batch, a.n_kv_heads, seq_len, a.head_dim)
    cross_shape = (cfg.n_layers, batch, a.n_kv_heads, cfg.encoder_len,
                   a.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in (("k", self_shape), ("v", self_shape),
                                ("xk", cross_shape), ("xv", cross_shape))}
