"""Decoder-only transformer LM (counterpart of
``repro/models/transformer.py``: the dense and MoE families, and the VLM
backbone, whose prefill takes precomputed prefix embeddings).

The layers are a Python loop over an ``nn.ModuleList``; local/global
window alternation (gemma) is a static window per layer, and a uniform
window (mixtral) keeps a rolling KV cache of ``window`` positions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, moe


class Block(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.ln2 = torch.nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = attention.Attention(cfg.d_model, cfg.attn, **kw)
        if cfg.moe is not None:
            self.moe = moe.MoE(cfg.d_model, cfg.moe, **kw)
        else:
            self.mlp = common.MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, **kw)

    def ffn(self, h, cfg: ModelConfig, with_aux: bool = False, ex=None):
        """-> (the MLP's or the MoE's output, the router's aux loss with
        ``with_aux`` and experts, else 0.0).  With ``ex.moe_impl ==
        "a2a"`` and a mesh, the experts run over the mesh's all-to-all,
        which always computes its aux loss (the reference's
        ``_layer_train``)."""
        if cfg.moe is not None:
            if ex is not None and ex.moe_impl == "a2a" \
                    and ex.mesh is not None:
                from repro_torch.parallel.moe_a2a import moe_apply_a2a
                return moe_apply_a2a(self.moe, h, cfg.moe, ex, ex.mesh)
            return moe.moe_apply(self.moe, h, cfg.moe, with_aux=with_aux)
        return common.mlp_apply(self.mlp, h, cfg.gated_mlp), 0.0


class Transformer(torch.nn.Module):
    """Parameters of a dense or MoE LM.  Linear weights are stored (out,
    in), the transpose of the reference's (in, out) layout; expert weights
    keep the reference's (E, in, out)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.attn is None:
            raise NotImplementedError(f"{cfg.name}: not a decoder LM")
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

    def _embed(self, tokens, ex, prefix_embeds):
        """(B, S) tokens -> (B, S, D) in the compute dtype, the first P
        positions taken by ``prefix_embeds`` (B, P, D) where given (the
        reference's ``_embed``: the tokens there are ignored)."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.embed[tokens].to(ex.compute_dtype)
        if prefix_embeds is None:
            return x
        shape = tuple(prefix_embeds.shape)
        if (len(shape) != 3 or shape[0] != b or shape[1] > s
                or shape[2] != cfg.d_model):
            raise ValueError(f"prefix_embeds {shape} must be (B={b}, "
                             f"P<={s}, D={cfg.d_model})")
        return torch.cat([prefix_embeds.to(ex.compute_dtype),
                          x[:, shape[1]:]], dim=1)

    def _rope(self, x):
        a = self.cfg.attn
        return common.rope_angles(torch.arange(x.shape[1], device=x.device),
                                  a.head_dim, a.rope_theta)

    def _block(self, i: int, x, ex, rope, with_aux: bool):
        """Layer i over the full sequence x (B, S, D) (the reference's
        scan body) -> (x after it, its (k, v) (B, Hkv, S, hd), its aux
        loss: ``Block.ffn``'s)."""
        cfg, a, blk = self.cfg, self.cfg.attn, self.layers[i]
        h = common.norm(x, blk.ln1, cfg.norm_eps)
        att, kv = attention.attn_train(
            blk.attn, h, a, window=attention.layer_window(
                a, self.is_global(i)),
            norm_eps=cfg.norm_eps, rope=rope, ex=ex)
        x = x + att
        h = common.norm(x, blk.ln2, cfg.norm_eps)
        y, aux = blk.ffn(h, cfg, with_aux, ex)
        return x + y, kv, aux

    def _layers(self, x, ex):
        """Every layer over the full sequence x (B, S, D), as a generator
        of (layer index, x after it, its (k, v))."""
        rope = self._rope(x)
        for i in range(len(self.layers)):
            x, kv, _ = self._block(i, x, ex, rope, False)
            yield i, x, kv

    def hidden(self, tokens, ex, prefix_embeds=None):
        """The full-sequence forward without a cache (the reference's
        ``lm_hidden``): tokens (B, S) -> (final-normed hidden (B, S, D),
        aux loss): the MoE routers' aux losses summed over the layers, 0.0
        without experts.  Each layer runs under ``ex.wrap_remat``, the
        reference's non-period scan body; the port has no
        ``static_layer_pattern``, so no period body.  Only x and the aux
        loss leave the body: no layer's K/V is kept."""
        x = self._embed(tokens, ex, prefix_embeds)
        rope = self._rope(x)
        body = ex.wrap_remat(
            lambda x, i: self._block(i, x, ex, rope, True)[::2])
        total = 0.0
        for i in range(len(self.layers)):
            x, aux = body(x, i)
            total = total + aux
        return common.norm(x, self.final_norm, self.cfg.norm_eps), total

    @torch.no_grad()
    def prefill(self, tokens, ex, cache=None, prefix_embeds=None):
        """tokens: (B, S) -> (last-position logits (B, V), cache).

        ``cache``: None allocates one of S positions; a larger cache from
        ``init_cache`` receives the prompt's K/V in place at [0, S).  A
        rolling cache receives the last min(S, window) positions at the
        front, as the reference's trimmed cache (ROADMAP C7).
        ``prefix_embeds``: None, or (B, P, D) with P <= S, which take the
        first P positions in the compute dtype; the tokens there are
        ignored (the reference's ``_embed``).
        """
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            cache = init_cache(cfg, b, s, ex.compute_dtype, tokens.device)
        clen = cache_len(cfg, s)
        x = self._embed(tokens, ex, prefix_embeds)
        for i, x, (k, v) in self._layers(x, ex):
            cache["k"][i, :, :, :clen] = k[:, :, s - clen:]
            cache["v"][i, :, :, :clen] = v[:, :, s - clen:]
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
                norm_eps=cfg.norm_eps, rope=rope,
                rolling=attention.is_rolling(a))
            h = common.norm(x, blk.ln2, cfg.norm_eps)
            x = x + blk.ffn(h, cfg)[0]
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


def lm_loss(model: Transformer, batch, cfg: ModelConfig, ex):
    """-> (loss, {"ce", "aux"}): the mean cross-entropy of the logits
    against ``batch["labels"]`` (over ``batch["loss_mask"]`` where given),
    plus 0.01 x the aux loss (the reference's ``lm_loss``)."""
    x, aux = model.hidden(batch["tokens"], ex, batch.get("prefix_embeds"))
    ce = common.cross_entropy(model._unembed(x), batch["labels"],
                              logit_softcap=cfg.logit_softcap,
                              mask=batch.get("loss_mask"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def lm_init(cfg: ModelConfig, ex: common.ExecConfig, seed: int = 0
            ) -> Transformer:
    """Seeded random weights, made on ``ex.device`` in ``ex.param_dtype``.

    Linear weights are normal * in**-0.5 (an expert weight (E, in, out)
    too: its fan-in is also dim 1), the embedding normal * 0.02 and norm
    weights ones, as in the reference (whose jax.random draws differ).
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


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Cache positions for ``seq_len`` tokens: min(seq_len, window) for a
    rolling cache, else seq_len."""
    if attention.is_rolling(cfg.attn):
        return min(seq_len, cfg.attn.window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """Zeroed KV cache for ``seq_len`` positions, (L, B, Hkv, S, hd), S =
    ``cache_len(cfg, seq_len)``."""
    a = cfg.attn
    shape = (cfg.n_layers, batch, a.n_kv_heads, cache_len(cfg, seq_len),
             a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
