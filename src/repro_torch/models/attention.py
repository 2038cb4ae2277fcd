"""Attention block: prefill (self- or cross-attention) and one-token
decode with a KV cache (counterpart of ``repro/models/attention.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels import ops
from repro_torch.models import common


class Attention(torch.nn.Module):
    def __init__(self, d_model, a: AttnConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"bias": False, "device": device, "dtype": dtype}
        self.wq = torch.nn.Linear(d_model, a.n_heads * a.head_dim, **kw)
        self.wk = torch.nn.Linear(d_model, a.n_kv_heads * a.head_dim, **kw)
        self.wv = torch.nn.Linear(d_model, a.n_kv_heads * a.head_dim, **kw)
        self.wo = torch.nn.Linear(a.n_heads * a.head_dim, d_model, **kw)
        if a.qk_norm:
            self.q_norm = torch.nn.Parameter(
                torch.empty(a.head_dim, device=device, dtype=dtype))
            self.k_norm = torch.nn.Parameter(
                torch.empty(a.head_dim, device=device, dtype=dtype))


def _project_qkv(attn: Attention, x, a: AttnConfig, rope, norm_eps):
    """x: (B, S, D_model) -> q (B,Hq,S,hd), k, v (B,Hkv,S,hd); rope = (cos,
    sin) of the S positions."""
    b, s, _ = x.shape
    q = attn.wq(x).view(b, s, a.n_heads, a.head_dim)
    k = attn.wk(x).view(b, s, a.n_kv_heads, a.head_dim)
    v = attn.wv(x).view(b, s, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = common.norm(q, attn.q_norm, norm_eps)
        k = common.norm(k, attn.k_norm, norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q = common.apply_rope(q, *rope)
    k = common.apply_rope(k, *rope)
    return q, k, v


def layer_window(a: AttnConfig, is_global: bool):
    """Window of a layer: None (full) or an int.  A uniform window
    (``local_global_period == 0``, mixtral) holds in every layer.  Layers
    are a Python loop here, so every window is static."""
    if a.window is None:
        return None
    if a.local_global_period == 0:
        return int(a.window)
    return None if is_global else int(a.window)


def is_rolling(a: AttnConfig) -> bool:
    """A uniform window keeps a rolling KV cache of ``window`` positions."""
    return bool(a.window) and a.local_global_period == 0


def attn_train(attn: Attention, x, a: AttnConfig, *, window, norm_eps, rope,
               ex, causal=True, kv_source=None):
    """Full-sequence attention (prefill, encoder, cross-attention).

    ``kv_source``: None for self-attention (rope on q and k, the causal
    flag and the window as given); else (B, Sk, D_model), the source K and
    V are projected from: cross-attention, with no rope, no mask and no
    window (Whisper's decoder over the encoder output; ``rope`` is unused).
    Returns (out, (k, v)) with k/v in the cache layout (B,Hkv,S or Sk,hd).
    """
    b, s, _ = x.shape
    if kv_source is None:
        q, k, v = _project_qkv(attn, x, a, rope, norm_eps)
    else:
        sk = kv_source.shape[1]
        q = attn.wq(x).view(b, s, a.n_heads, a.head_dim).transpose(1, 2)
        k = attn.wk(kv_source).view(b, sk, a.n_kv_heads, a.head_dim)
        v = attn.wv(kv_source).view(b, sk, a.n_kv_heads, a.head_dim)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        window, causal = None, False
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = ops.flash_attention(q, k, v, window=window, causal=causal,
                            softcap=a.attn_softcap, block=ex.attn_block)
    out = o.transpose(1, 2).reshape(b, s, a.n_heads * a.head_dim)
    return attn.wo(out), (k, v)


def attn_decode(attn: Attention, x, cache_k, cache_v, pos: int,
                a: AttnConfig, *, window, norm_eps, rope, rolling=False):
    """One-token decode.  x: (B,1,D_model); caches: (B,Hkv,Smax,hd).

    pos: index of the new token.  The new K/V are written into the caches
    in place (the reference returns updated copies).  ``rolling``: the
    cache is a rolling buffer, written at ``pos % Smax`` and read whole
    once full, with no window (the reference's mixtral path; its slots
    agree with prefill's only when the prompt is a multiple of the window,
    ROADMAP C7).
    """
    b = x.shape[0]
    smax = cache_k.shape[2]
    q, k, v = _project_qkv(attn, x, a, rope, norm_eps)
    slot = pos % smax if rolling else pos
    cache_k[:, :, slot] = k[:, :, 0]
    cache_v[:, :, slot] = v[:, :, 0]
    if rolling:
        # every slot is within the window; mask only unfilled slots
        pos, window = min(pos, smax - 1), None
    o = ops.decode_attention(q, cache_k, cache_v, pos, window=window,
                             softcap=a.attn_softcap)
    out = o.transpose(1, 2).reshape(b, 1, a.n_heads * a.head_dim)
    return attn.wo(out)


def cross_decode(attn: Attention, x, cross_k, cross_v, a: AttnConfig):
    """One-token cross-attention over the cached cross K/V (B,Hkv,Sk,hd),
    projected once in prefill: the decode attention at pos = Sk - 1, which
    sees every key.  x: (B,1,D_model)."""
    b = x.shape[0]
    q = attn.wq(x).view(b, 1, a.n_heads, a.head_dim).transpose(1, 2)
    o = ops.decode_attention(q, cross_k, cross_v, cross_k.shape[2] - 1,
                             softcap=a.attn_softcap)
    out = o.transpose(1, 2).reshape(b, 1, a.n_heads * a.head_dim)
    return attn.wo(out)
