"""Dense PyTorch oracles for the ported kernels (counterpart of
``repro/kernels/ref.py``): the CPU path of the model zoo and the ground
truth the kernels are held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                  scale=None):
    """Dense reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  GQA via head repetition.
    ``window``: keys with row-col >= window are masked.  Causal assumes
    Sq == Sk or q occupies the LAST Sq positions of the Sk key range.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def rmsnorm_ref(x, w, *, eps=1e-6, weight_offset=0.0):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (weight_offset + w.float())
    return y.to(x.dtype)
