"""Public kernel API (counterpart of ``repro/kernels/ops.py``).

Each op dispatches on the device of its tensors: CPU tensors go to the
plain PyTorch version, CUDA tensors launch the hand-written kernel, which
raises on what it does not take.  Nothing routes a CUDA tensor to a
plain version.  ``flash_attention`` is differentiable: its forward (the
kernel or plain version) saves o and lse and its backward is torch ops
(the reference's custom VJP); the other ops are forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_plain as _fa_bwd
from repro_torch.kernels.flash_attention import \
    flash_attention_fwd as _fa_cuda
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as _fa_plain
from repro_torch.kernels.moe_gmm import check_args as _gmm_check
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm_cuda
from repro_torch.kernels.moe_gmm import moe_gmm_plain as _gmm_plain
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_plain as _rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_plain as _ssd_plain
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_cuda


def _is_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU, got "
                     f"{sorted(kinds)}")


def _fa_forward(q, k, v, window, causal, softcap, scale, block):
    if _is_cuda(q, k, v):
        return _fa_cuda(q, k, v, window, causal=causal, softcap=softcap,
                        scale=scale)
    return _fa_plain(q, k, v, window, causal=causal, softcap=softcap,
                     scale=scale, block=block)


class _FlashAttention(torch.autograd.Function):
    """The forward of ``flash_attention`` with the reference's custom
    VJP: the backward reads the forward's o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, softcap, scale, block):
        o, lse = _fa_forward(q, k, v, window, causal, softcap, scale, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (window, causal, softcap, scale, block)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window, causal, softcap, scale, block = ctx.cfg
        dq, dk, dv = _fa_bwd(q, k, v, o, lse, do.contiguous(), window,
                             causal=causal, softcap=softcap, scale=scale,
                             block=block)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, window=None, causal=True, softcap=0.0,
                    scale=None, block=128):
    """Attention.  q: (B,Hq,Sq,D); k/v: (B,Hkv,Sk,D) -> o (B,Hq,Sq,D).

    Sq == Sk is self-attention; at Sq != Sk (cross-attention) q holds the
    last Sq of the Sk positions, as in the reference, and a causal mask
    needs Sq <= Sk.  ``window``: None (full) or an int >= 1.  ``block``
    is the key tile of the plain version and the query tile of the
    backward; the kernel's tiles are fixed.  Differentiable in q, k and v.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, window, causal, softcap, scale,
                                 block)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, softcap=0.0,
                     scale=None):
    """Single-token decode attention, plain PyTorch on every device.

    q: (B,Hq,1,D); caches: (B,Hkv,Smax,D); pos: int, the number of tokens
    already in the cache (the new token attends to cache[0..pos]).
    Window masks cache entries older than ``window``.  The reference has
    no Pallas kernel here: one pass over the cache is memory-bound.
    """
    b, hq, _, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(smax, device=q.device)
    mask = cols <= pos
    if window is not None:
        mask &= cols > pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)


def rmsnorm(x, w, *, eps=1e-6, weight_offset=0.0):
    if _is_cuda(x, w):
        return _rmsnorm_cuda(x, w, eps=eps, weight_offset=weight_offset)
    return _rmsnorm_plain(x, w, eps=eps, weight_offset=weight_offset)


def ssd(x, dt, A, B, C, *, chunk=128, return_state=False):
    """Mamba2 SSD operator.  x: (Bb,S,H,P); dt: (Bb,S,H); A: (H,); B, C:
    (Bb,S,G,N) -> y (Bb,S,H,P) in x's dtype, or with ``return_state``
    (y, the final state (Bb,H,P,N) in float32).  The caller applies the
    D-skip.  ``chunk`` is cut to S, and S must be a multiple of it."""
    s = x.shape[1]
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if _is_cuda(x, dt, A, B, C):
        return _ssd_cuda(x, dt, A, B, C, chunk=chunk,
                         return_state=return_state)
    return _ssd_plain(x, dt, A, B, C, chunk=chunk, return_state=return_state)


def moe_gmm(x, w, block_group_ids, *, block_t):
    """Grouped matmul over expert-sorted, block-padded rows.  x: (T, K);
    w: (E, K, N); block_group_ids: (T / block_t,) int32, the expert of each
    block of ``block_t`` rows -> (T, N) in x's dtype, summed in float32.
    The kernel's block-id layout is the one contract (the group-sizes form
    is a test oracle, ``ref.moe_gmm_ref``)."""
    if _is_cuda(x, w, block_group_ids):
        return _gmm_cuda(x, w, block_group_ids, block_t=block_t)
    _gmm_check(x, w, block_group_ids, block_t)
    return _gmm_plain(x, w, block_group_ids, block_t)
