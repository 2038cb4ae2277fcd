"""Flash-attention forward: the CUDA kernel's wrapper, its plain version,
its launch count.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``.  The wrapper
keeps that name: ``flash_attention_fwd`` launches the kernel on CUDA
tensors only (bfloat16 on the tensor cores through wgmma and TMA, float32
on the FMA pipes); ``flash_attention_plain`` is the same function in plain
PyTorch, which the CPU path and the comparisons on the card use.  Both
take q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D) and return
(o (B, Hq, Sq, D) in q.dtype, lse (B, Hq, Sq) in float32, natural log).
At Sq != Sk (cross-attention) q holds the last Sq of the Sk positions, as
in the reference: query i sits at position i + Sk - Sq, which the causal
mask and the window measure from.  A causal mask needs Sq <= Sk, so that
every query row keeps a key.
``flash_attention_bwd_plain`` is the gradient from the saved o and lse,
in torch ops on either device (the reference has no Pallas backward).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# "no window" is passed as Sk + KERNEL_BLOCK: wider than any row-key distance
KERNEL_BLOCK = 64
# widths each dtype's kernel is instantiated at; head_dim d runs at the
# smallest that holds it, with zeros past d (the bf16 kernel's tiles are
# 64-column swizzled slabs)
KERNEL_HEAD_DIMS = {torch.float32: (16, 32, 64, 128, 256),
                    torch.bfloat16: (64, 128, 256)}

# Times flash_attention_fwd has launched its kernel in this process.
launches = 0


def kernel_head_dim(d: int, dtype=torch.float32) -> int:
    """The width head_dim ``d`` runs at in ``dtype``'s kernel; raises if
    it takes none."""
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, "
                         f"{MAX_HEAD_DIM}], got {d}")
    return next(w for w in KERNEL_HEAD_DIMS[dtype] if w >= d)


def check_shapes(q, k, v, causal):
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) of one shape, Hq a
    multiple of Hkv, and Sq <= Sk under a causal mask; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) of one "
                         f"shape, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q and k differ in batch or head_dim: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq must be a multiple of Hkv, got Hq={hq}, "
                         f"Hkv={hkv}")
    if causal and sq > sk:
        raise ValueError(f"a causal mask needs Sq <= Sk (q holds the last "
                         f"Sq of the Sk positions), got Sq={sq}, Sk={sk}")


def _check_window(window, s, block):
    """None means "never limits" (Sk + block, as the Pallas kernel)."""
    if window is None:
        return s + block
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return min(window, s + block)   # wider never limits; fits a C int


def flash_attention_plain(q, k, v, window=None, *, causal=True, softcap=0.0,
                          scale=None, block=128):
    """The kernel's function in plain PyTorch: the online softmax over
    ``block``-key tiles, in float32, with the kernel's masking."""
    check_shapes(q, k, v, causal)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    win = _check_window(window, sk, block)
    group = hq // hkv
    qf = q.float()
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block):
        kb = k[:, :, k0:k0 + block].float().repeat_interleave(group, dim=1)
        vb = v[:, :, k0:k0 + block].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        cols = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = (rows - cols) < win
        if causal:
            mask &= cols <= rows
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    lsafe = torch.where(l == 0.0, 1.0, l)
    return (acc / lsafe[..., None]).to(q.dtype), m + torch.log(lsafe)


def _pick_block(s: int, want: int) -> int:
    """Largest divisor of s that is <= want (handles S like 1500)."""
    b = min(want, s)
    while s % b:
        b -= 1
    return b


def flash_attention_bwd_plain(q, k, v, o, lse, do, window=None, *,
                              causal=True, softcap=0.0, scale=None,
                              block=128):
    """The forward's gradient in plain PyTorch, from its saved o and lse:
    one pass over query blocks of ``block`` rows, with dk and dv summed
    over the blocks and over each GQA head group, in float32 (the
    reference's ``_fa_bwd_xla``).  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    bq = _pick_block(sq, block)
    win = sk + bq if window is None else int(window)
    kf = k.float().repeat_interleave(group, dim=1)     # (b, hq, sk, d)
    vf = v.float().repeat_interleave(group, dim=1)
    cols = torch.arange(sk, device=q.device)[None, :]
    # delta_i = rowsum(dO * O)
    delta = (do.float() * o.float()).sum(-1)
    dk = torch.zeros((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq_blocks = []
    for q0 in range(0, sq, bq):
        qb = q[:, :, q0:q0 + bq].float()
        dob = do[:, :, q0:q0 + bq].float()
        s_raw = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        if softcap:
            t = torch.tanh(s_raw / softcap)
            s = softcap * t
            dcap = 1.0 - t * t
        else:
            s, dcap = s_raw, None
        rows = q0 + torch.arange(bq, device=q.device)[:, None] + (sk - sq)
        mask = (rows - cols) < win
        if causal:
            mask &= cols <= rows
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q0 + bq, None])
        dv_q = torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vf)
        ds = p * (dp - delta[:, :, q0:q0 + bq, None])
        if dcap is not None:
            ds = ds * dcap
        ds = torch.where(mask[None, None], ds, 0.0) * scale
        dq_blocks.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf))
        dk_q = torch.einsum("bhqk,bhqd->bhkd", ds, qb)
        # GQA: sum gradients over the head group
        dk = dk + dk_q.reshape(b, hkv, group, sk, d).sum(2)
        dv = dv + dv_q.reshape(b, hkv, group, sk, d).sum(2)
    dq = torch.cat(dq_blocks, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, window=None, *, causal=True, softcap=0.0,
                        scale=None):
    """Launch the kernel.  q, k, v: contiguous float32 or bfloat16 CUDA
    tensors of one dtype, head_dim a multiple of 8 up to 256, Hq % Hkv ==
    0, Sq <= Sk under a causal mask."""
    global launches
    check_shapes(q, k, v, causal)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    win = _check_window(window, sk, KERNEL_BLOCK)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_fwd takes q, k, v on one CUDA "
                         "device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    kernel_head_dim(d, q.dtype)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_fwd takes contiguous, 16-byte "
                         "aligned q, k, v")
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _fn()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, hq, hkv, sq, sk, d, win,
                 int(bool(causal)), float(softcap), float(scale),
                 DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return o, lse
