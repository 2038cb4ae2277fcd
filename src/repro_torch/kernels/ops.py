"""Public kernel API (counterpart of ``repro/kernels/ops.py``).

Each op dispatches on the device of its tensors: CPU tensors go to the
plain PyTorch version, CUDA tensors launch the hand-written kernel, which
raises on what it does not take.  Nothing routes a CUDA tensor to a
plain version.  Every op but ``decode_attention`` (torch ops throughout)
is a ``torch.autograd.Function`` whose forward is that dispatch and
whose backward is the reference's, the same code on both devices:
flash's from the saved o and lse; rmsnorm's and the SSD's recompute
through their plain versions and take its autograd; the gmm's dx is the
gmm itself (the kernel on the card) over the transposed experts.

A fake tensor (``FakeTensorMode``: the dry run, ``launch/dryrun.py``)
takes a branch of its own before either route, whatever its device: it
returns empty outputs of the kernel's shapes and dtypes and adds the
kernel's nominal operations and bytes (``kernels/cost.py``) to the
counts ``launch/hlo.py::counting_kernels`` made active.  A real tensor
never reaches it.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_plain as _fa_bwd
from repro_torch.kernels.flash_attention import \
    flash_attention_fwd as _fa_cuda
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as _fa_plain
from repro_torch.kernels.moe_gmm import check_args as _gmm_check
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm_cuda
from repro_torch.kernels.moe_gmm import moe_gmm_plain as _gmm_plain
from repro_torch.kernels.ref import NEG_INF, wide
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


def _is_fake(*tensors) -> bool:
    return any(isinstance(t, FakeTensor) for t in tensors)


def _count(kernel: str, work: tuple) -> None:
    """Add a fake call's work to the dry run's active kernel counts."""
    from repro_torch.launch.hlo import active_kernel_counts
    counts = active_kernel_counts()
    if counts is not None:
        counts.add(kernel, *work)


def _fa_forward(q, k, v, window, causal, softcap, scale, block):
    if _is_fake(q, k, v):
        (b, hq, sq, d), (hkv, sk) = q.shape, k.shape[1:3]
        _count("flash_attention_fwd", cost.flash_fwd_cost(
            b, hq, hkv, sq, sk, d, window, causal, q.element_size()))
        return torch.empty_like(q), q.new_empty((b, hq, sq),
                                                dtype=torch.float32)
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


def _plain_grads(f, inputs, needs, grad_outputs):
    """The gradients of ``f(*inputs)`` in the ``inputs`` that ``needs``
    marks (None for the others), by autograd through ``f`` (a plain
    version) recomputed here: the reference's VJP of a forward-only
    kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        diff = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], diff,
                                         [g for _, g in pairs],
                                         allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in leaves]


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with the reference's ``_rn`` VJP: the backward recomputes
    through ``rmsnorm_plain`` from the saved x and w (not the output)."""

    @staticmethod
    def forward(ctx, x, w, eps, weight_offset):
        ctx.save_for_backward(x, w)
        ctx.cfg = (eps, weight_offset)
        if _is_fake(x, w):
            d = x.shape[-1]
            _count("rmsnorm", cost.rmsnorm_cost(
                x.numel() // d if d else 0, d, x.element_size()))
            return torch.empty_like(x)
        if _is_cuda(x, w):
            return _rmsnorm_cuda(x, w, eps=eps, weight_offset=weight_offset)
        return _rmsnorm_plain(x, w, eps=eps, weight_offset=weight_offset)

    @staticmethod
    def backward(ctx, dy):
        eps, off = ctx.cfg
        dx, dw = _plain_grads(
            lambda x, w: _rmsnorm_plain(x, w, eps=eps, weight_offset=off),
            ctx.saved_tensors, ctx.needs_input_grad[:2], (dy,))
        return dx, dw, None, None


def rmsnorm(x, w, *, eps=1e-6, weight_offset=0.0):
    """RMSNorm over the last dim with float32 statistics, in x's dtype.
    x: (..., D); w: (D,).  Differentiable in x and w."""
    return _RMSNorm.apply(x, w, eps, weight_offset)


class _SSD(torch.autograd.Function):
    """The SSD with the reference's ``_ssd`` VJP: the backward recomputes
    the chunked plain formulation from the saved inputs and takes its
    autograd.  With ``return_state`` the state's gradient flows too
    (autograd through the plain version's final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, return_state):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.cfg = (chunk, return_state)
        ctx.set_materialize_grads(False)
        if _is_fake(x, dt, A, B, C):
            (bb, s, h, p), (g, n) = x.shape, B.shape[2:]
            _count("ssd_scan", cost.ssd_cost(
                bb, s, h, p, g, n, chunk, x.element_size(),
                dt.element_size(), return_state))
            y = torch.empty_like(x)
            return (y, x.new_empty((bb, h, p, n), dtype=torch.float32)) \
                if return_state else y
        if _is_cuda(x, dt, A, B, C):
            x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
            return _ssd_cuda(x, dt, A, B, C, chunk=chunk,
                             return_state=return_state)
        return _ssd_plain(x, dt, A, B, C, chunk=chunk,
                          return_state=return_state)

    @staticmethod
    def backward(ctx, dy, dstate=None):
        chunk, return_state = ctx.cfg
        grads = _plain_grads(
            lambda *t: _ssd_plain(*t, chunk=chunk, return_state=return_state),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (dy, dstate))
        return (*grads, None, None)


def ssd(x, dt, A, B, C, *, chunk=128, return_state=False):
    """Mamba2 SSD operator.  x: (Bb,S,H,P); dt: (Bb,S,H); A: (H,); B, C:
    (Bb,S,G,N) -> y (Bb,S,H,P) in x's dtype, or with ``return_state``
    (y, the final state (Bb,H,P,N) in float32).  The caller applies the
    D-skip.  ``chunk`` is cut to S, and S must be a multiple of it.
    Differentiable in x, dt, A, B and C, through y and the state."""
    s = x.shape[1]
    chunk = min(int(chunk), s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    return _SSD.apply(x, dt, A, B, C, chunk, return_state)


def _gmm_forward(x, w, block_group_ids, block_t):
    if _is_fake(x, w, block_group_ids):
        (t, k), (e, _, n) = x.shape, w.shape
        _count("moe_gmm",
               cost.gmm_cost(t, k, n, e, x.element_size()))
        return x.new_empty((t, n))
    if _is_cuda(x, w, block_group_ids):
        return _gmm_cuda(x, w, block_group_ids, block_t=block_t)
    return _gmm_plain(x, w, block_group_ids, block_t)


class _MoEGMM(torch.autograd.Function):
    """The grouped matmul with the gradient of its einsum form (the
    reference's MoE differentiates ``models/moe.py``'s einsums): dx is
    the gmm of dy over the experts' transposed weights (the kernel on
    the card: K and N are both multiples of 8), dw each expert's sum of
    x_block^T dy_block over its blocks, in float32; a block whose id is
    outside [0, E) adds to no expert.  Under fake tensors dw is an empty
    tensor of its shape and counts 2·T·K·N (its blocks are data)."""

    @staticmethod
    def forward(ctx, x, w, block_group_ids, block_t):
        ctx.save_for_backward(x, w, block_group_ids)
        ctx.block_t = block_t
        return _gmm_forward(x, w, block_group_ids, block_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, ids = ctx.saved_tensors
        bt = ctx.block_t
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm_forward(dy, w.transpose(1, 2).contiguous(), ids, bt)
        if ctx.needs_input_grad[1] and _is_fake(x, dy, w):
            (t, k), (e_n, _, n) = x.shape, w.shape
            _count("moe_gmm_dw",
                   cost.gmm_cost(t, k, n, e_n, x.element_size()))
            dw = torch.empty_like(w)
        elif ctx.needs_input_grad[1]:
            (e_n, k, n), acc = w.shape, wide(w).dtype
            dw = torch.zeros((e_n, k, n), dtype=acc, device=w.device)
            xb, dyb = x.view(-1, bt, k), dy.view(-1, bt, n)
            blocks = {}
            for i, e in enumerate(ids.tolist()):
                if 0 <= e < e_n:
                    blocks.setdefault(e, []).append(i)
            for e, idx in blocks.items():
                sel = torch.tensor(idx, device=x.device)
                dw[e] = (wide(xb[sel]).reshape(-1, k).T
                         @ wide(dyb[sel]).reshape(-1, n))
            dw = dw.to(w.dtype)
        return dx, dw, None, None


def moe_gmm(x, w, block_group_ids, *, block_t):
    """Grouped matmul over expert-sorted, block-padded rows.  x: (T, K);
    w: (E, K, N); block_group_ids: (T / block_t,) int32, the expert of each
    block of ``block_t`` rows -> (T, N) in x's dtype, summed in float32.
    The kernel's block-id layout is the one contract (the group-sizes form
    is a test oracle, ``ref.moe_gmm_ref``).  Ids outside [0, E) give NaN
    rows.  Differentiable in x and w."""
    if not _is_cuda(x, w, block_group_ids):
        _gmm_check(x, w, block_group_ids, block_t)
    return _MoEGMM.apply(x, w, block_group_ids, block_t)
