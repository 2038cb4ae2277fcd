"""Grouped matmul for MoE expert FFNs: the CUDA kernel's wrapper, its plain
version, its launch count.

The kernel (``csrc/moe_gmm.cu``) replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py::moe_gmm``, with the same contract: x (T, K)
holds tokens sorted by expert and padded so that every block of
``block_t`` rows belongs to one expert, ``block_group_ids`` (T / block_t,)
int32 names it, and w (E, K, N) holds the experts' weights.  The result
(T, N) is summed in float32 and returned in x's dtype.  ``moe_gmm``
launches a kernel on CUDA tensors only, the one ``kernel_for`` names;
``moe_gmm_plain`` is the same function in plain PyTorch, which the CPU
path and the comparisons on the card use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wide

DTYPES = (torch.float32, torch.bfloat16)
BLOCK_TS = (128, 64, 32, 16, 8)   # the kernels' row tiles, largest first
# The kernels of csrc/moe_gmm.cu, by the code its C entry takes.
KERNEL_CODES = {"fma": 0, "decode": 1, "wgmma": 2}

# Times moe_gmm has launched its kernel in this process.
launches = 0


def moe_gmm_plain(x, w, block_group_ids, block_t: int):
    """One float32 matmul per row block, with the expert its id names.  An
    id outside [0, E) names an expert of NaN weights: its rows are NaN, as
    the kernel's, and so is their gradient in x."""
    (t, k), (e_n, _, n) = x.shape, w.shape
    wf = wide(w)
    nan_w = torch.full((k, n), float("nan"), dtype=wf.dtype, device=w.device)
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    for i, e in enumerate(block_group_ids.tolist()):
        rows = slice(i * block_t, (i + 1) * block_t)
        out[rows] = (wide(x[rows]) @ (wf[e] if 0 <= e < e_n else nan_w)
                     ).to(x.dtype)
    return out


def check_args(x, w, block_group_ids, block_t: int) -> None:
    """Raise unless (x, w, block_group_ids, block_t) is a call the kernel
    takes: x (T, K), w (E, K, N) of one dtype (float32 or bfloat16),
    block_group_ids (T / block_t,) int32, block_t in BLOCK_TS, K and N
    multiples of 8 (the kernel's 16-byte copies)."""
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if block_group_ids.dtype != torch.int32:
        raise TypeError(f"block_group_ids must be int32, got "
                        f"{block_group_ids.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x: (T, K), w: (E, K, N); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if block_t not in BLOCK_TS:
        raise ValueError(f"block_t must be one of {BLOCK_TS}, got {block_t}")
    t, k = x.shape
    n = w.shape[2]
    if t % block_t or tuple(block_group_ids.shape) != (t // block_t,):
        raise ValueError(f"T={t} must be a multiple of block_t={block_t} "
                         f"and block_group_ids of shape ({t // block_t},), "
                         f"got {tuple(block_group_ids.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"K and N must be multiples of 8, got K={k}, N={n}")


def kernel_for(dtype, block_t: int) -> str:
    """The kernel a CUDA call of (dtype, block_t) launches: bfloat16 row
    tiles of 64 and 128 (prefill) on wgmma + TMA, smaller bfloat16 tiles
    on the decode kernel (persistent, TMA-fed, mma.sync), float32 on the
    FMA pipes."""
    if block_t not in BLOCK_TS:
        raise ValueError(f"block_t must be one of {BLOCK_TS}, got {block_t}")
    if dtype == torch.bfloat16:
        return "wgmma" if block_t >= 64 else "decode"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"moe_gmm takes float32 or bfloat16, got {dtype}")


@functools.cache
def _fn():
    fn = _build.load("moe_gmm").moe_gmm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm(x, w, block_group_ids, *, block_t: int):
    """Launch the kernel ``kernel_for`` names on contiguous CUDA tensors of
    one device (see ``check_args``; x, w 16-byte aligned).  Ids outside
    [0, E) give NaN rows."""
    global launches
    ts = (x, w, block_group_ids)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("moe_gmm takes x, w, block_group_ids on one CUDA "
                         "device")
    check_args(x, w, block_group_ids, block_t)
    kernel = KERNEL_CODES[kernel_for(x.dtype, block_t)]
    if not (all(t.is_contiguous() for t in ts)
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        raise ValueError("moe_gmm takes contiguous inputs, x and w 16-byte "
                         "aligned")
    (t, k), (e, _, n) = x.shape, w.shape
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), block_group_ids.data_ptr(),
                 out.data_ptr(), t, k, n, e, block_t, kernel,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    launches += 1
    return out
