"""RMSNorm: the CUDA kernel's wrapper, its plain version, its launch count.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm``.  ``rmsnorm`` launches it on
CUDA tensors only; ``rmsnorm_plain`` is the same function in plain
PyTorch, which the CPU path and the comparisons on the card use.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Times rmsnorm has launched its kernel in this process.
launches = 0

rmsnorm_plain = rmsnorm_ref


@functools.cache
def _fn():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                 weight_offset: float = 0.0) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16 on a CUDA device; w: (D,), x.dtype."""
    global launches
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("rmsnorm takes x and w on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and w of "
                        f"x's dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"w must have shape ({d},), got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous x and w")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    vec = int(d % (16 // x.element_size()) == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w, out)))
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), float(weight_offset), DTYPE_CODES[x.dtype], vec,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return out
