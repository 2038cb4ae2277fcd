"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper, its plain version,
its launch count.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``.  ``ssd_scan`` launches it on
CUDA tensors only; ``ssd_plain`` is the same function in plain PyTorch
(``ref.ssd_chunked_ref``), which the CPU path and the comparisons on the
card use.  Both take x (Bb, S, H, P), dt (Bb, S, H), A (H,) and B, C
(Bb, S, G, N) and return y (Bb, S, H, P) in x's dtype: no D-skip, no
final state.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448   # what one block may opt into on sm_90
MAX_Y_TILES = 512         # 256 threads x two 4x4 tiles of y: Q * P <= 8192

# Times ssd_scan has launched its kernel in this process.
launches = 0


def ssd_plain(x, dt, A, B, C, *, chunk):
    return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)[0]


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of one block (the kernel's ``layout``, in bytes)."""
    qp = -(-chunk // 4) * 4
    qs = qp + 4
    floats = qp * p + 2 * n * qs + n * p + 32 * qs + 2 * qs
    return 4 * floats


def kernel_fits(chunk: int, p: int, n: int) -> bool:
    """One block holds (chunk, P, N): its shared memory, and two 4x4 tiles
    of y a thread."""
    qp = -(-chunk // 4) * 4
    return (smem_bytes(chunk, p, n) <= MAX_SMEM_BYTES
            and (qp // 4) * (p // 4) <= MAX_Y_TILES)


@functools.cache
def _fn():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, A, B, C, *, chunk):
    """Launch the kernel.  x, B, C: contiguous float32 or bfloat16 CUDA
    tensors of one dtype; dt, A: float32; S % chunk == 0, H % G == 0, P and
    N multiples of 8, and (chunk, P, N) within one block's shared memory."""
    global launches
    ts = (x, dt, A, B, C)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_scan takes x, dt, A, B, C on one CUDA device")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B, C of one "
                        f"dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError("x: (Bb, S, H, P); B, C: (Bb, S, G, N)")
    bb, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (bb, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape[:2]) != (bb, s)):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    chunk = int(chunk)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if g < 1 or h % g or p % 8 or n % 8:
        raise ValueError(f"need H % G == 0 and P, N multiples of 8, got "
                         f"H={h}, G={g}, P={p}, N={n}")
    if not kernel_fits(chunk, p, n):
        raise ValueError(f"chunk={chunk}, P={p}, N={n} do not fit one "
                         f"block ({smem_bytes(chunk, p, n)} B of shared "
                         f"memory)")
    if not (all(t.is_contiguous() for t in ts)
            and all(t.data_ptr() % 16 == 0 for t in (x, B, C))):
        raise ValueError("ssd_scan takes contiguous inputs, x, B and C "
                         "16-byte aligned")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), bb, s, h, p, g, n, chunk,
                 DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y
