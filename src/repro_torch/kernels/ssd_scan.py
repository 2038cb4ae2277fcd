"""Mamba2 SSD chunked scan: the CUDA kernels' wrapper, its plain version,
its launch count.

The kernels (``csrc/ssd_scan.cu``) replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``: bfloat16 runs on the tensor
cores, split into chunk state, state passing and chunk scan (three
launches, with a workspace the wrapper allocates), float32 on one FMA
kernel.  ``ssd_scan`` launches them on CUDA tensors only; ``ssd_plain``
is the same function in plain PyTorch (``ref.ssd_chunked_ref``), which
the CPU path and the comparisons on the card use.  Both take x (Bb, S, H,
P), dt (Bb, S, H), A (H,) and B, C (Bb, S, G, N) and return y (Bb, S, H,
P) in x's dtype, no D-skip, and with ``return_state=True`` also the
final state (Bb, H, P, N) in float32, the state after the last chunk.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448   # what one block may opt into on sm_90
MAX_Y_TILES = 512         # fp32: 256 threads x two 4x4 y tiles: Q*P <= 8192
MAX_N_BF16 = 128          # bf16: N in at most eight k16 steps of mma.sync

# Kernels ssd_scan has launched on the card: three a call in bf16 with more
# than one chunk or with the final state (chunk state, state passing,
# chunk scan; these calls alone take a workspace), else one.
launches = 0


def ssd_plain(x, dt, A, B, C, *, chunk, return_state=False):
    y, state = ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)
    return (y, state) if return_state else y


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def _bf16_n_width(n: int) -> int:
    """N as the bf16 kernels hold it: zeros up to 16, 32, 64 or 128."""
    return next((w for w in (16, 32, 64, 128) if n <= w), _ceil(n, 16))


def smem_bytes(chunk: int, p: int, n: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block: for float32 the FMA kernel's
    ``layout``; for bfloat16 the larger of the chunk-state and chunk-scan
    kernels' parts of ``tc_layout``."""
    if dtype == torch.bfloat16:
        qp, pp = _ceil(chunk, 16), _ceil(p, 16)
        ldn, ldp = _bf16_n_width(n) + 8, pp + 8
        shared = qp * ldn + qp * ldp            # B, x
        state = shared + qp * ldp               # x o w as hi + lo
        scan = shared + 2 * pp * ldn            # the state as hi + lo
        return 2 * max(state, scan) + 8 * qp    # + L, dt in fp32
    qp = _ceil(chunk, 4)
    qs = qp + 4
    floats = qp * p + 2 * n * qs + n * p + 32 * qs + 2 * qs
    return 4 * floats


def kernel_fits(chunk: int, p: int, n: int,
                dtype: torch.dtype = torch.float32) -> bool:
    """The kernels of ``dtype`` run (chunk, P, N): float32's block holds
    them in its shared memory and two 4x4 tiles of y a thread; bfloat16's
    blocks hold them in shared memory with N <= 128."""
    if dtype == torch.bfloat16:
        return (n <= MAX_N_BF16
                and smem_bytes(chunk, p, n, dtype) <= MAX_SMEM_BYTES)
    qp = _ceil(chunk, 4)
    return (smem_bytes(chunk, p, n) <= MAX_SMEM_BYTES
            and (qp // 4) * (p // 4) <= MAX_Y_TILES)


@functools.cache
def _lib():
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 8
    lib.ssd_scan_workspace_bytes.restype = ctypes.c_longlong
    return lib


def workspace_bytes(x: torch.Tensor, B: torch.Tensor, *, chunk: int,
                    return_state: bool = False) -> int:
    """Bytes of workspace one call takes (the bf16 kernels' S_c of all
    chunks but the last, which the state passing overwrites with the
    carried states, and exp(L_Q) of those chunks, or of all of them with
    the final state; 0 in fp32, or with one chunk and no state)."""
    bb, s, h, p = x.shape
    return int(_lib().ssd_scan_workspace_bytes(
        bb, s, h, p, B.shape[3], int(chunk), DTYPE_CODES[x.dtype],
        int(return_state)))


def ssd_scan(x, dt, A, B, C, *, chunk, return_state=False):
    """Launch the kernel.  x, B, C: contiguous float32 or bfloat16 CUDA
    tensors of one dtype; dt, A: float32; S % chunk == 0, H % G == 0, P and
    N multiples of 8, and (chunk, P, N) within one block's shared memory.
    Returns y, or (y, the final state (Bb, H, P, N) float32) with
    ``return_state``: a tensor of its own, not a view of the workspace."""
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
    if not kernel_fits(chunk, p, n, x.dtype):
        raise ValueError(f"chunk={chunk}, P={p}, N={n} do not fit one "
                         f"block ({smem_bytes(chunk, p, n, x.dtype)} B of "
                         f"shared memory)")
    if not (all(t.is_contiguous() for t in ts)
            and all(t.data_ptr() % 16 == 0 for t in (x, B, C))):
        raise ValueError("ssd_scan takes contiguous inputs, x, B and C "
                         "16-byte aligned")
    y = torch.empty_like(x)
    if y.numel() == 0:   # nothing launches; an empty sequence's state is 0
        return ((y, torch.zeros((bb, h, p, n), dtype=torch.float32,
                                device=x.device)) if return_state else y)
    state = (torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    ws = torch.empty(workspace_bytes(x, B, chunk=chunk,
                                     return_state=return_state),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(),
            state.data_ptr() if return_state else None,
            ws.data_ptr() if ws.numel() else None,
            bb, s, h, p, g, n, chunk, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 3 if ws.numel() else 1
    return (y, state) if return_state else y
