"""The pipeline wavefront: the CUDA kernel's wrapper, its plain version,
its launch count.

The kernel (``csrc/wavefront.cu``) replaces the reference's jitted,
trace-time-unrolled wavefront (``repro/events/batch.py::_jax_shape_fn``,
a jitted array program rather than a Pallas kernel).  It computes the
level recurrence of ``_wavefront_numpy`` and the ``replay_rows``
epilogue for K records in one launch, mixed shape keys included.

``wavefront`` launches the kernel on CUDA tensors and runs
``wavefront_plain``, the same function in plain PyTorch, on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Times wavefront has launched its kernel in this process.
launches = 0

# Rows of the (6, K) input and the (5, K) output.
ROW_KEYS = ("tau_f", "tau_b", "t_dp", "credit", "nmv", "analytic")
RES_KEYS = ("step_time", "makespan_body", "bubble", "dp_exposed", "err")

MAX_STAGES = 1024        # one thread a stage; past 32, a block a record


@functools.cache
def _fn():
    fn = _build.load("wavefront").wavefront_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def shared_bytes(S: int, L: int) -> int:
    """Dynamic shared memory of one record that keeps its history there
    (the kernel's own layout; builds the kernel)."""
    fn = _build.load("wavefront").wavefront_shared_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(S, L))


def check_args(ldir, ldep_s, ldep_l, key_rows, rows) -> None:
    """Tables (U, S, L) int32, ``key_rows`` (K,) integer indices into U,
    ``rows`` (6, K) float64, all on one device."""
    tabs = (ldir, ldep_s, ldep_l)
    if any(t.dtype != torch.int32 or t.dim() != 3 for t in tabs):
        raise TypeError("the tables are (U, S, L) int32 tensors")
    if not (ldir.shape == ldep_s.shape == ldep_l.shape):
        raise ValueError(f"the tables differ in shape: {ldir.shape}, "
                         f"{ldep_s.shape}, {ldep_l.shape}")
    if rows.dtype != torch.float64 or rows.dim() != 2 \
            or rows.shape[0] != len(ROW_KEYS):
        raise ValueError(f"rows must be ({len(ROW_KEYS)}, K) float64, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if key_rows.dim() != 1 or key_rows.shape[0] != rows.shape[1] \
            or key_rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"key_rows must be ({rows.shape[1]},) int32 or "
                         f"int64, got {tuple(key_rows.shape)} "
                         f"{key_rows.dtype}")
    if len({t.device for t in (*tabs, key_rows, rows)}) != 1:
        raise ValueError("the wavefront takes all its tensors on one device")


def pack_codes(ldir, ldep_s, ldep_l) -> torch.Tensor:
    """The level codes the kernel's first pass packs, once a launch, in
    plain PyTorch: (U, L, S) int32, level-major; -1 where stage s is idle
    at level lv, else ``((dep + 1) << 1) | dir`` with ``dep = ldep_l * S +
    ldep_s`` the dependency's place in a level-major (L, S) history, or -1
    where the op has none."""
    S = ldir.shape[1]
    d, ds, dl = (t.transpose(1, 2).long() for t in (ldir, ldep_s, ldep_l))
    dep1 = torch.where(ds >= 0, dl * S + ds + 1, 0)
    return torch.where(d < 0, -1, (dep1 << 1) | d).to(torch.int32)


def wavefront_plain(ldir, ldep_s, ldep_l, key_rows, rows) -> torch.Tensor:
    """(5, K) float64 ``RES_KEYS`` rows: ``_wavefront_numpy``'s level loop
    over the per-record tables, then the ``replay_rows`` epilogue, in
    plain PyTorch on the tensors' device."""
    idx = key_rows.long()
    dirs, dep_s, dep_l = ldir[idx].long(), ldep_s[idx].long(), \
        ldep_l[idx].long()
    K, S, L = dirs.shape
    tau_f, tau_b, t_dp, credit, nmv, analytic = rows
    hist = torch.zeros((K, S, L), dtype=torch.float64, device=rows.device)
    dev_end = torch.zeros((K, S), dtype=torch.float64, device=rows.device)
    kk = torch.arange(K, device=rows.device)[:, None]
    tf = tau_f[:, None]
    tb = tau_b[:, None]
    for lv in range(L):
        d = dirs[:, :, lv]
        act = d >= 0
        ds = dep_s[:, :, lv]
        has = ds >= 0
        dep = torch.where(
            has,
            hist[kk, torch.where(has, ds, 0),
                 torch.where(has, dep_l[:, :, lv], 0)],
            0.0)
        tau = torch.where(d == 0, tf, tb)
        val = torch.maximum(dev_end, dep) + tau
        hist[:, :, lv] = torch.where(act, val, 0.0)
        dev_end = torch.where(act, val, dev_end)
    body = dev_end.amax(dim=1)

    busy = nmv * (tau_f + tau_b)
    bubble = torch.where(busy > 0, body / busy - 1.0, 0.0)
    dp_exposed = torch.clamp(t_dp - credit, min=0.0)
    dp_exposed = torch.where(t_dp > 0, dp_exposed, 0.0)
    step_time = body + dp_exposed
    err = (step_time - analytic) / analytic
    return torch.stack((step_time, body, bubble, dp_exposed, err))


def wavefront(ldir, ldep_s, ldep_l, key_rows, rows) -> torch.Tensor:
    """(5, K) float64 ``RES_KEYS`` rows for K records.

    ``ldir``, ``ldep_s``, ``ldep_l``: the (U, S, L) int32 level tables of
    the batch's unique shape keys (``events.batch._shape_tables``, padded
    with -1); ``key_rows``: each record's index into U; ``rows``: the
    (6, K) float64 ``ROW_KEYS`` matrix.  CUDA tensors launch the kernel on
    the current stream, where a key index outside [0, U) gives a NaN
    column; CPU tensors take ``wavefront_plain``, where it raises."""
    global launches
    check_args(ldir, ldep_s, ldep_l, key_rows, rows)
    if rows.device.type == "cpu":
        if key_rows.numel() and (int(key_rows.min()) < 0
                                 or int(key_rows.max()) >= ldir.shape[0]):
            raise IndexError(f"key_rows outside [0, {ldir.shape[0]})")
        return wavefront_plain(ldir, ldep_s, ldep_l, key_rows, rows)
    if not rows.is_cuda:
        raise ValueError(f"wavefront runs on CUDA or CPU tensors, got "
                         f"{rows.device}")
    U, S, L = ldir.shape
    K = rows.shape[1]
    if S > MAX_STAGES or S * L >= 1 << 30:
        raise ValueError(f"wavefront takes at most {MAX_STAGES} stages and "
                         f"fewer than 2**30 (stage, level) cells, got "
                         f"S {S}, L {L}")
    tabs = [t.contiguous() for t in (ldir, ldep_s, ldep_l)]
    keys = key_rows.to(torch.int32).contiguous()
    rows = rows.contiguous()
    out = torch.empty((len(RES_KEYS), K), dtype=torch.float64,
                      device=rows.device)
    if K == 0:
        return out
    limit = torch.cuda.get_device_properties(
        rows.device).shared_memory_per_block_optin
    # the keys' packed level codes, once a launch
    code = torch.empty((U, L, S), dtype=torch.int32, device=rows.device)
    hist = None
    if shared_bytes(S, L) > limit:      # the history in device memory
        hist = torch.empty((K, L, S), dtype=torch.float64,
                           device=rows.device)
    fn = _fn()
    with torch.cuda.device(rows.device):
        err = fn(*(t.data_ptr() for t in tabs), keys.data_ptr(),
                 rows.data_ptr(), out.data_ptr(),
                 None if hist is None else hist.data_ptr(), code.data_ptr(),
                 K, U, S, L, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
