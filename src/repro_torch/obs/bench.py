"""Shared timing for the port's kernel measurements.

``time_fn`` is the timer of the profiling harness
(``repro_torch.obs.profile``, behind ``cli calibrate``).  The reference's
bench floors, its ``measure_*`` workloads and ``cli bench`` belong to its
``BENCH_*.json`` files, whose floors were measured on a CPU against the
reference; they are not part of the port.
"""
from __future__ import annotations

import time

import torch

# written before each timed call on the card: more than the H100's 50 MB
# of L2, so every call reads its inputs from HBM, and long enough on the
# card (~0.1 ms) for the host to queue the call behind it
_FLUSH_BYTES = 256 << 20


def _card(args):
    return next((a.device for a in args
                 if isinstance(a, torch.Tensor) and a.is_cuda), None)


def time_fn(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best-of-``reps`` seconds per ``fn(*args)`` call after ``warmup``
    untimed calls (a kernel's first call builds and loads it).

    On the CPU it is the call's wall time.  When any argument is a CUDA
    tensor it is the call's time on the card's stream, between two CUDA
    events: each timed call is queued behind a write of a buffer larger
    than L2, so its inputs come from HBM and the host's launch of its
    first kernel is hidden; a call whose host side is slower than its
    kernels still shows the gaps between them.
    """
    for _ in range(max(int(warmup), 0)):
        fn(*args)
    reps = max(int(reps), 1)
    dev = _card(args)
    if dev is None:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=dev)
        events = []
        torch.cuda.synchronize()
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return min(s.elapsed_time(e) for s, e in events) / 1e3
