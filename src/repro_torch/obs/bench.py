"""Shared timing for the port's kernel measurements, and the pipelined
step programs of a study.

``time_fn`` is the timer of the profiling harness
(``repro_torch.obs.profile``, behind ``cli calibrate``);
``pipelined_records`` picks a study's top records with a pipeline, the
rows ``cli timeline`` replays and the card's wavefront is held against.  The reference's bench floors,
its ``measure_*`` workloads and ``cli bench`` belong to its
``BENCH_*.json`` files, whose floors were measured on a CPU against the
reference; they are not part of the port.
"""
from __future__ import annotations

import time
from typing import List, Tuple

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


def pipelined_records(sc, res, top: int = 8) -> Tuple[object, object, List]:
    """``(w, hw, records)`` of one study's result ``res``: its top
    ``top`` records with a pipeline (pp > 1), deepest first (``pp *
    n_micro``), each ``(strategy, mcm, topo, fabric)``.  A pp = 1 record
    compiles to a two-node program, so where fewer than half the top
    records have a pipeline the best feasible pp > 1 strategies on the
    winning MCM follow them, by throughput (topo None: the compiler
    derives it), as the reference's ``top_record_batch`` builds them.
    Where there is none, the top records themselves."""
    from repro_torch.core.optimizer import enumerate_strategies
    from repro_torch.core.simulator import simulate
    from repro_torch.events.validate import _rebuild, _top_records
    w, hw = sc.build_workload(), sc.build_hw()
    recs = [_rebuild(res.records[i], sc, hw=hw)
            for i in _top_records(res, top)]
    piped = sorted((r for r in recs if r[0].pp > 1),
                   key=lambda r: -(r[0].pp * max(r[0].n_micro, 1)))
    if len(piped) < max(2, top // 2):
        _, mcm, _, fabric = recs[0]
        cand = []
        for s in enumerate_strategies(w, mcm):
            if s.pp > 1:
                r = simulate(w, s, mcm, hw=hw)
                if r.feasible:
                    cand.append((r.throughput, s))
        cand.sort(key=lambda c: -c[0])
        piped += [(s, mcm, None, fabric) for _, s in cand[:top - len(piped)]]
    return w, hw, piped or recs


def pipelined_programs(sc, schedule: str = "1f1b", top: int = 8,
                       device="cuda"):
    """The PIPELINED ``StepProgram`` of one study (run on ``device``)
    that ``cli timeline`` replays: the first of ``pipelined_records``,
    the deepest top record with a pipeline, else the best feasible
    pipelined strategy on the winning MCM.  (The reference returns the
    compiled top records beside it; nothing in the port reads them.)"""
    from repro_torch.api import Study
    from repro_torch.events import compile_step
    w, hw, recs = pipelined_records(sc, Study(sc).run(device=device), top)
    s, mcm, topo, fabric = recs[0]
    return compile_step(w, s, mcm, fabric=fabric, topo=topo, reuse=sc.reuse,
                        hw=hw, schedule=schedule)
