"""Kernel profiling harness — execution-grounded cost measurements.

Runs the port's kernels (``repro_torch.kernels.ops``: flash attention
fwd and fwd+bwd, moe_gmm, ssd, rmsnorm, decode_attention) over the
reference's (M, N) shape grid (on the card, carried on to where the
rates bend) and reports, per measurement, the achieved
FLOP/s and bytes/s alongside the analytic FLOP/byte counts (the
reference's, formula for formula, but for flash attention's FLOPs on the
card, whose kernel skips the causal tiles the reference's scan runs:
``_fa_flops``).  ``repro_torch.calib`` fits the
analytic cost constants from these measurements and writes the
artifact ``Scenario.calibration`` reads.

The inputs are float32 throughout, as the reference's.  On the card the
ops take their hand-written CUDA kernels: flash attention's forward on
the FMA kernel (its backward is torch ops on the forward's saved
``lse``), ``moe_gmm`` on its float32 FMA kernel, the float32 ``ssd_scan``
and ``rmsnorm``; ``decode_attention`` is plain torch on every device (the
reference has no Pallas kernel for it).  On the CPU every op runs its
plain version.  Each row names what ran (``impl``) and its ``dtype``, so
an artifact says which implementation its constants describe.

Every timed grid point runs under a ``profile.measure`` span and
samples the achieved rates as ``profile.achieved_tflops`` /
``profile.achieved_gbs`` gauges.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.obs import metrics
from repro_torch.obs.trace import span

# kernels the harness knows how to drive, in measurement order
PROFILE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                   "moe_gmm", "ssd", "rmsnorm", "decode_attention")

# roofline regime each kernel's curve is fitted in (repro_torch.calib):
# compute-bound kernels fit achieved FLOP/s, memory-bound kernels fit
# achieved bytes/s
KERNEL_KIND = {
    "flash_attention_fwd": "compute",
    "flash_attention_bwd": "compute",
    "moe_gmm": "compute",
    "ssd": "compute",
    "rmsnorm": "memory",
    "decode_attention": "memory",
}

_F32 = 4  # bytes per element; the harness measures in float32 throughout
_DTYPE = torch.float32

# the gmm's row tile: every grid point's groups (t // 4 rows, t a
# multiple of 64) are whole tiles, so no row is padding and the
# reference's 2*t*k*n is the work done
_GMM_BLOCK_T = 16


# Points the card's grids go on to past the reference's, which end
# before the H100's rates bend: at 2048 flash attention's fp32 forward
# runs 128 blocks, one wave of short chains, and moe_gmm's 16-row tiles
# 512 blocks of a few microseconds, so the rates still rise in
# proportion to x there, and a fit of y = peak * x / (x + half) to them
# puts half at the top of its search and extrapolates the peak.  The
# reference's points stay first, so each card grid holds the reference's
# grid.  ssd's fp32 kernel walks the chunks of a head in order, so its
# rate is flat from the first point, and its grid is the reference's.
_CARD_EXTRA = {
    "flash_attention_fwd": [4096, 8192, 16384],
    "flash_attention_bwd": [2048, 4096, 8192, 16384, 32768, 65536],
    "moe_gmm": [4096, 8192, 16384, 32768],
    "ssd": [],
    "rmsnorm": [131072],
    "decode_attention": [65536, 262144],
}
_CARD_EXTRA_MOE_N = [1024, 2048, 4096]

# On the card, flash attention's backward row (the fp32 forward kernel
# plus the torch-op backward over every key block) is host-bound at its
# first points and rises until its largest, where a reading that happens
# to run fast or slow bends the fitted curve: one whole run fitted a peak
# of 8.98e13 FLOP/s, over the card's float32 peak, from such a top.  Its
# top ``_CARD_TOP_POINTS`` points are therefore timed ``_CARD_REPEATS``
# times each (best-of-``reps`` each time) and fitted by the median.  Its
# grid goes on to m 65536: a grid that ended at m 16384 ended while the
# rate still rose (2.19e12, 4.72e12, 5.75e12 FLOP/s at m 4096, 8192,
# 16384) and its fits put the peak 1.65-2.1x past the best reading; one
# that ended at 32768 (5.98e12) put it 1.27-1.33x past.  A call at m
# 32768 or more takes 0.55 s or more and its timings agree within 0.1%,
# so there each of the three timings is one call (``_CARD_ONE_REP``).
_CARD_REPEATS = {"flash_attention_bwd": 3}
_CARD_TOP_POINTS = 3
_CARD_ONE_REP = {"flash_attention_bwd": 32768}


def _grids(quick: bool, device="cpu") -> Dict[str, List[int]]:
    """M-axis grid per kernel (sequence length / rows / tokens /
    cache length): the reference's, and on the card ``_CARD_EXTRA``
    after it.  ``quick`` drops the most expensive point — a strict
    prefix of the full grid, so quick fits stay comparable to a
    full-grid artifact."""
    g = {
        "flash_attention_fwd": [128, 256, 512, 1024, 2048],
        "flash_attention_bwd": [128, 256, 512, 1024],
        "moe_gmm": [64, 128, 256, 512, 1024, 2048],
        "ssd": [128, 256, 512, 1024],
        "rmsnorm": [128, 512, 2048, 8192, 32768],
        "decode_attention": [512, 2048, 8192, 16384],
    }
    if _cuda(device):
        g = {k: v + _CARD_EXTRA[k] for k, v in g.items()}
    if quick:
        g = {k: v[:-1] for k, v in g.items()}
    return g


def _repeats(name: str, x: int, quick: bool, device) -> int:
    """How many times a grid point is timed (its row holds the median)."""
    n = _CARD_REPEATS.get(name, 1) if _cuda(device) else 1
    return n if x in _grids(quick, device)[name][-_CARD_TOP_POINTS:] else 1


def _reps(name: str, x: int, reps: int, device) -> int:
    """Calls a timing of this grid point takes the best of."""
    big = _CARD_ONE_REP.get(name)
    return 1 if _cuda(device) and big is not None and x >= big else reps


def _time_point(fn, args, reps: int, repeats: int):
    """-> (the median of ``repeats`` best-of-``reps`` timings, them), one
    warm-up call before the first."""
    from repro_torch.obs.bench import time_fn
    times = [time_fn(fn, *args, reps=reps, warmup=1 if i == 0 else 0)
             for i in range(repeats)]
    return sorted(times)[len(times) // 2], times


# N-axis grid (TP-sharded width) for the grouped matmul: fixed M, swept
# N — fits the ``N/(N+gemm_n_half)`` width-dimension curve
_MOE_N_GRID = [32, 64, 128, 256, 512]


def _moe_n_grid(quick: bool, device="cpu") -> List[int]:
    g = _MOE_N_GRID + (_CARD_EXTRA_MOE_N if _cuda(device) else [])
    return g[:-1] if quick else g


def _randn(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=_DTYPE)


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# Per-kernel workloads: build (fn, args, flops, bytes, shape, kernels)
# where ``kernels`` maps each kernel module whose ``launches`` the op
# moves on the card to the name a row gives it, and ``_impl`` names what
# ran from the counts that moved
# ---------------------------------------------------------------------------
# the fp32 flash kernel's query and key tile (csrc/flash_attention.cu
# kBQ, kBK)
_FA_TILE = 64


def _fa_flops(b: int, h: int, s: int, d: int, bwd: bool, card: bool
              ) -> float:
    """The work of one call, counted for the implementation that runs.
    The plain version runs every key block, masked, as the reference's
    scan does: the reference's 4·b·h·s²·d forward, plus 10·b·h·s²·d for
    the backward (the "~2.5x fwd work").  The card's kernel skips the key
    tiles past each query tile's diagonal: tile pairs (qt, kt <= qt) of
    4·64²·d each, 2·b·h·s·(s + 64)·d for s a multiple of 64; the
    backward's torch ops still run every block."""
    if not card:
        return (14.0 if bwd else 4.0) * b * h * s * s * d
    if s % _FA_TILE:
        raise ValueError(f"flash case s={s}: not whole {_FA_TILE}-row "
                         f"tiles")
    return 2.0 * b * h * s * (s + _FA_TILE) * d + \
        (10.0 * b * h * s * s * d if bwd else 0.0)


def _fa_case(s: int, bwd: bool, device):
    from repro_torch.kernels import ops
    b, h, d = 1, 4, 64
    g = _gen(0, device)
    q, k, v = (_randn((b, h, s, d), g, device) for _ in range(3))
    block = min(128, s)

    def fwd(q_, k_, v_):
        return ops.flash_attention(q_, k_, v_, causal=True, block=block)

    if bwd:
        # fwd + bwd in one call (the custom-VJP path: the backward runs
        # on the forward's saved o and lse), ~2.5x fwd work on top of
        # the fwd pass, as the reference counts it
        def fn(q_, k_, v_):
            ts = [t.detach().requires_grad_() for t in (q_, k_, v_)]
            return torch.autograd.grad(fwd(*ts).sum(), ts)
    else:
        fn = fwd
    flops = _fa_flops(b, h, s, d, bwd, _cuda(device))
    bytes_ = _F32 * (4.0 * b * h * s * d) * (3.0 if bwd else 1.0)
    # float32 runs the FMA kernel (kernels/flash_attention.py)
    return fn, (q, k, v), flops, bytes_, {"b": b, "h": h, "s": s, "d": d}, \
        {"flash_attention": "flash_attention_fwd/fma"}


def _moe_case(t: int, n: int, device):
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ops
    e, k = 4, 256
    sizes = [t // e] * e
    sizes[0] += t - sum(sizes)
    # the reference's group sizes as the kernel's block ids: equal groups
    # of whole tiles (see _GMM_BLOCK_T)
    if any(sz % _GMM_BLOCK_T for sz in sizes):
        raise ValueError(f"moe_gmm case t={t}: group sizes {sizes} are "
                         f"not whole {_GMM_BLOCK_T}-row tiles")
    ids = torch.arange(e, dtype=torch.int32, device=device) \
        .repeat_interleave(torch.tensor(sizes, device=device)
                           // _GMM_BLOCK_T)
    g = _gen(1, device)
    x = _randn((t, k), g, device)
    w = _randn((e, k, n), g, device) * 0.1

    def fn(x_, w_, ids_):
        return ops.moe_gmm(x_, w_, ids_, block_t=_GMM_BLOCK_T)

    flops = 2.0 * t * k * n
    bytes_ = _F32 * (t * k + e * k * n + t * n)
    return fn, (x, w, ids), flops, bytes_, \
        {"t": t, "e": e, "k": k, "n": n}, \
        {"moe_gmm": f"moe_gmm/{mg.kernel_for(_DTYPE, _GMM_BLOCK_T)}"}


def _ssd_case(s: int, device):
    from repro_torch.kernels import ops
    b, h, p, g, n = 1, 4, 32, 1, 32
    chunk = min(64, s)
    gen = _gen(2, device)
    x = _randn((b, s, h, p), gen, device)
    dt = F.softplus(_randn((b, s, h), gen, device))
    a = -torch.exp(_randn((h,), gen, device) * 0.5)
    bm = _randn((b, s, g, n), gen, device) * 0.3
    cm = _randn((b, s, g, n), gen, device) * 0.3

    def fn(*t):
        return ops.ssd(*t, chunk=chunk)

    # order-of-magnitude analytic count (state outer products + intra-
    # chunk attention-like term); only this kernel's own curve uses it
    flops = b * s * h * (6.0 * p * n + 2.0 * chunk * p)
    bytes_ = _F32 * b * s * (2.0 * h * p + h + 2.0 * g * n)
    # float32 runs the FMA kernel (kernels/ssd_scan.py)
    return fn, (x, dt, a, bm, cm), flops, bytes_, \
        {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk}, \
        {"ssd_scan": "ssd_scan/fma"}


def _rmsnorm_case(rows: int, device):
    from repro_torch.kernels import ops
    d = 1024
    x = _randn((rows, d), _gen(3, device), device)
    w = torch.ones((d,), dtype=_DTYPE, device=device)

    def fn(x_, w_):
        return ops.rmsnorm(x_, w_)

    flops = 4.0 * rows * d
    bytes_ = _F32 * (2.0 * rows * d + d)
    return fn, (x, w), flops, bytes_, {"rows": rows, "d": d}, \
        {"rmsnorm": "rmsnorm"}


def _decode_case(smax: int, device):
    from repro_torch.kernels import ops
    b, hq, hkv, d = 1, 8, 4, 64
    g = _gen(4, device)
    q = _randn((b, hq, 1, d), g, device)
    kc = _randn((b, hkv, smax, d), g, device)
    vc = _randn((b, hkv, smax, d), g, device)
    pos = smax - 1

    def fn(q_, k_, v_, p_):
        return ops.decode_attention(q_, k_, v_, p_)

    flops = 4.0 * b * hq * smax * d
    bytes_ = _F32 * (2.0 * b * hkv * smax * d + 2.0 * b * hq * d)
    return fn, (q, kc, vc, pos), flops, bytes_, \
        {"b": b, "hq": hq, "hkv": hkv, "smax": smax, "d": d}, {}


def _launch_counts(kernels) -> Dict[str, int]:
    import importlib
    return {m: importlib.import_module(f"repro_torch.kernels.{m}").launches
            for m in kernels}


def _impl(name: str, kernels, before: Dict[str, int]) -> str:
    """What ran, from the launch counts that moved since ``before``:
    ``cuda:<kernel>`` for each hand kernel that launched (flash
    attention's backward adds its torch ops), else ``torch``."""
    after = _launch_counts(kernels)
    ran = [f"cuda:{label}" for m, label in kernels.items()
           if after[m] > before[m]]
    if not ran:
        return "torch"
    return "+".join(ran) + ("+torch:bwd" if name == "flash_attention_bwd"
                            else "")


def _cases(name: str, quick: bool, device):
    """(axis, x, builder()) tuples for one kernel's grid."""
    grid = _grids(quick, device)[name]
    if name == "flash_attention_fwd":
        return [("m", s, lambda s=s: _fa_case(s, False, device))
                for s in grid]
    if name == "flash_attention_bwd":
        return [("m", s, lambda s=s: _fa_case(s, True, device))
                for s in grid]
    if name == "moe_gmm":
        cases = [("m", t, lambda t=t: _moe_case(t, 256, device))
                 for t in grid]
        cases += [("n", n, lambda n=n: _moe_case(512, n, device))
                  for n in _moe_n_grid(quick, device)]
        return cases
    if name == "ssd":
        return [("m", s, lambda s=s: _ssd_case(s, device)) for s in grid]
    if name == "rmsnorm":
        return [("m", r, lambda r=r: _rmsnorm_case(r, device)) for r in grid]
    if name == "decode_attention":
        return [("m", s, lambda s=s: _decode_case(s, device)) for s in grid]
    raise KeyError(f"unknown kernel {name!r}; known: "
                   f"{list(PROFILE_KERNELS)}")


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------
def profile_kernels(kernels: Optional[Sequence[str]] = None, *,
                    quick: bool = False,
                    reps: Optional[int] = None,
                    device="cuda") -> List[dict]:
    """Measure every requested kernel over its (M, N) grid on ``device``
    (a CUDA device that is not there raises; ``device="cpu"`` times the
    plain versions).

    Returns one measurement dict per grid point: ``{kernel, kind, axis,
    x, shape, flops, bytes, time_s, flops_per_s, bytes_per_s, reps,
    impl, dtype}``, ``impl`` read from the kernels' launch counts.
    Timing is best-of-``reps`` after one warm-up call (which also builds
    a kernel on its first launch), via ``obs.bench.time_fn``: on the card
    the calls' time on its stream, from a cold L2.  On the card the top
    points of a ``_CARD_REPEATS`` kernel are timed that many times and
    their row holds the median (``time_s``) beside every timing
    (``repeats``, ``times_s``); from a ``_CARD_ONE_REP`` point on, a
    timing is one call (the row's ``reps``).
    """
    from repro_torch.models.common import check_device
    device = check_device(device)
    names = tuple(kernels) if kernels else PROFILE_KERNELS
    bad = sorted(set(names) - set(PROFILE_KERNELS))
    if bad:
        raise KeyError(f"unknown kernel(s) {bad}; known: "
                       f"{list(PROFILE_KERNELS)}")
    reps = reps if reps is not None else (2 if quick else 3)
    out: List[dict] = []
    for name in names:
        kind = KERNEL_KIND[name]
        with span("profile.kernel", kernel=name, kind=kind):
            for axis, x, build in _cases(name, quick, device):
                fn, args, flops, bytes_, shape, kernels = build()
                before = _launch_counts(kernels)
                repeats = _repeats(name, x, quick, device) \
                    if axis == "m" else 1
                point_reps = _reps(name, x, reps, device)
                with span("profile.measure", kernel=name, axis=axis,
                          x=x, reps=point_reps):
                    t, times = _time_point(fn, args, point_reps, repeats)
                impl = _impl(name, kernels, before)
                m = {"kernel": name, "kind": kind, "axis": axis,
                     "x": int(x), "shape": shape, "flops": flops,
                     "bytes": bytes_, "time_s": t,
                     "flops_per_s": flops / t, "bytes_per_s": bytes_ / t,
                     "reps": point_reps, "impl": impl, "dtype": "float32"}
                if repeats > 1:
                    m.update(repeats=repeats, times_s=times)
                metrics.inc("profile.measurements")
                metrics.gauge("profile.achieved_tflops",
                              m["flops_per_s"] / 1e12)
                metrics.gauge("profile.achieved_gbs",
                              m["bytes_per_s"] / 1e9)
                out.append(m)
        metrics.inc("profile.kernels")
    return out
