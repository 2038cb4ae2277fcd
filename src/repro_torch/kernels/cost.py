"""The nominal work of each hand kernel: the operations and the bytes one
call needs (each input read once, each output written once), from its
shapes.

One copy for the two readers: ``chip_smoke.py`` divides them by the
card's peaks for each kernel's bound, and ``kernels/ops.py``'s fake
branch adds them to the dry run's count (``launch/hlo.py``), so the
dry run's work and the bounds cannot drift apart.
"""
from __future__ import annotations

import numpy as np


def _attn_rows(sq: int, sk: int, window, causal: bool):
    """Each query's first and last live key: query i at position
    i + Sk - Sq, as in the kernel.  In numpy, so that the counts are
    numbers under ``FakeTensorMode`` too."""
    r = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(r, sk - 1) if causal else np.full_like(r, sk - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros_like(r)
    return lo, hi


def attn_live_pairs(sq: int, sk: int, window, causal: bool) -> int:
    """(query, key) pairs the mask leaves, per (batch, head)."""
    lo, hi = _attn_rows(sq, sk, window, causal)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attn_live_keys(sq: int, sk: int, window, causal: bool) -> int:
    """Keys some query attends to, per (batch, KV head): the union of the
    rows' ranges, which is one range (neighbouring rows' ranges touch)."""
    lo, hi = _attn_rows(sq, sk, window, causal)
    live = hi >= lo
    return int(hi[live].max() - lo[live].min() + 1) if live.any() else 0


def flash_fwd_cost(b, hq, hkv, sq, sk, d, window, causal,
                   itemsize: int) -> tuple:
    """-> (operations, bytes) of flash attention's forward: 4·d a live
    (query, key) pair; q read and o written, K and V over the live keys,
    the float32 lse written."""
    flops = 4.0 * d * attn_live_pairs(sq, sk, window, causal) * b * hq
    kv = 2 * b * hkv * attn_live_keys(sq, sk, window, causal) * d
    return flops, float((2 * b * hq * sq * d + kv) * itemsize
                        + b * hq * sq * 4)


def rmsnorm_cost(rows: int, d: int, itemsize: int) -> tuple:
    """-> (operations, bytes): 4 operations an element; x read, y
    written, w read once."""
    return 4.0 * rows * d, float((2 * rows * d + d) * itemsize)


def ssd_flops(bb, s, h, p, n, chunk) -> float:
    """Operations the chunked algorithm needs: C.B^T and the masked
    product over the (i, j <= i) pairs, the carried-state term (none in
    the first chunk, whose state is zero) and the state update."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2.0 * pairs * (n + p) + 2.0 * chunk * n * p
    return bb * h * (nc * per_chunk + (nc - 1) * 2.0 * chunk * n * p)


def ssd_cost(bb, s, h, p, g, n, chunk, itemsize: int, dt_itemsize: int = 4,
             state: bool = False) -> tuple:
    """-> (operations, bytes) of the SSD: x read and y written, B and C
    read, dt and A read in their dtype, and with ``state`` the float32
    final state written."""
    nbytes = (2 * bb * s * h * p + 2 * bb * s * g * n) * itemsize \
        + (bb * s * h + h) * dt_itemsize
    if state:
        nbytes += bb * h * p * n * 4
    return ssd_flops(bb, s, h, p, n, chunk), float(nbytes)


def gmm_cost(t: int, k: int, n: int, experts: int, itemsize: int) -> tuple:
    """-> (operations, bytes) of the grouped matmul: 2·T·K·N; x read, the
    weights of ``experts`` experts read once, out written."""
    return 2.0 * t * k * n, float((t * k + experts * k * n + t * n)
                                  * itemsize)
