"""Fast non-dominated sorting over batched DSE objectives.

Objectives arrive as an (N, K) float matrix plus a per-column sense
(maximize / minimize).  ``pareto_mask`` finds the non-dominated set by
sorting on the first objective and comparing each chunk only against the
still-alive points that could possibly dominate it (those at least as
good on objective 0) — O(N * front) broadcasting in practice, a few
milliseconds for tens of thousands of points, with the same O(N^2)
worst case only when nearly everything is mutually non-dominated.
``nondominated_sort`` peels fronts NSGA-II-style and
``crowding_distance`` supplies the diversity metric for the
evolutionary driver.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _as_max(objectives: np.ndarray, maximize: Sequence[bool]) -> np.ndarray:
    obj = np.asarray(objectives, np.float64)
    if obj.ndim != 2:
        raise ValueError("objectives must be (N, K)")
    sign = np.where(np.asarray(maximize, bool), 1.0, -1.0)
    return obj * sign


def pareto_mask(objectives: np.ndarray, maximize: Sequence[bool],
                chunk: int = 512) -> np.ndarray:
    """(N,) bool — True where no other point weakly dominates the point
    (>= in every objective, > in at least one).  Duplicate points keep
    each other (neither strictly dominates)."""
    M = _as_max(objectives, maximize)
    # a point with any NaN objective never survives
    keep = ~np.isnan(M).any(1)
    idx = np.nonzero(keep)[0]
    if not len(idx):
        return keep
    # descending objective-0 order: a dominator of row j must sit at or
    # before j's value band (obj0 >= obj0_j), so each chunk is compared
    # against the alive prefix only.  Not-yet-processed rows inside that
    # prefix are safe dominators: weak dominance is transitive, so if
    # such a row is later culled, whatever culled it dominates too.
    Mv = M[idx]
    order = np.argsort(-Mv[:, 0], kind="stable")
    Ms = Mv[order]
    m = len(order)
    alive = np.ones(m, bool)
    neg0 = -Ms[:, 0]                                 # ascending
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        blk = Ms[lo:hi]                              # (c, K)
        # stage 1: cull against the already-settled front (cheap — the
        # front is tiny, and it kills most of the chunk).  Transitivity
        # makes the two-stage split safe: any chunk row that could have
        # culled a sibling but died here is dominated by a front member
        # that culls the sibling too.
        prior = np.nonzero(alive[:lo])[0]
        if len(prior):
            alive[lo:hi] &= ~_dominated_by(Ms[prior], blk)
        # stage 2: survivors vs the alive slice of their own obj0 band —
        # the chunk itself plus any later rows tied on objective 0 (blk
        # is sorted, so the band's minimum is its last row)
        live = np.nonzero(alive[lo:hi])[0] + lo
        if not len(live):
            continue
        stop = np.searchsorted(neg0, -blk[-1, 0], side="right")
        band = np.nonzero(alive[lo:stop])[0] + lo
        alive[live] &= ~_dominated_by(Ms[band], Ms[live])
    keep[idx[order[~alive]]] = False
    return keep


def _dominated_by(C: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(len(B),) bool — B_j weakly dominated by some C_i (>= everywhere,
    > somewhere; equal rows do not dominate).  Built from per-objective
    2-D comparisons to avoid 3-D broadcast temporaries."""
    ge = np.ones((C.shape[0], B.shape[0]), bool)
    eq = np.ones_like(ge)
    for k in range(C.shape[1]):
        ck = C[:, k, None]
        bk = B[None, :, k]
        ge &= ck >= bk
        eq &= ck == bk
    return (ge & ~eq).any(0)


def nondominated_sort(objectives: np.ndarray, maximize: Sequence[bool],
                      max_fronts: int = 0) -> np.ndarray:
    """NSGA-II fast non-dominated sort: (N,) int rank, 0 = Pareto front.

    Points never ranked (NaN objectives, or beyond ``max_fronts``) get
    rank N (worst)."""
    obj = np.asarray(objectives, np.float64)
    n = obj.shape[0]
    ranks = np.full(n, n, np.int64)
    remaining = ~np.isnan(obj).any(1)
    rank = 0
    while remaining.any():
        if max_fronts and rank >= max_fronts:
            break
        idx = np.nonzero(remaining)[0]
        front = pareto_mask(obj[idx], maximize)
        ranks[idx[front]] = rank
        remaining[idx[front]] = False
        rank += 1
    return ranks


def crowding_distance(objectives: np.ndarray,
                      maximize: Sequence[bool]) -> np.ndarray:
    """NSGA-II crowding distance within one front (larger = lonelier)."""
    M = _as_max(objectives, maximize)
    n, k = M.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(k):
        order = np.argsort(M[:, j], kind="stable")
        span = M[order[-1], j] - M[order[0], j]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        gaps = (M[order[2:], j] - M[order[:-2], j]) / span
        dist[order[1:-1]] += gaps
    return dist


def pareto_front_indices(objectives: np.ndarray, maximize: Sequence[bool]
                         ) -> np.ndarray:
    """Indices of the non-dominated set, best-first by objective 0."""
    mask = pareto_mask(objectives, maximize)
    idx = np.nonzero(mask)[0]
    M = _as_max(objectives[idx], maximize)
    return idx[np.argsort(-M[:, 0], kind="stable")]
