"""Design-space definition + grid enumeration in structure-of-arrays form.

The DSE engine operates on *batches* of design points.  A design point is
(parallelism strategy, MCM architecture, fabric); strategies are held as
``StrategyBatch`` — one int64 numpy array per degree — so the batched
simulator (``repro_torch.dse.batched_sim``) can evaluate thousands of points
with a handful of vectorized array ops instead of one Python call each.

``enumerate_strategy_batch`` reproduces exactly the candidate set of
``core.optimizer.enumerate_strategies`` (same constraints, same order)
but builds it with a meshgrid + vectorized filters.  ``DesignSpace``
composes that with an MCM-variant and fabric grid for full cross-layer
sweeps (see DESIGN.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import HW, DEFAULT_HW
from repro_torch.core.mcm import MCMArch, mcm_from_compute
from repro_torch.core.traffic import PARALLELISMS, Strategy
from repro_torch.core.workload import Workload

# canonical parallelism axis order for all (B, 5) arrays in repro_torch.dse
P_ORDER = PARALLELISMS          # ("TP", "DP", "PP", "CP", "EP")
P_IDX = {p: i for i, p in enumerate(P_ORDER)}

FABRICS = ("oi", "ib", "nvlink")

# Pipeline-schedule search axis: interleave depths tried per schedule
# when the schedule is a search dimension (the event re-rank stage and
# the outer search's per-round replay).  Depths are requests — the
# compiler clamps per row to min(layers_per_stage, n_micro), and
# duplicate clamped candidates cost one extra vectorized pass, not a
# per-record walk.
SCHEDULE_V = {"gpipe": (1,), "1f1b": (1,), "interleaved": (2, 4)}


def schedule_axis(schedules: Sequence[str]
                  ) -> Tuple[Tuple[str, int], ...]:
    """Expand schedule names to (schedule, virtual_chunks) candidates."""
    return tuple((s, v) for s in schedules
                 for v in SCHEDULE_V.get(s, (1,)))


# ---------------------------------------------------------------------------
# Strategy batches (SoA)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StrategyBatch:
    """Structure-of-arrays batch of parallelism strategies (int64, (B,))."""

    tp: np.ndarray
    dp: np.ndarray
    pp: np.ndarray
    cp: np.ndarray
    ep: np.ndarray
    n_micro: np.ndarray

    def __post_init__(self):
        for name in ("tp", "dp", "pp", "cp", "ep", "n_micro"):
            object.__setattr__(self, name,
                               np.asarray(getattr(self, name), np.int64))

    def __len__(self) -> int:
        return int(self.tp.shape[0])

    @property
    def n_devices(self) -> np.ndarray:
        return self.tp * self.dp * self.pp * self.cp * self.ep

    def degrees(self) -> np.ndarray:
        """(B, 5) degree matrix in ``P_ORDER``."""
        return np.stack([self.tp, self.dp, self.pp, self.cp, self.ep], 1)

    def take(self, idx) -> "StrategyBatch":
        idx = np.asarray(idx)
        return StrategyBatch(self.tp[idx], self.dp[idx], self.pp[idx],
                             self.cp[idx], self.ep[idx], self.n_micro[idx])

    def features(self) -> np.ndarray:
        """log2 feature matrix, matching the PRF surrogate's encoding."""
        cols = [self.tp, self.dp, self.pp, self.cp, self.ep, self.n_micro]
        return np.log2(np.maximum(np.stack(cols, 1), 1).astype(np.float64))

    def keys(self) -> List[Tuple[int, ...]]:
        """Hashable per-point strategy tuples (for the evaluation cache)."""
        cols = np.stack([self.tp, self.dp, self.pp, self.cp, self.ep,
                         self.n_micro], 1)
        return [tuple(row) for row in cols.tolist()]

    def to_strategies(self) -> List[Strategy]:
        return [Strategy(tp=int(t), dp=int(d), pp=int(p), cp=int(c),
                         ep=int(e), n_micro=int(m))
                for t, d, p, c, e, m in zip(self.tp, self.dp, self.pp,
                                            self.cp, self.ep, self.n_micro)]

    @classmethod
    def from_strategies(cls, strategies: Sequence[Strategy]
                        ) -> "StrategyBatch":
        if not strategies:
            return cls(*(np.zeros(0, np.int64) for _ in range(6)))
        return cls(np.array([s.tp for s in strategies], np.int64),
                   np.array([s.dp for s in strategies], np.int64),
                   np.array([s.pp for s in strategies], np.int64),
                   np.array([s.cp for s in strategies], np.int64),
                   np.array([s.ep for s in strategies], np.int64),
                   np.array([s.n_micro for s in strategies], np.int64))

    @classmethod
    def concat(cls, batches: Sequence["StrategyBatch"]) -> "StrategyBatch":
        return cls(*(np.concatenate([getattr(b, f) for b in batches])
                     for f in ("tp", "dp", "pp", "cp", "ep", "n_micro")))


# ---------------------------------------------------------------------------
# Strategy-grid enumeration (vectorized)
# ---------------------------------------------------------------------------
from repro_torch.core.optimizer import _divisors  # noqa: E402  (shared helper)


# The candidate grid depends on the MCM only through (n_devices,
# dies_per_mcm) — across an MCM-variant grid at constant C, the m/cpo
# axes share one grid per die count.  The population outer search and
# the fused sweeps re-enumerate the same few grids constantly, so a
# content-keyed memo (Workload and its ModelConfig are frozen/hashable)
# turns enumeration into a dict hit.  Entries are treated as immutable.
_GRID_CACHE: Dict[tuple, StrategyBatch] = {}
_GRID_CACHE_MAX = 256


def enumerate_strategy_batch(w: Workload, mcm: MCMArch,
                             max_pp: int = 32,
                             min_layers_per_stage: int = 4,
                             mappable_only: bool = True) -> StrategyBatch:
    """SoA grid of valid strategies — same set (and nested-loop order) as
    ``core.optimizer.enumerate_strategies``, built vectorized and
    memoized per (workload, n_devices, dies_per_mcm)."""
    key = (w, mcm.n_devices, mcm.dies_per_mcm, max_pp,
           min_layers_per_stage, mappable_only)
    try:
        return _GRID_CACHE[key]
    except (KeyError, TypeError):       # TypeError: unhashable workload
        pass
    batch = _enumerate_strategy_batch(w, mcm, max_pp,
                                      min_layers_per_stage, mappable_only)
    try:
        if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
            _GRID_CACHE.clear()
        _GRID_CACHE[key] = batch
    except TypeError:
        pass
    return batch


def _enumerate_strategy_batch(w: Workload, mcm: MCMArch,
                              max_pp: int = 32,
                              min_layers_per_stage: int = 4,
                              mappable_only: bool = True) -> StrategyBatch:
    n = mcm.n_devices
    dies = mcm.dies_per_mcm
    moe = w.model.moe
    divs = _divisors(n)

    tps = np.array([t for t in _divisors(dies) if w.d_model % t == 0],
                   np.int64)
    pps = np.array([p for p in divs
                    if p <= min(max_pp, w.n_layers // min_layers_per_stage)
                    or p == 1], np.int64)
    if moe is not None:
        eps = np.array([e for e in divs if moe.n_experts % e == 0], np.int64)
    else:
        eps = np.array([1], np.int64)
    cps = np.array([c for c in divs
                    if c <= 64 and w.seq_len % c == 0 and
                    (c == 1 or w.n_attn_layers > 0)], np.int64)
    if not (len(tps) and len(pps) and len(eps) and len(cps)):
        return StrategyBatch.from_strategies([])

    # meshgrid in (tp, pp, ep, cp) nested-loop order
    T, P, E, C = (g.reshape(-1) for g in
                  np.meshgrid(tps, pps, eps, cps, indexing="ij"))
    prod = T * P * E * C
    ok = n % prod == 0                       # pp|rest1, ep|rest2, cp|rest3
    T, P, E, C, prod = T[ok], P[ok], E[ok], C[ok], prod[ok]
    D = n // prod
    ok = (D <= 1) | (w.global_batch % D == 0)
    T, P, E, C, D = T[ok], P[ok], E[ok], C[ok], D[ok]

    # microbatch rule: pp>1 -> n_micro = min(4*pp, max(gb//max(dp,1),1))
    nm = np.minimum(4 * P, np.maximum(w.global_batch // np.maximum(D, 1), 1))
    nm = np.where(P > 1, nm, 1)
    ok = (P <= 1) | (nm >= P)
    batch = StrategyBatch(T[ok], D[ok], P[ok], C[ok], E[ok], nm[ok])

    if mappable_only and len(batch):
        from repro_torch.dse.batched_sim import map_intra_batch  # lazy: no cycle
        mask, _, _ = map_intra_batch(batch, mcm)
        batch = batch.take(np.nonzero(mask)[0])
    return batch


def enumerate_space_batch(w: Workload, mcms: Sequence[MCMArch],
                          max_pp: int = 32, min_layers_per_stage: int = 4
                          ) -> Tuple[StrategyBatch, np.ndarray]:
    """Batched strategy enumeration ACROSS MCM variants: the concatenated
    grids of every variant plus a per-row variant index, for building
    custom fused ``MCMBatch`` evaluations outside ``DesignSpace`` (the
    sweep/outer paths enumerate per cell through the same memo).  Grids
    are memoized per (workload, n_devices, dies), so variants differing
    only in m/cpo share one enumeration."""
    grids = [enumerate_strategy_batch(w, m, max_pp=max_pp,
                                      min_layers_per_stage=min_layers_per_stage)
             for m in mcms]
    if not grids:
        return StrategyBatch.from_strategies([]), np.zeros(0, np.int64)
    idx = np.concatenate([np.full(len(g), i, np.int64)
                          for i, g in enumerate(grids)])
    return StrategyBatch.concat(grids), idx


# ---------------------------------------------------------------------------
# MCM-variant + fabric grid
# ---------------------------------------------------------------------------
def enumerate_mcm_grid(total_tflops: float,
                       dies_per_mcm: Sequence[int] = (8, 16, 32),
                       m: Sequence[int] = (2, 4, 6, 8, 12),
                       cpo_ratio: Sequence[float] = (0.3, 0.6, 0.9),
                       hw: HW = DEFAULT_HW) -> List[MCMArch]:
    """All feasible MCM variants at a fixed cluster-compute constant C."""
    out: List[MCMArch] = []
    seen = set()
    for d in dies_per_mcm:
        for mi in m:
            for r in cpo_ratio:
                mcm = mcm_from_compute(total_tflops, d, mi, cpo_ratio=r,
                                       hw=hw)
                key = (mcm.n_mcm, mcm.x, mcm.y, mcm.m, round(r, 6))
                if key in seen:
                    continue
                seen.add(key)
                if mcm.feasible() and mcm.total_links > 0:
                    out.append(mcm)
    return out


@dataclass(frozen=True)
class DesignSpace:
    """Full cross-layer grid: strategies x MCM variants x fabrics."""

    workload: Workload
    mcms: Tuple[MCMArch, ...]
    fabrics: Tuple[str, ...] = ("oi",)
    reuse: bool = True
    max_pp: int = 32
    min_layers_per_stage: int = 4
    # link-allocation policy on the OI fabric: "chiplight" is the
    # traffic-proportional allocator (+ dynamic reuse), "railx" the
    # uniform 50/50 two-rail-dimension baseline
    alloc_mode: str = "chiplight"

    @classmethod
    def from_compute(cls, w: Workload, total_tflops: float,
                     fabrics: Sequence[str] = ("oi",), reuse: bool = True,
                     hw: HW = DEFAULT_HW, alloc_mode: str = "chiplight",
                     **grid_kw) -> "DesignSpace":
        return cls(workload=w,
                   mcms=tuple(enumerate_mcm_grid(total_tflops, hw=hw,
                                                 **grid_kw)),
                   fabrics=tuple(fabrics), reuse=reuse,
                   alloc_mode=alloc_mode)

    def batches(self) -> Iterator[Tuple[MCMArch, str, StrategyBatch]]:
        """Yield one (mcm, fabric, StrategyBatch) slab per grid cell."""
        for mcm in self.mcms:
            batch = enumerate_strategy_batch(
                self.workload, mcm, max_pp=self.max_pp,
                min_layers_per_stage=self.min_layers_per_stage)
            if not len(batch):
                continue
            for fabric in self.fabrics:
                if fabric == "nvlink" and mcm.dies_per_mcm > 8:
                    continue        # NVLink domains cap at 8 GPUs
                yield mcm, fabric, batch

    def size(self) -> int:
        return sum(len(b) for _, _, b in self.batches())
