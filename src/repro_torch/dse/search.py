"""Search drivers over the batched DSE engine.

All drivers share one cached batched-evaluate interface plus a
generator "stepper" core: a stepper yields arrays of candidate grid
indices and receives their metrics, so the SAME driver logic runs in
two harnesses —

  * per cell:  ``search_*`` drive one stepper against one
               ``BatchedEvaluator`` (one (workload, MCM, fabric) cell);
  * fused:     ``sweep_design_space`` drives every cell's stepper in
               lockstep and evaluates each round's candidates from ALL
               cells in one ``batched_simulate`` call per fabric
               (``MCMBatch``) — the way the exhaustive ``_sweep_fused``
               path always did, now for random/PRF/NSGA-II too.

Drivers:

  * ``search_exhaustive`` — the whole grid in one batched call;
  * ``search_random``     — uniform subsample (baseline);
  * ``search_prf_ucb``    — batched PRF surrogate + UCB acquisition
                            (the paper's black-box sampler, batched);
  * ``search_nsga2``      — NSGA-II-lite evolutionary loop (rank +
                            crowding selection, log2-space crossover /
                            mutation, nearest-valid-point repair).

``sweep_design_space`` returns the cross-layer Pareto surface over
(throughput, cost, power).  Costs there exclude the OCS component (it
needs the derived physical topology); ``refine_top_points`` re-derives
exact topologies and OCS-inclusive costs for the winners — vectorized
by default (one batched call + memoized ``derive_physical`` for all
top-K points), with the scalar oracle kept as the parity reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost import cluster_cost
from repro_torch.core.hardware import HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.workload import Workload
from repro_torch.dse.batched_sim import MCMBatch, batched_simulate
from repro_torch.dse.pareto import (crowding_distance, nondominated_sort,
                              pareto_mask)
from repro_torch.dse.space import (DesignSpace, P_IDX, P_ORDER, StrategyBatch,
                             enumerate_strategy_batch)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span

Objective = Tuple[str, bool]          # (result field, maximize?)
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (("throughput", True),
                                             ("power", False))


# ---------------------------------------------------------------------------
# Cached batched evaluation
# ---------------------------------------------------------------------------
_RESULT_FIELDS = ("feasible", "step_time", "throughput", "mfu", "power")


class BatchedEvaluator:
    """Batched evaluate with a design-point cache for one (workload, MCM,
    fabric, reuse) cell.  ``cost`` is the topology-independent cluster
    cost of the cell (constant across strategies; OCS excluded).

    The cache is vectorized: each point's six strategy integers are
    bit-packed into one uint64 key (column widths adapt to the values
    seen, repacking when they grow), membership is one ``searchsorted``
    over the sorted cached keys, and values live in one (N, 5) float
    matrix — no per-row Python on the hit path.  If the packed widths
    ever exceed 64 bits (absurd degrees), it degrades to the exact
    dict-of-tuples path."""

    def __init__(self, w: Workload, mcm: MCMArch, fabric: str = "oi",
                 reuse: bool = True, hw: Optional[HW] = None,
                 device="cuda", alloc_mode: str = "chiplight"):
        self.w = w
        self.mcm = mcm
        self.fabric = fabric
        self.reuse = reuse
        self.hw = hw or mcm.hw
        self.device = device
        self.alloc_mode = alloc_mode
        self.cost = cluster_cost(mcm, None, fabric=fabric, hw=self.hw).total
        self.n_sim = 0
        self.n_hits = 0
        self.n_fallback = 0       # rows served by the exact dict path
        self._ccols = np.zeros((0, 6), np.int64)   # raw key columns
        self._ckeys = np.zeros(0, np.uint64)       # packed, insertion order
        self._cvals = np.zeros((0, len(_RESULT_FIELDS)))
        self._corder = np.zeros(0, np.int64)       # argsort of _ckeys
        self._cmax = np.zeros(6, np.int64)         # per-column max seen
        self._shifts: Optional[np.ndarray] = None
        self._fallback: Optional[Dict[Tuple[int, ...], np.ndarray]] = None

    def stats(self) -> Dict[str, int]:
        """Bit-packed cache counters (``repro_torch.obs`` metric names):
        ``dse.cache.sim`` simulator rows spent, ``dse.cache.hits``
        rows served from cache, ``dse.cache.fallback_rows`` rows that
        took the exact dict path (packed widths > 64 bits)."""
        return {"dse.cache.sim": self.n_sim,
                "dse.cache.hits": self.n_hits,
                "dse.cache.fallback_rows": self.n_fallback}

    # -- uint64 key packing ------------------------------------------------
    def _ensure_widths(self, cols: np.ndarray) -> bool:
        """Adapt column bit widths to ``cols``; returns False when the
        values cannot be packed (switches to the dict fallback)."""
        if len(cols) and cols.min() < 0:   # uint64 cast would wrap and
            return False                   # could collide packed keys
        mx = np.maximum(self._cmax, cols.max(0)) if len(cols) else self._cmax
        if self._shifts is not None and (mx <= self._cmax).all():
            return True
        widths = np.array([max(int(v).bit_length(), 1) for v in mx],
                          np.int64)
        if int(widths.sum()) > 64:
            return False
        self._cmax = mx
        self._shifts = np.concatenate([[0], np.cumsum(widths)[:-1]]) \
            .astype(np.uint64)
        if len(self._ccols):                       # repack under new widths
            self._ckeys = self._pack(self._ccols)
            self._corder = np.argsort(self._ckeys, kind="stable")
        return True

    def _pack(self, cols: np.ndarray) -> np.ndarray:
        key = np.zeros(len(cols), np.uint64)
        u = cols.astype(np.uint64)
        for j in range(6):
            key |= u[:, j] << self._shifts[j]
        return key

    def _lookup(self, qkeys: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(hit mask, cache rows for the hits) for packed query keys."""
        nk = len(self._ckeys)
        if nk == 0:
            return np.zeros(len(qkeys), bool), np.zeros(0, np.int64)
        skeys = self._ckeys[self._corder]
        pos = np.minimum(np.searchsorted(skeys, qkeys), nk - 1)
        hit = skeys[pos] == qkeys
        return hit, self._corder[pos[hit]]

    # -- evaluation --------------------------------------------------------
    def evaluate(self, batch: StrategyBatch) -> Dict[str, np.ndarray]:
        B = len(batch)
        cols = np.stack([batch.tp, batch.dp, batch.pp, batch.cp,
                         batch.ep, batch.n_micro], 1) if B else \
            np.zeros((0, 6), np.int64)
        if self._fallback is None and not self._ensure_widths(cols):
            self._to_fallback()
        if self._fallback is not None:
            return self._evaluate_fallback(batch, cols)

        out = np.empty((B, len(_RESULT_FIELDS)))
        qkeys = self._pack(cols)
        hit, rows = self._lookup(qkeys)
        nh = int(hit.sum())
        self.n_hits += nh
        if nh:
            obs_metrics.inc("dse.cache.hits", nh)
        out[hit] = self._cvals[rows]
        miss = np.nonzero(~hit)[0]
        if len(miss):
            sub = batch.take(miss)
            res = batched_simulate(self.w, sub, self.mcm, self.fabric,
                                   self.reuse, self.hw, self.device,
                                   alloc_mode=self.alloc_mode)
            self.n_sim += len(sub)
            obs_metrics.inc("dse.cache.sim", len(sub))
            vals = np.stack([np.asarray(getattr(res, f), np.float64)
                             for f in _RESULT_FIELDS], 1)
            out[miss] = vals
            # duplicate keys inside one batch agree — keep the first
            _, first = np.unique(qkeys[miss], return_index=True)
            self._ccols = np.concatenate([self._ccols, cols[miss][first]])
            self._ckeys = np.concatenate([self._ckeys, qkeys[miss][first]])
            self._cvals = np.concatenate([self._cvals, vals[first]])
            self._corder = np.argsort(self._ckeys, kind="stable")
        return self._metrics_from(out, B)

    def _metrics_from(self, out: np.ndarray, B: int
                      ) -> Dict[str, np.ndarray]:
        m = {f: out[:, j].copy() for j, f in enumerate(_RESULT_FIELDS)}
        m["feasible"] = out[:, 0] != 0.0
        m["cost"] = np.full(B, self.cost)
        return m

    # -- exact dict path for unpackable values -----------------------------
    def _to_fallback(self):
        self._fallback = {tuple(r): self._cvals[i]
                          for i, r in enumerate(self._ccols.tolist())}

    def _evaluate_fallback(self, batch: StrategyBatch, cols: np.ndarray
                           ) -> Dict[str, np.ndarray]:
        keys = [tuple(r) for r in cols.tolist()]
        miss = [i for i, k in enumerate(keys) if k not in self._fallback]
        self.n_hits += len(keys) - len(miss)
        self.n_fallback += len(keys)
        obs_metrics.inc("dse.cache.fallback_rows", len(keys))
        if len(keys) > len(miss):
            obs_metrics.inc("dse.cache.hits", len(keys) - len(miss))
        out = np.empty((len(keys), len(_RESULT_FIELDS)))
        if miss:
            sub = batch.take(np.array(miss, np.int64))
            res = batched_simulate(self.w, sub, self.mcm, self.fabric,
                                   self.reuse, self.hw, self.device,
                                   alloc_mode=self.alloc_mode)
            self.n_sim += len(sub)
            obs_metrics.inc("dse.cache.sim", len(sub))
            vals = np.stack([np.asarray(getattr(res, f), np.float64)
                             for f in _RESULT_FIELDS], 1)
            for j, i in enumerate(miss):
                self._fallback[keys[i]] = vals[j]
        for i, k in enumerate(keys):
            out[i] = self._fallback[k]
        return self._metrics_from(out, len(keys))


@dataclass
class SearchResult:
    """Evaluated subset of one cell's strategy grid."""

    batch: StrategyBatch                  # evaluated points
    metrics: Dict[str, np.ndarray]        # feasible/step_time/... arrays
    grid_size: int                        # full candidate-grid size
    n_sim: int                            # simulator evaluations spent
    n_cache_hits: int

    @property
    def best(self) -> Optional[int]:
        t = self.metrics["throughput"]
        if not len(t) or not self.metrics["feasible"].any():
            return None
        return int(np.argmax(t))

    def pareto_indices(self,
                       objectives: Sequence[Objective] = DEFAULT_OBJECTIVES
                       ) -> np.ndarray:
        feas = self.metrics["feasible"]
        obj = np.stack([self.metrics[f] for f, _ in objectives], 1)
        obj = np.where(feas[:, None], obj, np.nan)
        return np.nonzero(pareto_mask(obj, [m for _, m in objectives]))[0]


def _result(ev: BatchedEvaluator, grid: StrategyBatch, idx: np.ndarray
            ) -> SearchResult:
    sub = grid.take(idx)
    return SearchResult(batch=sub, metrics=ev.evaluate(sub),
                        grid_size=len(grid), n_sim=ev.n_sim,
                        n_cache_hits=ev.n_hits)


# ---------------------------------------------------------------------------
# Driver steppers — the engine-agnostic driver cores
# ---------------------------------------------------------------------------
# A stepper is a generator over ONE cell grid: it yields int64 arrays of
# candidate grid indices, receives their metrics dict via .send(), and
# returns the final evaluated index set via StopIteration.value.

def _random_indices(n: int, budget: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.permutation(n)[: min(budget, n)])


def _stepper_random(grid: StrategyBatch, budget: int, seed: int = 0):
    idx = _random_indices(len(grid), budget, seed)
    if len(idx):
        yield idx
    return idx


def _stepper_prf(grid: StrategyBatch, budget: int, seed: int = 0,
                 batch_size: int = 16, kappa: float = 1.0):
    """Batched PRF-UCB: random init, then acquire top-UCB *batches*."""
    from repro_torch.core.prf import PRF
    n = len(grid)
    budget = min(budget, n)
    rng = np.random.default_rng(seed)
    feats = grid.features()
    tried = list(rng.permutation(n)[: max(min(budget // 2, n), 1)])
    m = yield np.array(tried, np.int64)
    scores = list(m["throughput"])
    while len(tried) < budget:
        rest = np.setdiff1d(np.arange(n), np.array(tried))
        if len(scores) >= 4:
            model = PRF(seed=int(rng.integers(1 << 30))).fit(
                feats[np.array(tried)], np.array(scores))
            ucb = model.ucb(feats[rest], kappa=kappa)
            order = rest[np.argsort(-ucb)]
        else:
            order = rng.permutation(rest)
        pick = order[: min(batch_size, budget - len(tried))]
        got = (yield np.asarray(pick, np.int64))["throughput"]
        tried.extend(int(i) for i in pick)
        scores.extend(got)
    return np.array(tried, np.int64)


def _stepper_nsga2(grid: StrategyBatch, pop_size: int = 32,
                   generations: int = 12, seed: int = 0,
                   objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                   mutation_p: float = 0.3):
    """NSGA-II-lite over the valid strategy grid.

    Genomes are grid indices; crossover/mutation act in log2-degree
    space and land back on the grid via nearest-valid-point repair, so
    every individual is a real (mappable) design point.  The cache makes
    revisits free."""
    n = len(grid)
    if n == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    feats = grid.features()                      # (n, 6) log2 coords
    pop = rng.permutation(n)[: min(pop_size, n)]
    seen = set(int(i) for i in pop)
    maximize = [mx for _, mx in objectives]

    def rank_crowd(m: Dict[str, np.ndarray], k: int):
        obj = np.stack([m[f] for f, _ in objectives], 1)
        obj = np.where(np.asarray(m["feasible"], bool)[:, None], obj,
                       np.nan)
        ranks = nondominated_sort(obj, maximize)
        crowd = np.zeros(k)
        for r in np.unique(ranks):
            sel = ranks == r
            if r >= k or sel.sum() == 0:
                continue
            sub = np.nan_to_num(obj[sel], nan=-np.inf)
            crowd[sel] = crowding_distance(sub, maximize)
        return ranks, crowd

    def repair(coords: np.ndarray) -> np.ndarray:
        """Nearest valid grid point (L1 in log2 space) per child row."""
        d = np.abs(feats[None, :, :] - coords[:, None, :]).sum(-1)
        return np.argmin(d, 1)

    for _ in range(generations):
        m = yield np.asarray(pop, np.int64)
        ranks, crowd = rank_crowd(m, len(pop))

        def tourney() -> int:
            a, b = rng.integers(len(pop), size=2)
            if (ranks[a], -crowd[a]) <= (ranks[b], -crowd[b]):
                return a
            return b

        children = []
        for _ in range(len(pop)):
            pa, pb = feats[pop[tourney()]], feats[pop[tourney()]]
            mask = rng.random(feats.shape[1]) < 0.5
            child = np.where(mask, pa, pb)
            if rng.random() < mutation_p:
                j = rng.integers(feats.shape[1])
                child[j] += rng.choice([-1.0, 1.0])
            children.append(child)
        kid_idx = repair(np.stack(children))
        union = np.unique(np.concatenate([pop, kid_idx]))
        seen.update(int(i) for i in kid_idx)
        mu = yield np.asarray(union, np.int64)
        ranks_u, crowd_u = rank_crowd(mu, len(union))
        order = np.lexsort((-crowd_u, ranks_u))
        pop = union[order[: min(pop_size, len(union))]]

    return np.array(sorted(seen), np.int64)


def _drive(ev: BatchedEvaluator, grid: StrategyBatch, gen) -> SearchResult:
    """Run one stepper against one cell evaluator."""
    try:
        req = next(gen)
        while True:
            m = ev.evaluate(grid.take(np.asarray(req, np.int64)))
            req = gen.send(m)
    except StopIteration as e:
        final = np.asarray(e.value, np.int64)
    return _result(ev, grid, final)


# ---------------------------------------------------------------------------
# Per-cell drivers (public API, unchanged signatures)
# ---------------------------------------------------------------------------
def search_exhaustive(ev: BatchedEvaluator,
                      grid: Optional[StrategyBatch] = None) -> SearchResult:
    grid = grid if grid is not None else enumerate_strategy_batch(
        ev.w, ev.mcm)
    return _result(ev, grid, np.arange(len(grid)))


def search_random(ev: BatchedEvaluator, budget: int, seed: int = 0,
                  grid: Optional[StrategyBatch] = None) -> SearchResult:
    grid = grid if grid is not None else enumerate_strategy_batch(
        ev.w, ev.mcm)
    return _result(ev, grid, _random_indices(len(grid), budget, seed))


def search_prf_ucb(ev: BatchedEvaluator, budget: int, seed: int = 0,
                   batch_size: int = 16, kappa: float = 1.0,
                   grid: Optional[StrategyBatch] = None) -> SearchResult:
    grid = grid if grid is not None else enumerate_strategy_batch(
        ev.w, ev.mcm)
    return _drive(ev, grid, _stepper_prf(grid, budget, seed=seed,
                                         batch_size=batch_size,
                                         kappa=kappa))


def search_nsga2(ev: BatchedEvaluator, pop_size: int = 32,
                 generations: int = 12, seed: int = 0,
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                 mutation_p: float = 0.3,
                 grid: Optional[StrategyBatch] = None) -> SearchResult:
    grid = grid if grid is not None else enumerate_strategy_batch(
        ev.w, ev.mcm)
    if len(grid) == 0:
        return _result(ev, grid, np.arange(0))
    return _drive(ev, grid, _stepper_nsga2(grid, pop_size=pop_size,
                                           generations=generations,
                                           seed=seed, objectives=objectives,
                                           mutation_p=mutation_p))


DRIVERS: Dict[str, Callable] = {
    "exhaustive": search_exhaustive,
    "random": search_random,
    "prf": search_prf_ucb,
    "nsga2": search_nsga2,
}

_STEPPERS: Dict[str, Callable] = {
    "random": _stepper_random,
    "prf": _stepper_prf,
    "nsga2": _stepper_nsga2,
}


# ---------------------------------------------------------------------------
# Cross-layer sweep over a DesignSpace
# ---------------------------------------------------------------------------
@dataclass
class SweepResult:
    """Concatenated evaluations across every (MCM, fabric) cell."""

    space: DesignSpace
    batch: StrategyBatch
    mcm_idx: np.ndarray            # (B,) index into space.mcms
    fabric: np.ndarray             # (B,) str
    metrics: Dict[str, np.ndarray]
    n_sim: int = 0
    n_cache_hits: int = 0
    elapsed_s: float = 0.0

    def __len__(self) -> int:
        return len(self.batch)

    @property
    def best(self) -> Optional[int]:
        if not len(self) or not self.metrics["feasible"].any():
            return None
        return int(np.argmax(self.metrics["throughput"]))

    def pareto_indices(self) -> np.ndarray:
        """Non-dominated set over (throughput max, cost min, power min)."""
        feas = self.metrics["feasible"]
        obj = np.stack([self.metrics["throughput"], self.metrics["cost"],
                        self.metrics["power"]], 1)
        obj = np.where(feas[:, None], obj, np.nan)
        mask = pareto_mask(obj, [True, False, False])
        idx = np.nonzero(mask)[0]
        return idx[np.argsort(-self.metrics["throughput"][idx])]

    def describe(self, i: int) -> Dict:
        b = self.batch
        mcm = self.space.mcms[int(self.mcm_idx[i])]
        return {
            "strategy": {"TP": int(b.tp[i]), "DP": int(b.dp[i]),
                         "PP": int(b.pp[i]), "CP": int(b.cp[i]),
                         "EP": int(b.ep[i]), "n_micro": int(b.n_micro[i])},
            "mcm": {"n_mcm": mcm.n_mcm, "x": mcm.x, "y": mcm.y, "m": mcm.m,
                    "cpo_ratio": mcm.cpo_ratio},
            "fabric": str(self.fabric[i]),
            "throughput_tok_s": float(self.metrics["throughput"][i]),
            "step_time_s": float(self.metrics["step_time"][i]),
            "mfu": float(self.metrics["mfu"][i]),
            "cost_usd": float(self.metrics["cost"][i]),
            "power_w": float(self.metrics["power"][i]),
        }


def _empty_sweep(space: DesignSpace, elapsed: float) -> SweepResult:
    empty = StrategyBatch.from_strategies([])
    return SweepResult(space, empty, np.zeros(0, np.int64),
                       np.zeros(0, "<U8"),
                       {f: np.zeros(0) for f in
                        (*_RESULT_FIELDS, "cost")}, 0, 0, elapsed)


def _sweep_fused(space: DesignSpace, device) -> SweepResult:
    """Exhaustive sweep as ONE batched_simulate call per fabric: the
    strategy grids of every MCM variant are concatenated and evaluated
    against an ``MCMBatch`` of per-point parameters — no per-cell
    Python, which is what makes small-grid model configs fast too."""
    import time
    t0 = time.perf_counter()
    mcm_pos = {id(m): i for i, m in enumerate(space.mcms)}
    cells = list(space.batches())
    # one batched call per (fabric, hw): a hand-built DesignSpace may
    # mix HW configs across MCM variants
    by_group: Dict[Tuple[str, int], List] = {}
    for mcm, fabric, grid in cells:
        by_group.setdefault((fabric, id(mcm.hw)), []).append((mcm, grid))
    batches, mcm_idx, fabric_col, metric_parts, n_sim = [], [], [], [], 0
    for (fabric, _), sub in by_group.items():
        batch = StrategyBatch.concat([g for _, g in sub])
        local = np.concatenate([np.full(len(g), i, np.int64)
                                for i, (_, g) in enumerate(sub)])
        mcms = [m for m, _ in sub]
        res = batched_simulate(space.workload, batch,
                               MCMBatch.from_mcms(mcms, local),
                               fabric=fabric, reuse=space.reuse,
                               hw=mcms[0].hw, device=device,
                               alloc_mode=space.alloc_mode)
        costs = np.array([cluster_cost(m, None, fabric=fabric,
                                       hw=m.hw).total for m in mcms])[local]
        batches.append(batch)
        mcm_idx.append(np.array([mcm_pos[id(m)] for m in mcms],
                                np.int64)[local])
        fabric_col.append(np.full(len(batch), fabric))
        metric_parts.append({**{f: np.asarray(getattr(res, f))
                                for f in _RESULT_FIELDS}, "cost": costs})
        n_sim += len(batch)
    elapsed = time.perf_counter() - t0
    if not batches:
        return _empty_sweep(space, elapsed)
    metrics = {f: np.concatenate([p[f] for p in metric_parts])
               for f in (*_RESULT_FIELDS, "cost")}
    return SweepResult(space, StrategyBatch.concat(batches),
                       np.concatenate(mcm_idx),
                       np.concatenate(fabric_col), metrics,
                       n_sim=n_sim, n_cache_hits=0, elapsed_s=elapsed)


class _FusedEvaluator:
    """Cross-cell evaluator over the concatenated grids of every
    (MCM, fabric) cell: rows are GLOBAL indices, the cache is a
    row-indexed value matrix (exact — no hashing needed), and every
    evaluate round issues one ``batched_simulate`` per fabric spanning
    all touched cells via ``MCMBatch``."""

    def __init__(self, space: DesignSpace,
                 cells: List[Tuple[int, str, StrategyBatch]],
                 device="cuda"):
        self.space = space
        self.device = device
        grids = [g for _, _, g in cells]
        sizes = np.array([len(g) for g in grids], np.int64)
        self.batch = StrategyBatch.concat(grids)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]) \
            .astype(np.int64)
        cell_of = np.repeat(np.arange(len(cells)), sizes)
        self.mcm_idx = np.array([mi for mi, _, _ in cells],
                                np.int64)[cell_of]
        self.fabric_names = sorted({fb for _, fb, _ in cells})
        fcode = {f: i for i, f in enumerate(self.fabric_names)}
        self.fabric_code = np.array([fcode[fb] for _, fb, _ in cells],
                                    np.int64)[cell_of]
        self.mb = MCMBatch.from_mcms(space.mcms, self.mcm_idx)
        cost_cell: Dict[Tuple[int, str], float] = {}
        for mi, fb, _ in cells:
            if (mi, fb) not in cost_cell:
                m = space.mcms[mi]
                cost_cell[(mi, fb)] = cluster_cost(m, None, fabric=fb,
                                                   hw=m.hw).total
        self.cost = np.array([cost_cell[(mi, fb)]
                              for mi, fb, _ in cells])[cell_of]
        n = len(self.batch)
        self._have = np.zeros(n, bool)
        self._vals = np.empty((n, len(_RESULT_FIELDS)))
        # a hand-built DesignSpace may mix HW configs across MCM
        # variants — simulate per (fabric, hw) group, not per fabric
        self.hw_objs: List[HW] = []
        code_cells = []
        for mi, _, _ in cells:
            h = space.mcms[mi].hw
            for j, ho in enumerate(self.hw_objs):
                if ho is h:
                    code_cells.append(j)
                    break
            else:
                code_cells.append(len(self.hw_objs))
                self.hw_objs.append(h)
        self.hw_code = np.array(code_cells, np.int64)[cell_of]
        self.n_sim = 0
        self.n_hits = 0

    def stats(self) -> Dict[str, int]:
        """Row-indexed cache counters, same names as
        ``BatchedEvaluator.stats`` (exact cache — no fallback path)."""
        return {"dse.cache.sim": self.n_sim,
                "dse.cache.hits": self.n_hits,
                "dse.cache.fallback_rows": 0}

    def evaluate_idx(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx, np.int64)
        nh = int(self._have[idx].sum())
        self.n_hits += nh
        if nh:
            obs_metrics.inc("dse.cache.hits", nh)
        miss = np.unique(idx[~self._have[idx]])
        for fc, fabric in enumerate(self.fabric_names):
            for hc, hw in enumerate(self.hw_objs):
                rows = miss[(self.fabric_code[miss] == fc)
                            & (self.hw_code[miss] == hc)]
                if not len(rows):
                    continue
                self._simulate_rows(rows, fabric, hw)
        out = {f: self._vals[idx, j].copy()
               for j, f in enumerate(_RESULT_FIELDS)}
        out["feasible"] = self._vals[idx, 0] != 0.0
        out["cost"] = self.cost[idx]
        return out

    def _simulate_rows(self, rows: np.ndarray, fabric: str, hw: HW):
        res = batched_simulate(self.space.workload,
                               self.batch.take(rows),
                               self.mb.take(rows), fabric=fabric,
                               reuse=self.space.reuse, hw=hw,
                               device=self.device,
                               alloc_mode=self.space.alloc_mode)
        self._vals[rows] = np.stack(
            [np.asarray(getattr(res, f), np.float64)
             for f in _RESULT_FIELDS], 1)
        self._have[rows] = True
        self.n_sim += len(rows)
        obs_metrics.inc("dse.cache.sim", len(rows))


def _sweep_with_driver(space: DesignSpace, driver: str, device,
                       seed: int, **driver_kw) -> SweepResult:
    """Drive every cell's stepper in lockstep rounds; each round's
    candidate batches from ALL cells are evaluated together (one
    batched_simulate per fabric)."""
    import time
    t0 = time.perf_counter()
    mcm_pos = {id(m): i for i, m in enumerate(space.mcms)}
    cells = [(mcm_pos[id(m)], fb, g) for m, fb, g in space.batches()]
    if not cells:
        return _empty_sweep(space, time.perf_counter() - t0)
    fev = _FusedEvaluator(space, cells, device)
    stepper = _STEPPERS[driver]
    gens: List = []
    reqs: Dict[int, np.ndarray] = {}
    finals: Dict[int, np.ndarray] = {}
    for ci, (_, _, grid) in enumerate(cells):
        kw = dict(driver_kw)
        kw.setdefault("seed", seed + ci)
        gen = stepper(grid, **kw)
        gens.append(gen)
        try:
            reqs[ci] = np.asarray(next(gen), np.int64)
        except StopIteration as e:
            finals[ci] = np.asarray(e.value, np.int64)
    n_round = 0
    while reqs:
        order = sorted(reqs)
        glob = np.concatenate([fev.offsets[ci] + reqs[ci]
                               for ci in order])
        with span("sweep.round", driver=driver, round=n_round,
                  rows=len(glob), cells=len(order)):
            m = fev.evaluate_idx(glob)
            nxt: Dict[int, np.ndarray] = {}
            pos = 0
            for ci in order:
                ln = len(reqs[ci])
                sl = {k: v[pos:pos + ln] for k, v in m.items()}
                pos += ln
                try:
                    nxt[ci] = np.asarray(gens[ci].send(sl), np.int64)
                except StopIteration as e:
                    finals[ci] = np.asarray(e.value, np.int64)
        reqs = nxt
        n_round += 1
    glob_final = np.concatenate([fev.offsets[ci] + finals[ci]
                                 for ci in range(len(cells))])
    metrics = fev.evaluate_idx(glob_final)          # all cache hits
    fabric = np.array(fev.fabric_names)[fev.fabric_code[glob_final]]
    return SweepResult(space, fev.batch.take(glob_final),
                       fev.mcm_idx[glob_final], fabric, metrics,
                       n_sim=fev.n_sim, n_cache_hits=fev.n_hits,
                       elapsed_s=time.perf_counter() - t0)


def sweep_design_space(space: DesignSpace, driver: str = "exhaustive",
                       device="cuda", seed: int = 0,
                       **driver_kw) -> SweepResult:
    """Run one driver over every (MCM, fabric) cell and concatenate;
    the batched simulator's cost terms run on ``device``.
    Every driver takes a fused cross-variant path: the exhaustive case
    is one batched call per fabric, the budgeted drivers run their
    per-cell steppers in lockstep with fused per-round evaluation."""
    if driver == "exhaustive":
        with span("sweep", driver=driver):
            return _sweep_fused(space, device)
    if driver not in _STEPPERS:
        raise KeyError(f"unknown driver {driver!r}; known: "
                       f"{['exhaustive', *sorted(_STEPPERS)]}")
    with span("sweep", driver=driver):
        return _sweep_with_driver(space, driver, device, seed,
                                  **driver_kw)


# ---------------------------------------------------------------------------
# Refinement: exact topologies + OCS-inclusive costs for the winners
# ---------------------------------------------------------------------------
def refine_top_points(sweep: SweepResult, top_k: int = 8,
                      method: str = "batched", device="cuda"):
    """Re-evaluate the best sweep points with real OI topologies and
    exact (OCS-inclusive) costs.  Returns ``core.optimizer.DesignPoint``
    objects, best-first.

    ``method="batched"`` (default) derives everything vectorized: one
    ``batched_simulate`` over all top-K rows per fabric plus the
    memoized ``derive_physical`` front-end.  ``method="scalar"`` is the
    original per-point ``evaluate_point`` loop, kept as the parity
    reference (same points, same topologies, metrics to 1e-9).  A
    ``railx`` sweep refines through the RailX oracle
    (``railx_evaluate_point``) under either method.  The batched
    method's simulator terms run on ``device``."""
    feas = np.nonzero(sweep.metrics["feasible"])[0]
    order = feas[np.argsort(-sweep.metrics["throughput"][feas])][:top_k]
    out = refine_sweep_rows(sweep, order, method=method, device=device)
    out.sort(key=lambda p: -p.throughput)
    return out


def refine_sweep_rows(sweep: SweepResult, rows, method: str = "batched",
                      device="cuda") -> List:
    """Give the given sweep rows the full scalar treatment (derived
    topology, exact OCS-inclusive cost), preserving row order; rows that
    are infeasible or whose physical rails cannot be derived are skipped
    (not reordered).  The population outer search uses this to refine
    per-variant winners in one call."""
    rows = np.asarray(rows, np.int64)
    with span("refine", rows=len(rows), method=method):
        if sweep.space.alloc_mode == "railx":
            return _refine_railx(sweep, rows)
        if method == "scalar":
            return _refine_scalar(sweep, rows)
        if method == "batched":
            return _refine_batched(sweep, rows, device)
    raise ValueError(f"unknown refine method {method!r}; "
                     f"use 'batched' or 'scalar'")


def refine_cell_rows(w: Workload, mcm: MCMArch, batch: StrategyBatch,
                     rows, fabric: str = "oi", reuse: bool = True,
                     hw: Optional[HW] = None,
                     method: str = "batched", device="cuda") -> List:
    """Vectorized scalar-treatment of ``rows`` of ONE cell's strategy
    grid (the inner search's refinement step), row order preserved."""
    import dataclasses
    hw = hw or mcm.hw
    if hw is not mcm.hw:
        mcm = dataclasses.replace(mcm, hw=hw)
    space = DesignSpace(workload=w, mcms=(mcm,), fabrics=(fabric,),
                        reuse=reuse)
    n = len(batch)
    sweep = SweepResult(space, batch, np.zeros(n, np.int64),
                        np.full(n, fabric), metrics={})
    return refine_sweep_rows(sweep, rows, method=method, device=device)


def _refine_scalar(sweep: SweepResult, order: np.ndarray) -> List:
    from repro_torch.core.optimizer import evaluate_point   # lazy: no cycle
    out = []
    for i in order:
        mcm = sweep.space.mcms[int(sweep.mcm_idx[i])]
        s = sweep.batch.take(np.array([i])).to_strategies()[0]
        pt = evaluate_point(sweep.space.workload, s, mcm,
                            fabric=str(sweep.fabric[i]),
                            reuse=sweep.space.reuse)
        if pt is not None:
            out.append(pt)
    return out


def _refine_railx(sweep: SweepResult, order: np.ndarray) -> List:
    """RailX refinement: the scalar RailX oracle per top row (the rail
    grouping search is combinatorial; top-K is small)."""
    from repro_torch.core.optimizer import railx_evaluate_point  # lazy: no cycle
    out = []
    for i in order:
        mcm = sweep.space.mcms[int(sweep.mcm_idx[i])]
        s = sweep.batch.take(np.array([i])).to_strategies()[0]
        pt = railx_evaluate_point(sweep.space.workload, s, mcm,
                                  reuse=sweep.space.reuse, hw=mcm.hw)
        if pt is not None:
            out.append(pt)
    return out


# ---------------------------------------------------------------------------
# Event-replay re-rank: schedule as a search dimension
# ---------------------------------------------------------------------------
def event_rerank_rows(sweep: SweepResult, rows,
                      candidates: Sequence[Tuple[str, int]],
                      device="cuda") -> Dict[str, np.ndarray]:
    """Re-rank the given sweep rows by event-replay step time.

    Compiles the rows ONCE per ``(schedule, virtual_chunks)`` candidate
    through ``events.compile_batch`` (vectorized — no per-record DAG
    walks) and replays them all; each row's winner is the candidate with
    the smallest event step time.  Returns per-row arrays —
    ``step_time`` (inf where no candidate is feasible), ``schedule``,
    ``v`` (the per-row CLAMPED interleave depth of the winner),
    ``candidate`` (index into ``candidates``) — plus ``order``: row
    POSITIONS (indices into ``rows``) sorted best-first by event step
    time, which is what ``Study.run``'s ``study.event_rerank`` stage
    feeds to ``refine_sweep_rows``.  The compiled rows' analytic terms
    and the wavefront run on ``device``."""
    from repro_torch.events import compile_batch       # lazy: no cycle
    rows = np.asarray(rows, np.int64)
    N = len(rows)
    cands = tuple(candidates)
    if not cands:
        raise ValueError("event_rerank_rows needs at least one "
                         "(schedule, virtual_chunks) candidate")
    sub = sweep.batch.take(rows)
    midx = np.asarray(sweep.mcm_idx)[rows]
    mcms = [sweep.space.mcms[int(i)] for i in midx]
    fabs = [str(f) for f in np.asarray(sweep.fabric)[rows]]
    w = sweep.space.workload
    steps = np.full((len(cands), N), np.inf)
    vs = np.ones((len(cands), N), np.int64)
    for ci, (sched, v) in enumerate(cands):
        cb = compile_batch(w, sub, mcms, fabric=fabs,
                           reuse=sweep.space.reuse, schedule=sched,
                           virtual_chunks=v, device=device)
        steps[ci] = cb.replay(device=device)["step_time"]
        vs[ci] = cb.v
    win = np.argmin(steps, axis=0)
    pos = np.arange(N)
    step = steps[win, pos]
    return {
        "step_time": step,
        "candidate": win,
        "schedule": np.array([cands[int(c)][0] for c in win]),
        "v": vs[win, pos],
        "order": np.argsort(step, kind="stable"),
    }


_SIM_COLS = ("feasible", "step_time", "throughput", "mfu", "t_comp",
             "t_mem", "t_coll", "exposed", "dp_exposed", "bubble",
             "reuse_active")


def _refine_batched(sweep: SweepResult, order: np.ndarray,
                    device) -> List:
    """Vectorized refinement of the given sweep rows.

    Mirrors ``core.optimizer.evaluate_point`` per row: traffic, reuse
    pair, link allocation and the simulator terms come from the batched
    engine (one call per fabric, heterogeneous MCMs via ``MCMBatch``);
    physical-rail derivation goes through the memoized
    ``derive_physical`` front-end; rows whose reuse-pair topology is
    underivable fall back to the no-reuse allocation (second batched
    call), and rows with no derivable topology at all are dropped —
    exactly the scalar semantics."""
    from repro_torch.core.network import derive_physical_batch  # lazy: no cycle
    from repro_torch.dse.batched_sim import (allocate_links_batch,
                                       map_intra_batch, pick_reuse_pairs,
                                       traffic_volumes_batch)
    w = sweep.space.workload
    out: List = []
    if not len(order):
        return out
    fabs = [str(f) for f in np.asarray(sweep.fabric)[order]]
    hws = [sweep.space.mcms[int(sweep.mcm_idx[i])].hw for i in order]
    groups: Dict[Tuple[str, int], List[int]] = {}
    for i, (f, h) in enumerate(zip(fabs, hws)):   # per (fabric, hw) —
        groups.setdefault((f, id(h)), []).append(i)   # hw may vary in a
    for (fabric, _), posns in groups.items():         # hand-built space
        rows = order[posns]
        K = len(rows)
        sub = sweep.batch.take(rows)
        midx = np.asarray(sweep.mcm_idx[rows], np.int64)
        mcms = [sweep.space.mcms[int(i)] for i in midx]
        hw = hws[posns[0]]
        mb = MCMBatch.from_mcms(sweep.space.mcms, midx)
        res = batched_simulate(w, sub, mb, fabric=fabric,
                               reuse=sweep.space.reuse, hw=hw,
                               device=device)
        cols = {f: np.array(getattr(res, f), copy=True)
                for f in _SIM_COLS}

        _, intra, inter = map_intra_batch(sub, mb)
        vols = traffic_volumes_batch(w, sub)
        inter_mask = (inter > 1) & (vols > 0)
        topos: List = [None] * K
        degs: List[Dict[str, int]] = [{} for _ in range(K)]
        cands: List[Optional[Tuple[str, str]]] = [None] * K
        if fabric == "oi":
            if sweep.space.reuse:
                pa, pb = pick_reuse_pairs(vols, inter_mask)
            else:
                pa = pb = np.full(K, -1, np.int64)
            alloc = allocate_links_batch(vols, inter_mask, mb.total_links,
                                         pa, pb)
            degs, allocs, pairs = _topo_inputs(inter, inter_mask, alloc,
                                               pa, pb)
            cands = list(pairs)
            topos = derive_physical_batch(list(zip(degs, allocs, pairs)),
                                          mcms, hw)
            # reuse-pair derivation failures: no-reuse allocation + sim
            fb_rows = np.array([k for k in range(K)
                                if topos[k] is None
                                and pairs[k] is not None], np.int64)
            if len(fb_rows):
                mb_fb = mb.take(fb_rows)
                none_pair = np.full(len(fb_rows), -1, np.int64)
                alloc_nr = allocate_links_batch(
                    vols[fb_rows], inter_mask[fb_rows], mb_fb.total_links,
                    none_pair, none_pair)
                d_fb, a_fb, p_fb = _topo_inputs(
                    inter[fb_rows], inter_mask[fb_rows], alloc_nr,
                    none_pair, none_pair)
                t_fb = derive_physical_batch(
                    list(zip(d_fb, a_fb, p_fb)),
                    [mcms[int(k)] for k in fb_rows], hw)
                res_nr = batched_simulate(w, sub.take(fb_rows), mb_fb,
                                          fabric=fabric, reuse=False,
                                          hw=hw, device=device)
                for j, k in enumerate(fb_rows):
                    topos[int(k)] = t_fb[j]
                    # the scalar oracle re-simulates with the no-reuse
                    # topology, so its logs see no candidate either
                    cands[int(k)] = None
                for f in _SIM_COLS:
                    cols[f][fb_rows] = np.asarray(getattr(res_nr, f))

        out.extend(_assemble_points(w, sub, mb, cols, fabric, hw, mcms,
                                    topos, degs, intra, vols, inter_mask,
                                    cands))
    return out


def _topo_inputs(inter: np.ndarray, inter_mask: np.ndarray,
                 alloc: np.ndarray, pa: np.ndarray, pb: np.ndarray
                 ) -> Tuple[List[Dict[str, int]], List[Dict[str, int]],
                            List[Optional[Tuple[str, str]]]]:
    """Per-row (inter degrees, link alloc, reuse pair) dicts, with keys
    in the scalar path's insertion order (``map_intra``'s inter dict:
    DP, PP, CP, EP) so memoized derivation tie-breaks identically."""
    K = inter.shape[0]
    inter_l = inter.tolist()
    mask_l = inter_mask.tolist()
    alloc_l = alloc.tolist()
    degs, allocs, pairs = [], [], []
    cols = [(p, P_IDX[p]) for p in ("DP", "PP", "CP", "EP")]
    for k in range(K):
        degs.append({p: int(inter_l[k][j]) for p, j in cols
                     if inter_l[k][j] > 1})
        allocs.append({p: int(alloc_l[k][j]) for p, j in cols
                       if mask_l[k][j]})
        pairs.append((P_ORDER[pa[k]], P_ORDER[pb[k]])
                     if pa[k] >= 0 else None)
    return degs, allocs, pairs


def _assemble_points(w, sub, mb, cols, fabric, hw, mcms, topos, degs,
                     intra, vols, inter_mask, cands=None) -> List:
    """Build scalar ``DesignPoint``s from the batched refinement arrays
    (breakdown / bottleneck / logs mirror ``core.simulator.simulate``)."""
    from repro_torch.core.optimizer import DesignPoint      # lazy: no cycle
    from repro_torch.core.simulator import SimResult
    from repro_torch.dse.batched_sim import gemm_eff_batch, hbm_demand_batch
    K = len(sub)
    step = cols["step_time"]
    t_comp, t_mem, t_coll = cols["t_comp"], cols["t_mem"], cols["t_coll"]
    exposed, dp_exposed = cols["exposed"], cols["dp_exposed"]
    with np.errstate(invalid="ignore"):
        util = np.where(cols["feasible"], t_comp / step, 0.0)
    eff = gemm_eff_batch(w, sub, hw) if hw.model_gemm_eff \
        else np.ones(K)
    demand, _ = hbm_demand_batch(w, sub)      # same exprs as the gate
    mem_pressure = demand / np.broadcast_to(
        np.asarray(mb.hbm_capacity, np.float64), (K,))

    strategies = sub.to_strategies()
    cands = cands if cands is not None else [None] * K
    pidx = lambda pr, j: float(P_IDX[pr[j]]) if pr else -1.0
    out = []
    for k in range(K):
        if not cols["feasible"][k]:
            continue
        if topos[k] is None and degs[k]:
            continue                       # no derivable physical rails
        # collective-term key order mirrors simulate(): intra dict
        # order (TP, the packed group, DP) then inter_vols (DP/PP/CP/EP)
        order_p = [p for p in ("TP", "CP", "EP", "PP", "DP")
                   if intra[k, P_IDX[p]] > 1 and vols[k, P_IDX[p]] > 0]
        order_p += [p for p in ("DP", "PP", "CP", "EP")
                    if inter_mask[k, P_IDX[p]] and p not in order_p]
        terms = {"compute": float(t_comp[k]), "memory": float(t_mem[k]),
                 **{f"coll_{p}": float(t_coll[k, P_IDX[p]])
                    for p in order_p}}
        nop_bound = any((p == "TP" or intra[k, P_IDX[p]] > 1)
                        and t_coll[k, P_IDX[p]] > t_comp[k]
                        for p in P_ORDER)
        active = bool(cols["reuse_active"][k])
        final = cands[k] if active else None
        logs = {
            "compute_util": float(util[k]),
            "gemm_eff": float(eff[k]),
            "mem_pressure": float(mem_pressure[k]),
            "exposed_comm": float(exposed[k] + dp_exposed[k]),
            "bubble": float(cols["bubble"][k]),
            "reuse_active": float(cols["reuse_active"][k]),
            "reuse_cand_a": pidx(cands[k], 0),
            "reuse_cand_b": pidx(cands[k], 1),
            "reuse_pair_a": pidx(final, 0),
            "reuse_pair_b": pidx(final, 1),
            "reuse_gated": float(cands[k] is not None and not active),
            "reuse_paper_mode": float(hw.ocs_reuse_mode == "paper"),
            "nop_bound": float(nop_bound),
            "oi_bound": float(fabric == "oi"
                              and exposed[k] + dp_exposed[k]
                              > 0.3 * step[k]),
            "hbm_bw_bound": float(t_mem[k] > t_comp[k]),
        }
        sim = SimResult(True, step_time=float(step[k]),
                        throughput=float(cols["throughput"][k]),
                        mfu=float(cols["mfu"][k]), breakdown=terms,
                        bottleneck=max(terms, key=terms.get), logs=logs)
        cost = cluster_cost(mcms[k], topos[k], fabric=fabric, hw=hw).total
        out.append(DesignPoint(strategy=strategies[k], mcm=mcms[k],
                               topo=topos[k], sim=sim, cost=cost,
                               fabric=fabric))
    return out
