"""Population-based batched outer search over MCM architecture (§IV-B).

The nested ChipLight flow wraps an outer search over the MCM
architecture (N, x, y, m, r) around the para-topo inner search.  The
single-walker form walks ONE architecture per outer iteration through
the bottleneck-driven planner — every inner search is a fresh scan, and
revisited architectures pay full price.  This module hosts the
population form:

  * W walkers each hold an architecture; every round, each walker's
    bottleneck-driven moves (``core.optimizer.propose_moves`` — the same
    §IV-B-3 heuristics) are generated up front, plus crossover between
    walkers and a random perturbation;
  * the round's candidate architectures are deduplicated by MCM-variant
    key and the NEW ones are evaluated together: their strategy grids
    ride in one fused ``sweep_design_space`` call per fabric (a single
    ``MCMBatch``, its cost terms on ``device``), and the vectorized
    ``refine_sweep_rows`` derives physical topologies and OCS-inclusive
    costs for each variant's winners in one batch;
  * an evaluation cache keyed by the MCM-variant key makes revisited
    architectures free;
  * each walker greedily adopts its best candidate (or stays);
  * optionally (``event_replay=K``), each round's candidate winners are
    compiled into ``StepProgram``s and replayed through ONE vectorized
    wavefront call on ``device`` (``repro_torch.events``: on the card,
    ``csrc/wavefront.cu``), and walkers adopt by the event-resolved
    throughput instead of the analytic one — the event engine as a
    first-class search objective.  Off by default: ``event_replay=0`` is
    bit-identical to the pre-hook search.

``method="scalar"`` is the original single-walker nested loop,
bit-identical to the pre-population ``chiplight_optimize`` for the same
seed (which is now a thin ``walkers=1, method="scalar"`` wrapper).

The walkers' randomness is numpy's generator on the host, so a walk is
the reference's walk step for step: each round's adoption compares the
device's throughputs, which equal numpy's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware import HW, DEFAULT_HW
from repro_torch.core.mcm import MCMArch, mcm_from_compute
from repro_torch.core.optimizer import (DSEResult, DesignPoint, inner_search,
                                  pareto_front, propose_mcm, propose_moves)
from repro_torch.core.workload import Workload
from repro_torch.models.common import check_device
from repro_torch.dse.search import refine_sweep_rows, sweep_design_space
from repro_torch.dse.space import DesignSpace, enumerate_strategy_batch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span

VariantKey = Tuple[int, int, int, int, float]


def mcm_variant_key(mcm: MCMArch) -> VariantKey:
    """Hashable identity of an MCM variant (the evaluation-cache key)."""
    return (mcm.n_mcm, mcm.x, mcm.y, mcm.m, round(mcm.cpo_ratio, 6))


@dataclass
class VariantEval:
    """Cached inner-search outcome of one MCM variant.

    ``event_step_time`` / ``event_thpt`` are stamped by the fused
    per-round event replay (``outer_search(event_replay=K)``): the
    event-resolved step time of the variant's best replayed point and
    its event-corrected throughput (analytic throughput rescaled by
    analytic/event step time).  Zero when the hook is off or no point
    of the variant compiled."""

    mcm: MCMArch
    best: Optional[DesignPoint]
    points: List[DesignPoint]
    grid_size: int
    event_step_time: Optional[float] = None
    event_thpt: float = 0.0

    @property
    def best_thpt(self) -> float:
        return self.best.throughput if self.best is not None else 0.0


def outer_search(w: Workload, total_tflops: float,
                 dies_per_mcm: int = 16, m0: int = 6, rounds: int = 8,
                 inner_budget: int = 48, walkers: int = 8,
                 fabric: str = "oi", reuse: bool = True,
                 hw: HW = DEFAULT_HW, seed: int = 0, cpo0: float = 0.6,
                 method: str = "population",
                 inner_method: str = "batched",
                 refine_per_variant: int = 8,
                 device="cuda",
                 event_replay: int = 0,
                 event_schedule=("1f1b",)) -> DSEResult:
    """Outer MCM-architecture search at constant cluster compute C.

    ``method="population"`` (default) runs ``walkers`` walkers for
    ``rounds`` rounds with fused batched evaluation and a variant cache;
    each variant's top ``refine_per_variant`` scan winners get the full
    vectorized refinement (the batched scan ranks the rest).
    ``method="scalar"`` is the single-walker nested loop (requires
    ``walkers == 1``; ``inner_budget`` points per round get the scalar
    treatment), reproducing the legacy ``chiplight_optimize`` trace
    bit-identically for the same seed.  ``outer_trace`` has
    ``rounds + 1`` entries either way — one per evaluation round.

    ``event_replay=K`` (population only) turns on the fused per-round
    event replay: each newly evaluated variant's top-K refined winners
    are vector-compiled (``events.compile_batch`` — no per-record DAG
    walks) and batch-replayed under EVERY ``event_schedule`` candidate
    (a name or a sequence of names; interleaved expands over its
    ``virtual_chunks`` grid), each point scored by its best schedule;
    walkers then adopt by event-resolved throughput — the schedule is a
    search dimension of the outer loop, not a fixed input.

    The scans' cost terms and the replay's wavefront run on ``device``
    (a CUDA device that is not there raises).
    """
    device = check_device(device)
    event_schedule = (event_schedule,) if isinstance(event_schedule, str) \
        else tuple(event_schedule)
    if event_replay:
        from repro_torch.events.dag import SCHEDULES
        bad = [s for s in event_schedule if s not in SCHEDULES]
        if bad:
            raise ValueError(f"unknown event_schedule {bad}; known: "
                             f"{list(SCHEDULES)}")
        if method == "scalar":
            raise ValueError("event_replay requires method='population' "
                             "(the scalar path has no fused rounds)")
    if method == "scalar":
        if walkers != 1:
            raise ValueError(f"method='scalar' is the single-walker "
                             f"path; got walkers={walkers}")
        return _outer_scalar(w, total_tflops, dies_per_mcm, m0, rounds,
                             inner_budget, fabric, reuse, hw, seed, cpo0,
                             inner_method, device)
    if method != "population":
        raise ValueError(f"unknown outer method {method!r}; "
                         f"use 'population' or 'scalar'")
    if walkers < 1:
        raise ValueError(f"walkers must be >= 1, got {walkers}")
    return _OuterPopulation(w, total_tflops, dies_per_mcm, m0, rounds,
                            inner_budget, walkers, fabric, reuse, hw,
                            seed, cpo0, refine_per_variant, device,
                            event_replay, event_schedule).run()


# ---------------------------------------------------------------------------
# Scalar single-walker path (the legacy chiplight_optimize loop)
# ---------------------------------------------------------------------------
def _outer_scalar(w: Workload, total_tflops: float, dies_per_mcm: int,
                  m0: int, rounds: int, inner_budget: int, fabric: str,
                  reuse: bool, hw: HW, seed: int, cpo0: float,
                  inner_method: str, device) -> DSEResult:
    """One ``np.random.default_rng(seed)`` drives every ``propose_mcm``
    move (the inner scan is deterministic), so the run is reproducible
    from the arguments alone.  The MCM proposed by the LAST planner move
    is evaluated too — ``outer_trace`` has ``rounds + 1`` entries."""
    rng = np.random.default_rng(seed)
    mcm = mcm_from_compute(total_tflops, dies_per_mcm, m0,
                           cpo_ratio=cpo0, hw=hw)
    all_pts: List[DesignPoint] = []
    trace: List[Dict] = []
    n_sim = 0
    variants = set()
    for it in range(rounds + 1):
        best, pts = inner_search(w, mcm, fabric=fabric, reuse=reuse,
                                 budget=inner_budget, hw=hw,
                                 method=inner_method, device=device)
        n_sim += len(enumerate_strategy_batch(w, mcm))   # memoized
        variants.add(mcm_variant_key(mcm))
        all_pts.extend(pts)
        trace.append({
            "iter": it, "mcm": (mcm.n_mcm, mcm.x, mcm.y, mcm.m,
                                mcm.cpo_ratio),
            "best_thpt": best.throughput if best else 0.0,
            "bottleneck": best.sim.bottleneck if best else "none",
        })
        if it < rounds:
            mcm = propose_mcm(mcm, best, rng)
    best = max(all_pts, key=lambda p: p.throughput, default=None)
    return DSEResult(best=best, frontier=pareto_front(all_pts),
                     history=all_pts, outer_trace=trace,
                     stats={"n_sim": n_sim, "n_rounds": rounds + 1,
                            "n_variants": len(variants), "n_cache_hits": 0,
                            "n_refined": len(all_pts)})


# ---------------------------------------------------------------------------
# Population path
# ---------------------------------------------------------------------------
class _OuterPopulation:
    def __init__(self, w: Workload, total_tflops: float,
                 dies_per_mcm: int, m0: int, rounds: int,
                 inner_budget: int, walkers: int, fabric: str,
                 reuse: bool, hw: HW, seed: int, cpo0: float,
                 refine_per_variant: int, device,
                 event_replay: int = 0,
                 event_schedule: Tuple[str, ...] = ("1f1b",)):
        self.w = w
        self.total_tflops = total_tflops
        self.dies_per_mcm = dies_per_mcm
        self.m0 = m0
        self.rounds = rounds
        self.inner_budget = inner_budget
        self.walkers = walkers
        self.fabric = fabric
        self.reuse = reuse
        self.hw = hw
        self.cpo0 = cpo0
        self.refine_per_variant = refine_per_variant
        self.device = device
        self.event_replay = event_replay
        self.event_schedule = event_schedule
        self.n_event_replayed = 0
        self.rng = np.random.default_rng(seed)
        self.cache: Dict[VariantKey, VariantEval] = {}
        self.history: List[DesignPoint] = []
        self.trace: List[Dict] = []
        self.n_sim = 0
        self.n_requested = 0     # incl. cache-served revisits, in points
        self.cache_hits = 0
        self.n_refined = 0

    # -- walker population -------------------------------------------------
    def run(self) -> DSEResult:
        mcm0 = mcm_from_compute(self.total_tflops, self.dies_per_mcm,
                                self.m0, cpo_ratio=self.cpo0, hw=self.hw)
        pop = [mcm0]
        for _ in range(self.walkers - 1):
            pop.append(self._perturb(mcm0))
        with span("outer.round", round=0, walkers=len(pop)):
            self._evaluate(pop)
            self._record_round(0, pop)
        for r in range(1, self.rounds + 1):
            with span("outer.round", round=r, walkers=len(pop)):
                cands = [self._candidates(m, pop) for m in pop]
                self._evaluate([c for cs in cands for c in cs])
                pop = [self._adopt(m, cs) for m, cs in zip(pop, cands)]
                self._record_round(r, pop)
        best = max(self.history, key=lambda p: p.throughput, default=None)
        return DSEResult(
            best=best, frontier=pareto_front(self.history),
            history=list(self.history), outer_trace=self.trace,
            stats={"n_sim": self.n_sim, "n_requested": self.n_requested,
                   "n_rounds": self.rounds + 1,
                   "n_variants": len(self.cache),
                   "n_cache_hits": self.cache_hits,
                   "n_refined": self.n_refined,
                   "n_event_replayed": self.n_event_replayed})

    def _usable(self, mcm: MCMArch) -> bool:
        return mcm.feasible() and (self.fabric != "oi"
                                   or mcm.total_links > 0)

    def _perturb(self, cur: MCMArch) -> MCMArch:
        """Random jitter of (m, cpo) at the walker's die count."""
        m = int(np.clip(cur.m + self.rng.integers(-2, 3), 1, 16))
        cpo = float(np.clip(
            round(cur.cpo_ratio + 0.1 * self.rng.integers(-2, 3), 6),
            0.1, 1.0))
        return mcm_from_compute(self.total_tflops, cur.dies_per_mcm, m,
                                cpo_ratio=cpo, hw=self.hw)

    def _crossover(self, a: MCMArch, pop: List[MCMArch]) -> MCMArch:
        """Child takes each of (dies, m, cpo) from parent a or a random
        partner walker."""
        b = pop[int(self.rng.integers(len(pop)))]
        take = self.rng.random(3) < 0.5
        dies = a.dies_per_mcm if take[0] else b.dies_per_mcm
        m = a.m if take[1] else b.m
        cpo = a.cpo_ratio if take[2] else b.cpo_ratio
        return mcm_from_compute(self.total_tflops, dies, m,
                                cpo_ratio=cpo, hw=self.hw)

    def _candidates(self, mcm: MCMArch, pop: List[MCMArch]
                    ) -> List[MCMArch]:
        """One walker's move set: bottleneck-driven heuristic moves plus
        crossover and perturbation, deduplicated by variant key."""
        ev = self.cache.get(mcm_variant_key(mcm))
        logs = ev.best.sim.logs if ev is not None and ev.best else None
        moves = propose_moves(mcm, logs, self.rng)
        moves.append(self._crossover(mcm, pop))
        moves.append(self._perturb(mcm))
        out, seen = [], {mcm_variant_key(mcm)}
        for c in moves:
            k = mcm_variant_key(c)
            if k not in seen and self._usable(c):
                seen.add(k)
                out.append(c)
        return out

    def _rank_thpt(self, ev: VariantEval) -> float:
        """Adoption key: event-resolved throughput when the fused
        per-round replay is on, the analytic one otherwise."""
        return ev.event_thpt if self.event_replay else ev.best_thpt

    def _adopt(self, cur: MCMArch, cands: List[MCMArch]) -> MCMArch:
        """Greedy: move to the best-throughput candidate, stay otherwise
        (first-max tie-break; a walker with no feasible point anywhere
        takes its first candidate to keep exploring)."""
        cur_ev = self.cache[mcm_variant_key(cur)]
        if not cands:
            return cur
        best_c = max(cands,
                     key=lambda m: self._rank_thpt(
                         self.cache[mcm_variant_key(m)]))
        best_ev = self.cache[mcm_variant_key(best_c)]
        if cur_ev.best is None and best_ev.best is None:
            return cands[0]
        if self._rank_thpt(best_ev) > self._rank_thpt(cur_ev):
            return best_c
        return cur

    # -- fused evaluation --------------------------------------------------
    def _refine(self, sweep, rows: np.ndarray) -> List[DesignPoint]:
        pts = refine_sweep_rows(sweep, rows, device=self.device) \
            if len(rows) else []
        self.n_refined += len(pts)
        return pts

    def _evaluate(self, mcms: List[MCMArch]) -> None:
        """Evaluate every not-yet-cached variant in ONE fused sweep per
        fabric, then refine each variant's winners in one batched call."""
        new: List[MCMArch] = []
        seen = set()
        for m in mcms:
            k = mcm_variant_key(m)
            if k in self.cache:
                self.cache_hits += 1
                obs_metrics.inc("outer.variant_cache.hits")
            elif k in seen:
                pass
            elif self._usable(m):
                seen.add(k)
                new.append(m)
            else:
                seen.add(k)
                self.cache[k] = VariantEval(m, None, [], 0)
        if not new:
            self.n_requested += sum(
                self.cache[mcm_variant_key(m)].grid_size for m in mcms)
            return
        obs_metrics.inc("outer.variants_evaluated", len(new))
        space = DesignSpace(workload=self.w, mcms=tuple(new),
                            fabrics=(self.fabric,), reuse=self.reuse)
        sweep = sweep_design_space(space, driver="exhaustive",
                                   device=self.device)
        self.n_sim += sweep.n_sim
        grid_sizes = np.bincount(sweep.mcm_idx, minlength=len(new)) \
            if len(sweep) else np.zeros(len(new), np.int64)

        # per-variant winners: refine each variant's top-budget rows,
        # then top up (down to 4x the budget deep) only the variants
        # whose rows failed physical-rail derivation
        by_key: Dict[VariantKey, List[DesignPoint]] = {}
        if len(sweep):
            feas = np.nonzero(sweep.metrics["feasible"])[0]
            order = feas[np.argsort(-sweep.metrics["throughput"][feas],
                                    kind="stable")]
            by_var = order[np.argsort(sweep.mcm_idx[order], kind="stable")]
            mi = sweep.mcm_idx[by_var]
            starts = np.searchsorted(mi, np.arange(len(new)))
            rank_in_var = np.arange(len(by_var)) - starts[mi]
            rpv = self.refine_per_variant
            for p in self._refine(sweep, by_var[rank_in_var < rpv]):
                by_key.setdefault(mcm_variant_key(p.mcm), []).append(p)
            short = [i for i, m in enumerate(new)
                     if len(by_key.get(mcm_variant_key(m), [])) < rpv]
            if short:
                window2 = by_var[(rank_in_var >= rpv)
                                 & (rank_in_var < 4 * rpv)
                                 & np.isin(mi, np.array(short))]
                for p in self._refine(sweep, window2):
                    # window-2 rows rank below window 1, so appending
                    # keeps each variant's list in ranking order
                    by_key.setdefault(mcm_variant_key(p.mcm),
                                      []).append(p)
        for i, m in enumerate(new):
            k = mcm_variant_key(m)
            pts = by_key.get(k, [])[: self.refine_per_variant]
            best = max(pts, key=lambda p: p.throughput, default=None)
            self.cache[k] = VariantEval(m, best, pts,
                                        int(grid_sizes[i]))
            self.history.extend(pts)
        if self.event_replay:
            self._event_replay([self.cache[mcm_variant_key(m)]
                                for m in new])
        # search-requested volume: every variant the walkers asked for
        # this call, whether freshly simulated or served by the cache
        self.n_requested += sum(
            self.cache[mcm_variant_key(m)].grid_size for m in mcms)

    def _event_replay(self, evs: List[VariantEval]) -> None:
        """Fused per-round event replay with schedule search: the
        round's candidate winners (top ``event_replay`` refined points
        per new variant) are vector-compiled by
        ``events.compile_batch`` and batch-replayed once per
        ``(schedule, virtual_chunks)`` candidate; each point is scored
        by its BEST schedule, its logs stamped with the event-resolved
        step time and winning schedule, and each variant with its best
        event-corrected throughput."""
        from repro_torch.dse.space import schedule_axis
        from repro_torch.events.compile_batch import compile_batch
        from repro_torch.events.dag import SCHEDULES
        pts, owners = [], []
        for ev in evs:
            for p in ev.points[: self.event_replay]:
                pts.append(p)
                owners.append(ev)
        if not pts:
            return
        cands = schedule_axis(self.event_schedule)
        N = len(pts)
        steps = np.full((len(cands), N), np.inf)
        errs = np.full((len(cands), N), np.nan)
        vs = np.ones((len(cands), N), np.int64)
        feas_any = np.zeros(N, bool)
        for ci, (sched, v) in enumerate(cands):
            cb = compile_batch(
                self.w, [p.strategy for p in pts],
                [p.mcm for p in pts],
                fabric=[p.fabric for p in pts],
                topos=[p.topo for p in pts], reuse=self.reuse,
                hw=self.hw, schedule=sched, virtual_chunks=v,
                device=self.device)
            res = cb.replay(device=self.device)
            steps[ci] = res["step_time"]
            errs[ci] = res["err"]
            vs[ci] = cb.v
            feas_any |= cb.feasible
        n_ok = int(feas_any.sum())
        if not n_ok:
            return                # no point compiled under any schedule
        obs_metrics.inc("outer.event_replayed", n_ok)
        self.n_event_replayed += n_ok
        win = np.argmin(steps, axis=0)
        for j, (ev, p) in enumerate(zip(owners, pts)):
            if not feas_any[j]:
                continue
            ci = int(win[j])
            st = float(steps[ci, j])
            p.sim.logs["event_step_time"] = st
            p.sim.logs["event_err"] = float(errs[ci, j])
            # logs are float-valued: the schedule rides as its index
            p.sim.logs["event_schedule"] = float(
                SCHEDULES.index(cands[ci][0]))
            p.sim.logs["event_v"] = float(vs[ci, j])
            thpt = (p.throughput * p.sim.step_time / st) if st > 0 else 0.0
            if thpt > ev.event_thpt:
                ev.event_thpt = thpt
                ev.event_step_time = st

    # -- trace -------------------------------------------------------------
    def _record_round(self, r: int, pop: List[MCMArch]) -> None:
        walkers = []
        pop_pts: List[DesignPoint] = []
        seen = set()
        for mcm in pop:
            k = mcm_variant_key(mcm)
            ev = self.cache[k]
            row = {
                "mcm": list(k),
                "best_thpt": float(ev.best_thpt),
                "bottleneck": ev.best.sim.bottleneck if ev.best else "none",
            }
            # event keys only when the hook is on — the legacy trace
            # stays schema-identical with event_replay=0
            if self.event_replay:
                row["event_thpt"] = float(ev.event_thpt)
                row["event_step_time"] = ev.event_step_time
            walkers.append(row)
            if k not in seen:
                seen.add(k)
                pop_pts.extend(ev.points)
        front = pareto_front(pop_pts)
        self.trace.append({
            "round": r,
            "walkers": walkers,
            "frontier": [[float(p.cost), float(p.throughput)]
                         for p in front],
            "n_sim": int(self.n_sim),
            "n_variants": len(self.cache),
            "n_cache_hits": int(self.cache_hits),
        })
