"""``Study`` — one ``run()`` over any engine, from a ``Scenario``.

Dispatch goes through the driver registry: the batched drivers
(exhaustive / random / prf / nsga2) take the scan-then-refine path — the
vectorized ``repro_torch.dse`` sweep ranks the whole grid with its cost
terms on the device, the event re-rank and ``validate_top`` run the
pipeline wavefront there, then the vectorized refinement derives exact
topologies and OCS-inclusive costs for the top points.
``chiplight-outer`` runs the population-based batched outer search
(``repro_torch.dse.outer``; ``driver_kw={"method": "scalar"}`` is the
legacy single-walker nested optimiser), and ``railx`` sweeps the same
grids under the uniform RailX link split with exact RailX-topology
refinement (``method="scalar"`` for the legacy loop).  Every path
produces the same ``StudyResult``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.api.registry import DRIVERS, OBJECTIVES
from repro_torch.api.result import (StudyResult, record_from_point,
                              records_from_sweep)
from repro_torch.api.scenario import Scenario
from repro_torch.models.common import check_device
from repro_torch.obs import metrics, span


@dataclass(frozen=True)
class Study:
    """A scenario bound to its runner; ``Study(sc).run()`` is the single
    entrypoint every example, benchmark and CLI flow goes through."""

    scenario: Scenario

    def run(self, validate_top: Optional[int] = None,
            schedule: Optional[str] = None, device="cuda") -> StudyResult:
        """Run the scenario's driver with its device work on ``device``
        (a CUDA device that is not there raises; ``device="cpu"`` runs
        the plain paths); when ``validate_top`` (argument or scenario
        field) is > 0, the top-K records are replayed by the event
        wavefront (``repro_torch.events``, vectorized batch path) and
        stamped with ``validated_step_time`` / ``fidelity_err``."""
        sc = self.scenario
        device = check_device(device)
        t0 = time.perf_counter()
        with metrics.scope() as ms, \
                span("study.run", scenario=sc.name, driver=sc.driver):
            result = DRIVERS.get(sc.driver)(sc, device)
            k = sc.validate_top if validate_top is None else validate_top
            if k:
                from repro_torch.events.validate import stamp_validation
                with span("study.validate_top", top=k):
                    stamp_validation(result, k, schedule or sc.schedule,
                                     device=device)
            result.provenance["metrics"] = _metrics_block(
                result, ms, time.perf_counter() - t0)
            if sc.calibration:
                # the run executed on measured constants — stamp them
                # (plus where they were measured) next to the metrics
                # block so the artifact is self-describing
                from repro_torch.calib import calibration_block
                result.provenance["calibration"] = \
                    calibration_block(sc.calibration)
        return result


def run(scenario: Scenario, **kw) -> StudyResult:
    """Module-level convenience: ``repro_torch.api.run(scenario)``."""
    return Study(scenario).run(**kw)


# ---------------------------------------------------------------------------
# Batched drivers: vectorized sweep -> scalar refinement
# ---------------------------------------------------------------------------
def _sweep_keep_indices(sweep, sc: Scenario) -> np.ndarray:
    """Feasible rows worth keeping: top-``keep_top`` by throughput plus
    the full Pareto set under the scenario objectives (0 = keep all)."""
    from repro_torch.dse.pareto import pareto_mask
    feas = np.nonzero(sweep.metrics["feasible"])[0]
    order = feas[np.argsort(-sweep.metrics["throughput"][feas],
                            kind="stable")]
    if sc.keep_top == 0 or len(order) <= sc.keep_top:
        return order
    objs = [OBJECTIVES.get(n) for n in sc.objectives]
    cols = np.stack([np.asarray(sweep.metrics[o.metric], np.float64)
                     for o in objs], 1)
    cols = np.where(sweep.metrics["feasible"][:, None], cols, np.nan)
    par = np.nonzero(pareto_mask(cols, [o.maximize for o in objs]))[0]
    keep = list(order[: sc.keep_top])
    kept = set(int(i) for i in keep)
    keep += [int(i) for i in par if int(i) not in kept]
    return np.array(keep, np.int64)


def _batched_driver_kw(sc: Scenario, driver: str) -> dict:
    """Translate generic knobs to the driver's signature (``budget`` ->
    ``pop_size`` for nsga2, as the legacy CLI did) and reject anything
    the driver cannot accept with one clear error."""
    import inspect
    from repro_torch.dse.search import DRIVERS as DSE_DRIVERS
    kw = dict(sc.driver_kw)
    if driver == "exhaustive":          # full grid: budgets are moot
        kw.pop("budget", None)
        kw.pop("generations", None)
    elif driver in ("random", "prf"):
        kw.pop("generations", None)
        kw.setdefault("budget", 256)
    elif driver == "nsga2" and "budget" in kw:
        kw.setdefault("pop_size", min(kw.pop("budget"), 64))
    allowed = {p for p in inspect.signature(DSE_DRIVERS[driver]).parameters
               if p not in ("ev", "grid")}
    bad = sorted(set(kw) - allowed - {"seed"})
    if bad:
        raise ValueError(f"driver {driver!r} does not accept driver_kw "
                         f"{bad}; accepted: {sorted(allowed)}")
    return kw


_EVENT_KEYS = ("event_schedule", "event_v", "event_step_time",
               "event_throughput")


def _record_key(rec) -> tuple:
    return (tuple(sorted(rec.strategy.items())),
            tuple(sorted(rec.mcm.items())), rec.fabric)


def _event_rerank_stage(sc: Scenario, sweep, kept: np.ndarray, device):
    """The ``study.event_rerank`` stage: screen -> RE-RANK -> refine.

    When the scenario makes the pipeline schedule a search dimension
    (``schedule_list()`` > 1 candidate), the top-N analytic frontier is
    compiled per ``(schedule, virtual_chunks)`` candidate through
    ``events.compile_batch`` and batch-replayed; the head of ``kept``
    comes back EVENT-best-first so both the kept records and the
    refinement window honour the event-resolved ranking.  Returns
    ``(kept, rerank_info)`` — ``rerank_info`` is None when the stage is
    off (single schedule: bit-identical to the pre-stage path)."""
    from repro_torch.dse.search import event_rerank_rows
    from repro_torch.dse.space import schedule_axis
    sched_list = sc.schedule_list()
    if len(sched_list) < 2 or not len(kept):
        return kept, None
    n = int(min(len(kept), max(16, 4 * sc.refine_top)))
    cands = schedule_axis(sched_list)
    t0 = time.perf_counter()
    with span("study.event_rerank", rows=n, candidates=len(cands)):
        rr = event_rerank_rows(sweep, kept[:n], cands, device=device)
    kept = np.concatenate([kept[:n][rr["order"]], kept[n:]])
    return kept, {"n": n, "cands": cands, "rr": rr,
                  "elapsed_s": time.perf_counter() - t0,
                  "schedules": sched_list}


def _stamp_rerank(records, rerank: dict) -> dict:
    """Stamp the winning ``(schedule, v)`` + event step time on the
    re-ranked head of ``records`` (already event-best-first) and return
    the ``provenance["event_rerank"]`` block."""
    rr, n = rerank["rr"], rerank["n"]
    order = rr["order"]
    winners: dict = {}
    for j in range(n):
        pos = int(order[j])
        rec = records[j]
        step_ev = float(rr["step_time"][pos])
        if not np.isfinite(step_ev):
            continue               # no candidate compiled feasibly
        sched = str(rr["schedule"][pos])
        v = int(rr["v"][pos])
        rec.metrics["event_schedule"] = sched
        rec.metrics["event_v"] = v
        rec.metrics["event_step_time"] = step_ev
        rec.metrics["event_throughput"] = (
            rec.metrics["throughput"] * rec.metrics["step_time"]
            / step_ev) if step_ev > 0 else 0.0
        key = f"{sched}/v{v}"
        winners[key] = winners.get(key, 0) + 1
    return {"n_reranked": n,
            "schedules": list(rerank["schedules"]),
            "candidates": [[s, int(v)] for s, v in rerank["cands"]],
            "winners": winners}


def _run_batched(sc: Scenario, driver: str, device,
                 alloc_mode: str = "chiplight",
                 engine: Optional[str] = None) -> StudyResult:
    from repro_torch.dse.search import (refine_sweep_rows, refine_top_points,
                                  sweep_design_space)
    t0 = time.perf_counter()
    space = sc.design_space(alloc_mode=alloc_mode)
    kw = _batched_driver_kw(sc, driver) if alloc_mode == "chiplight" \
        else {}
    with span("study.scan", driver=driver):
        sweep = sweep_design_space(space, driver=driver, device=device,
                                   seed=sc.seed, **kw)
    kept = _sweep_keep_indices(sweep, sc)
    # the event engine replicates the chiplight link allocation — the
    # railx sweep's analytic rows answer a different alloc, so the
    # schedule re-rank only runs on the chiplight path
    rerank = None
    if alloc_mode == "chiplight":
        kept, rerank = _event_rerank_stage(sc, sweep, kept, device)
    records = records_from_sweep(sweep, kept)
    rerank_prov = _stamp_rerank(records, rerank) if rerank else None
    t1 = time.perf_counter()
    points = []
    if sc.refine_top and len(kept):
        with span("study.refine", top=sc.refine_top):
            if rerank is not None:
                # kept is event-best-first: refine the event winners in
                # that order (refine_sweep_rows preserves it)
                points = refine_sweep_rows(sweep, kept[: sc.refine_top],
                                           device=device)
            else:
                points = refine_top_points(sweep, top_k=sc.refine_top,
                                           device=device)
    refined = [record_from_point(p) for p in points]
    if rerank_prov and refined:
        # carry the winning (schedule, v) onto the refined duplicates
        ev_by_key = {_record_key(r): {k: r.metrics[k]
                                      for k in _EVENT_KEYS
                                      if k in r.metrics}
                     for r in records}
        for r in refined:
            r.metrics.update(ev_by_key.get(_record_key(r), {}))
    records += refined
    t2 = time.perf_counter()

    best: Optional[int] = None
    if points:                       # refined best-first (exact costs)
        best = len(records) - len(points)
    elif records:
        best = 0                     # kept rows are best-first
    timings = {"sweep_s": sweep.elapsed_s,
               "refine_s": t2 - t1, "total_s": t2 - t0}
    if rerank is not None:
        timings["rerank_s"] = rerank["elapsed_s"]
    result = StudyResult(
        scenario=sc, records=records, best=best, points=points,
        traces=[],
        timings=timings,
        provenance=_provenance(sc, device,
                               engine=engine
                               or f"dse.sweep[{driver}]+refine",
                               grid_evaluated=len(sweep),
                               n_sim=int(sweep.n_sim),
                               n_cache_hits=int(sweep.n_cache_hits),
                               n_feasible=int(sweep.metrics["feasible"]
                                              .sum()),
                               n_kept=len(kept), n_refined=len(points)))
    if rerank_prov is not None:
        result.provenance["event_rerank"] = rerank_prov
    result.pareto = result.pareto_indices()
    return result


# ---------------------------------------------------------------------------
# Outer search (population / scalar) + RailX baseline
# ---------------------------------------------------------------------------
def _points_result(sc: Scenario, device, pts: List, traces, engine: str,
                   elapsed: float, source: str = "scalar",
                   **extra_prov) -> StudyResult:
    # the outer search revisits MCM variants, re-evaluating identical
    # design points — keep one record per (strategy, mcm, fabric)
    n_raw = len(pts)
    seen, unique = set(), []
    for p in pts:
        s = p.strategy
        key = (s.tp, s.dp, s.pp, s.cp, s.ep, s.n_micro, p.mcm.n_mcm,
               p.mcm.x, p.mcm.y, p.mcm.m, p.mcm.cpo_ratio, p.fabric)
        if key not in seen:
            seen.add(key)
            unique.append(p)
    pts = sorted(unique, key=lambda p: -p.throughput)
    kept = pts if sc.keep_top == 0 else pts[: sc.keep_top]
    records = [record_from_point(p, source=source) for p in kept]
    result = StudyResult(
        scenario=sc, records=records, best=0 if records else None,
        points=kept, traces=list(traces),
        timings={"total_s": elapsed},
        provenance=_provenance(sc, device, engine=engine,
                               n_evaluated=n_raw, n_unique=len(pts),
                               n_kept=len(kept), **extra_prov))
    result.pareto = result.pareto_indices()
    return result


def _require_single_cell(sc: Scenario):
    """The outer search explores FROM one MCM start point (it moves
    dies/m/cpo itself); a multi-valued grid would be silently dropped,
    so reject it instead."""
    multi = [ax for ax in ("dies_per_mcm", "m", "cpo_ratio", "fabrics")
             if len(getattr(sc, ax)) > 1]
    if multi:
        raise ValueError(
            f"driver {sc.driver!r} starts from a single MCM cell; give "
            f"one value per axis (got multiple for {multi})")


def _run_outer(sc: Scenario, device) -> StudyResult:
    """``chiplight-outer``: the batched population search by default;
    ``driver_kw={"method": "scalar"}`` (implying ``walkers=1``) is the
    legacy single-walker nested optimiser, bit-identical per seed.  The
    legacy ``outer_iters`` knob maps onto ``rounds``.  The scans' cost
    terms and the event replay's wavefront run on ``device``."""
    from repro_torch.dse.outer import outer_search
    _require_single_cell(sc)
    kw = dict(sc.driver_kw)
    method = kw.pop("method", "population")
    rounds = kw.pop("rounds", kw.pop("outer_iters", 8))
    walkers = kw.pop("walkers", 1 if method == "scalar" else 8)
    inner_budget = kw.pop("inner_budget", 48)
    inner_method = kw.pop("inner_method", "batched")
    refine_per_variant = kw.pop("refine_per_variant", 8)
    event_replay = kw.pop("event_replay", 0)
    event_schedule = kw.pop("event_schedule", None)
    if event_schedule is not None:
        import warnings
        warnings.warn(
            "driver_kw 'event_schedule' is deprecated; set "
            "Scenario.schedule (one name, a comma list, or 'search') — "
            "the one source of truth for every event-engine consumer",
            DeprecationWarning, stacklevel=3)
    else:
        event_schedule = sc.schedule_list()
    if kw:
        raise ValueError(
            f"driver 'chiplight-outer' does not accept driver_kw "
            f"{sorted(kw)}; accepted: ['event_replay', 'event_schedule', "
            f"'inner_budget', 'inner_method', 'method', 'outer_iters', "
            f"'refine_per_variant', 'rounds', 'walkers']")
    # knobs that only exist on the OTHER method would be silent no-ops
    dropped = ("refine_per_variant" if method == "scalar"
               else "inner_method")
    if dropped in sc.driver_kw:
        raise ValueError(f"driver_kw {dropped!r} has no effect with "
                         f"method={method!r}")
    t0 = time.perf_counter()
    res = outer_search(
        sc.build_workload(), sc.total_tflops,
        dies_per_mcm=sc.dies_per_mcm[0], m0=sc.m[0], cpo0=sc.cpo_ratio[0],
        rounds=rounds, walkers=walkers, inner_budget=inner_budget,
        fabric=sc.fabrics[0], reuse=sc.reuse, hw=sc.build_hw(),
        seed=sc.seed, method=method, inner_method=inner_method,
        refine_per_variant=refine_per_variant, device=device,
        event_replay=event_replay, event_schedule=event_schedule)
    engine = ("core.chiplight_optimize" if method == "scalar"
              else "dse.outer_search[population]")
    source = "scalar" if method == "scalar" else "refined"
    return _points_result(sc, device, res.history, res.outer_trace, engine,
                          time.perf_counter() - t0, source=source,
                          **res.stats)


def _run_railx(sc: Scenario, device) -> StudyResult:
    """``railx``: batched sweep over the SAME grids as the chiplight
    drivers (``alloc_mode="railx"`` — uniform 50/50 two-rail-dim link
    split, the scan's cost terms on ``device``) + exact RailX-topology
    refinement of the winners; ``driver_kw={"method": "scalar"}`` is the
    legacy single-cell scalar loop, on the host."""
    kw = dict(sc.driver_kw)
    method = kw.pop("method", "batched")
    if method == "scalar":
        from repro_torch.core.mcm import mcm_from_compute
        from repro_torch.core.optimizer import railx_search
        _require_single_cell(sc)
        budget = kw.pop("budget", 64)
        if kw:
            raise ValueError(f"driver 'railx' (scalar) does not accept "
                             f"driver_kw {sorted(kw)}; accepted: "
                             f"['budget', 'method']")
        t0 = time.perf_counter()
        mcm = mcm_from_compute(sc.total_tflops, sc.dies_per_mcm[0],
                               sc.m[0], cpo_ratio=sc.cpo_ratio[0],
                               hw=sc.build_hw())
        _, pts = railx_search(sc.build_workload(), mcm, reuse=sc.reuse,
                              budget=budget, hw=sc.build_hw(),
                              seed=sc.seed)
        return _points_result(sc, device, pts, [], "core.railx_search",
                              time.perf_counter() - t0)
    if method != "batched":
        raise ValueError(f"driver 'railx' method must be 'batched' or "
                         f"'scalar', got {method!r}")
    if kw:
        raise ValueError(f"driver 'railx' does not accept driver_kw "
                         f"{sorted(kw)}; accepted: ['method']")
    return _run_batched(sc, "exhaustive", device, alloc_mode="railx",
                        engine="dse.sweep[railx]+refine")


def _provenance(sc: Scenario, device, **kw) -> dict:
    return {"scenario_hash": sc.scenario_hash(), "driver": sc.driver,
            "model": sc.model, "device": str(device),
            "backend": sc.backend, **kw}


def _metrics_block(result: StudyResult, ms: "metrics.Metrics",
                   wall_s: float) -> dict:
    """The ``provenance["metrics"]`` block stamped on every run: stage
    wall-times, points/s, cache hit rates and the scoped counter/gauge
    snapshot (``METRICS_SCHEMA``, whose ``*.device_calls`` counters
    count the device work); round-trips through the StudyResult JSON
    artifact."""
    prov = result.provenance
    n_eval = int(prov.get("grid_evaluated", prov.get("n_evaluated", 0)))
    n_sim = int(prov.get("n_sim", 0))
    hits = int(prov.get("n_cache_hits", 0))
    requests = int(prov.get("n_requested", n_sim + hits))
    wall = {"total": wall_s}
    for key, label in (("sweep_s", "sweep"), ("rerank_s", "rerank"),
                       ("refine_s", "refine"),
                       ("validate_s", "validate"),
                       ("total_s", "driver")):
        if key in result.timings:
            wall[label] = float(result.timings[key])
    snap = ms.snapshot()
    return {
        "schema": metrics.METRICS_SCHEMA,
        "wall_s": wall,
        "points_evaluated": n_eval,
        "points_per_s": n_eval / wall_s if wall_s > 0 else 0.0,
        "cache": {"requests": requests, "hits": hits,
                  "hit_rate": hits / requests if requests else 0.0},
        "counters": snap["counters"],
        "gauges": snap["gauges"],
    }
