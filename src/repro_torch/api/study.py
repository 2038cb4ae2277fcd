"""``Study`` — one ``run()`` over any engine, from a ``Scenario``.

Dispatch goes through the driver registry: the batched drivers
(exhaustive / random / prf / nsga2) take the scan-then-refine path — the
vectorized ``repro_torch.dse`` sweep ranks the whole grid with its cost
terms on the device, the event re-rank and ``validate_top`` run the
pipeline wavefront there, then the vectorized refinement derives exact
topologies and OCS-inclusive costs for the top points.
``chiplight-outer`` and ``railx`` are registered and raise until they
are ported (ROADMAP A3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

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


def _run_batched(sc: Scenario, driver: str, device) -> StudyResult:
    from repro_torch.dse.search import (refine_sweep_rows, refine_top_points,
                                  sweep_design_space)
    t0 = time.perf_counter()
    space = sc.design_space()
    kw = _batched_driver_kw(sc, driver)
    with span("study.scan", driver=driver):
        sweep = sweep_design_space(space, driver=driver, device=device,
                                   seed=sc.seed, **kw)
    kept = _sweep_keep_indices(sweep, sc)
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
                               engine=f"dse.sweep[{driver}]+refine",
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
