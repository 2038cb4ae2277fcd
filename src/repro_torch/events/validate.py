"""The study's validation stamp: event-driven replay of a result's top
records.

``stamp_validation(result, top, schedule, device)`` — the ``Study.run``
integration: batch-replays the top-K records of a ``StudyResult`` on the
chosen device and stamps each with ``validated_step_time`` /
``fidelity_err`` metrics (plus a ``validate`` provenance block).

The standalone fidelity harness behind ``cli validate``
(``validate_scenario`` / ``validate_zoo``, on the scalar discrete-event
engine) comes with that command.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology, RailDim
from repro_torch.core.traffic import Strategy
from repro_torch.events.dag import SCHEDULES


# ---------------------------------------------------------------------------
# Record -> engine objects
# ---------------------------------------------------------------------------
def _rebuild_topo(topo: Optional[dict]) -> Optional[OITopology]:
    if not topo:
        return None
    return OITopology(
        dims=tuple(RailDim(n=int(n), r=int(r), k=int(k))
                   for n, r, k in topo.get("dims", [])),
        mapping=tuple(tuple(g) for g in topo.get("mapping", [])),
        link_alloc=dict(topo.get("link_alloc", {})),
        reuse_pair=tuple(topo["reuse_pair"]) if topo.get("reuse_pair")
        else None)


def _rebuild(record, scenario, hw=None) -> Tuple[Strategy, MCMArch,
                                                 Optional[OITopology], str]:
    st = record.strategy
    s = Strategy(tp=int(st["TP"]), dp=int(st["DP"]), pp=int(st["PP"]),
                 cp=int(st["CP"]), ep=int(st["EP"]),
                 n_micro=int(st["n_micro"]))
    mc = record.mcm
    mcm = MCMArch(n_mcm=int(mc["n_mcm"]), x=int(mc["x"]), y=int(mc["y"]),
                  m=int(mc["m"]), cpo_ratio=float(mc["cpo_ratio"]),
                  hw=hw if hw is not None else scenario.build_hw())
    return s, mcm, _rebuild_topo(record.topo), record.fabric


def _top_records(result, top: int) -> List[int]:
    """Indices of the top-``top`` feasible records by throughput, one per
    unique design point (refined duplicates win over batched rows —
    they carry the derived topology)."""
    ranked = sorted(
        (i for i, r in enumerate(result.records) if r.feasible),
        key=lambda i: (-result.records[i].throughput,
                       result.records[i].source != "refined"))
    seen, keep = set(), []
    for i in ranked:
        r = result.records[i]
        key = (tuple(sorted(r.strategy.items())),
               tuple(sorted(r.mcm.items())), r.fabric)
        if key in seen:
            continue
        seen.add(key)
        keep.append(i)
        if len(keep) >= top:
            break
    return keep


# ---------------------------------------------------------------------------
# Study integration (batch replay — off the critical path)
# ---------------------------------------------------------------------------
def _schedule_names(schedule: str) -> Tuple[str, ...]:
    """Resolve a schedule spec — one name, a comma list, or ``search``
    (every known schedule) — to a tuple of names."""
    if schedule == "search":
        return tuple(SCHEDULES)
    return tuple(s.strip() for s in str(schedule).split(","))


def stamp_validation(result, top: int, schedule: str = "gpipe",
                     device="cuda") -> dict:
    """Replay the top-``top`` records of ``result`` and stamp each with
    ``validated_step_time`` / ``fidelity_err``; returns (and attaches to
    ``result.provenance['validate']``) a summary block.

    Records are vector-compiled by ``events.compile_batch`` (no
    per-record DAG walks) and replayed in one batched wavefront call per
    resolved ``(schedule, v)`` group.  ``schedule`` may be one name, a
    comma list or ``"search"``: with more than one candidate each record
    validates under its OWN re-rank winner (the ``event_schedule`` /
    ``event_v`` metrics stamped by ``Study.run``'s event re-rank stage),
    falling back to the first candidate.  ``device`` is where the
    wavefront runs (``repro_torch.events.batch.replay_rows``)."""
    from repro_torch.events.compile_batch import compile_batch
    t0 = time.perf_counter()
    sc = result.scenario
    idx = _top_records(result, top)
    scheds = _schedule_names(schedule)
    w = sc.build_workload()
    hw = sc.build_hw()
    # group records by their resolved (schedule, virtual_chunks): one
    # compile_batch + replay per group (usually exactly one group)
    groups: Dict[Tuple[str, Optional[int]], List[tuple]] = {}
    for i in idx:
        r = result.records[i]
        try:
            s, mcm, topo, fabric = _rebuild(r, sc, hw=hw)
        except (KeyError, TypeError, ValueError):
            continue
        rsched = str(r.metrics.get("event_schedule", scheds[0]))
        if rsched not in SCHEDULES:
            rsched = scheds[0]
        rv = r.metrics.get("event_v")
        key = (rsched, int(rv) if rv is not None else None)
        groups.setdefault(key, []).append((i, s, mcm, topo, fabric))
    errs: List[float] = []
    n_validated, n_fb = 0, 0
    for (sched, rv), members in groups.items():
        cb = compile_batch(w, [m[1] for m in members],
                           [m[2] for m in members],
                           fabric=[m[4] for m in members],
                           topos=[m[3] for m in members],
                           reuse=sc.reuse, hw=hw, schedule=sched,
                           virtual_chunks=rv, device=device)
        res = cb.replay(device=device)
        n_fb += int(res["scalar_fallback"].sum())
        for j, m in enumerate(members):
            if not cb.feasible[j]:
                continue              # infeasible under the oracle
            rec = result.records[m[0]]
            rec.metrics["validated_step_time"] = float(res["step_time"][j])
            rec.metrics["fidelity_err"] = float(res["err"][j])
            errs.append(abs(float(res["err"][j])))
            n_validated += 1
    summary = {"n_validated": n_validated, "schedule": schedule,
               "method": "batch", "device": str(device),
               "max_abs_err": max(errs) if errs else None,
               "n_scalar_fallback": n_fb,
               "scalar_fallback_frac": n_fb / n_validated
               if n_validated else 0.0,
               "elapsed_s": time.perf_counter() - t0}
    result.provenance["validate"] = summary
    result.timings["validate_s"] = summary["elapsed_s"]
    return summary
