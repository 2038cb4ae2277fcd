"""Fidelity harness: event-driven replay vs the analytic model.

Two entry points sit on top of the engines:

* ``stamp_validation(result, top, schedule, device)`` — the ``Study.run``
  integration: batch-replays the top-K records of a ``StudyResult`` on
  the chosen device and stamps each with ``validated_step_time`` /
  ``fidelity_err`` metrics (plus a ``validate`` provenance block).

* ``validate_scenario`` / ``validate_zoo`` — the standalone harness
  behind ``python -m repro_torch.cli validate``: runs each scenario
  preset's study on ``device``, replays its top points with the scalar
  discrete-event engine (``repro_torch.events.engine``, host code) under
  every requested schedule, and writes a VERSIONED fidelity report
  artifact (``FIDELITY_SCHEMA``) with per-point analytic vs event step
  times, errors, measured bubbles and OCS reconfiguration counts.  Rows
  whose schedule matches the analytic model's bubble assumption
  (``gpipe`` / ``1f1b``) are asserted to agree within ``tolerance``
  (default 15%); ``interleaved`` rows are reported only — their smaller
  bubble is scenario diversity the analytic model cannot express.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.calib import (DEFAULT_CALIB_PATH, _refuse_reference_artifact,
                               execution_block, load_calibration)
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology, RailDim
from repro_torch.core.traffic import Strategy
from repro_torch.events.dag import SCHEDULES, compile_step
from repro_torch.events.engine import replay

FIDELITY_SCHEMA = 1
DEFAULT_TOLERANCE = 0.15
ASSERTED_SCHEDULES = ("gpipe", "1f1b")
DEFAULT_FIDELITY_PATH = "artifacts/fidelity_report_h100.json"


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


# ---------------------------------------------------------------------------
# Standalone fidelity harness (scalar engine — the ground truth)
# ---------------------------------------------------------------------------
def validate_scenario(scenario, top: int = 4,
                      schedules: Sequence[str] = SCHEDULES,
                      tolerance: float = DEFAULT_TOLERANCE,
                      device="cuda") -> dict:
    """Run one scenario's study on ``device``, replay its top points
    under every schedule with the scalar event engine (on the host), and
    return a per-point fidelity block."""
    from repro_torch.api import Study
    bad = [s for s in schedules if s not in SCHEDULES]
    if bad:
        raise ValueError(f"unknown schedules {bad}; known: "
                         f"{list(SCHEDULES)}")
    t0 = time.perf_counter()
    # validate_top=0: the harness replays the points itself (scalar
    # engine, every schedule) — don't batch-validate them a first time
    result = Study(scenario).run(validate_top=0, device=device)
    rows = []
    for i in _top_records(result, top):
        rec = result.records[i]
        try:
            s, mcm, topo, fabric = _rebuild(rec, scenario)
        except (KeyError, TypeError):
            continue
        for sched in schedules:
            try:
                prog = compile_step(scenario.build_workload(), s, mcm,
                                    fabric=fabric, topo=topo,
                                    reuse=scenario.reuse,
                                    hw=scenario.build_hw(), schedule=sched)
            except ValueError:
                continue
            ev = replay(prog)
            asserted = sched in ASSERTED_SCHEDULES
            rows.append({
                "scenario": scenario.name,
                "schedule": sched,
                "strategy": dict(rec.strategy),
                "mcm": dict(rec.mcm),
                "fabric": fabric,
                "analytic_step_time": ev.analytic_step_time,
                "event_step_time": ev.step_time,
                "err": ev.err,
                "bubble_event": ev.bubble,
                "bubble_analytic": float(
                    prog.analytic.logs.get("bubble", 0.0)),
                "peak_inflight": ev.peak_inflight,
                "n_reconf": ev.n_reconf,
                "reconf_wait_s": ev.reconf_wait_s,
                "n_events": ev.n_events,
                "asserted": asserted,
                "ok": (abs(ev.err) <= tolerance) if asserted else True,
            })
    n_points = len({(tuple(sorted(r["strategy"].items())),
                     tuple(sorted(r["mcm"].items())), r["fabric"])
                    for r in rows})
    return {"scenario": scenario.name,
            "scenario_hash": scenario.scenario_hash(),
            "n_points": n_points,
            "rows": rows, "elapsed_s": time.perf_counter() - t0}


def execution_anchor(calib_path=DEFAULT_CALIB_PATH):
    """The fidelity report's execution-grounded block: a summary of the
    port's calibration artifact (``repro_torch.calib``), or ``None`` when
    no usable artifact exists at ``calib_path``.  The reference package's
    ``CALIB.json`` is refused, never read."""
    _refuse_reference_artifact(calib_path)
    try:
        calib = load_calibration(calib_path)
    except (OSError, ValueError):
        return None
    return execution_block(calib, source=calib_path)


def validate_zoo(paths: Sequence = (), top: int = 4,
                 schedules: Sequence[str] = SCHEDULES,
                 tolerance: float = DEFAULT_TOLERANCE,
                 out: Optional[str] = None, device="cuda") -> dict:
    """Sweep scenario JSON files (default: ``scenarios/*.json``) through
    ``validate_scenario`` (studies on ``device``) and write the versioned
    fidelity report to ``out`` (never the reference package's
    ``FIDELITY.json`` or ``CALIB.json``)."""
    from repro_torch.api import Scenario
    from repro_torch.obs import metrics, span
    if out:
        _refuse_reference_artifact(out)
    paths = list(paths) or sorted(Path("scenarios").glob("*.json"))
    blocks = []
    with metrics.scope() as ms:
        for path in paths:
            sc = Scenario.load(path)
            with span("validate.scenario", scenario=sc.name):
                blocks.append(validate_scenario(
                    sc, top=top, schedules=schedules,
                    tolerance=tolerance, device=device))
    # records the studies' batch replays saw while the harness ran; the
    # port's wavefront has no scalar fallback: 0, kept for the schema
    n_rec = int(ms.counters.get("batch_replay.records", 0))
    rows = [r for b in blocks for r in b["rows"]]
    asserted = [r for r in rows if r["asserted"]]
    violations = [r for r in asserted if not r["ok"]]
    report = {
        "schema": FIDELITY_SCHEMA,
        "tolerance": tolerance,
        "schedules": list(schedules),
        "top_per_scenario": top,
        "device": str(device),
        "n_scenarios": len(blocks),
        "n_rows": len(rows),
        "n_asserted": len(asserted),
        "n_violations": len(violations),
        "max_abs_err_asserted": max((abs(r["err"]) for r in asserted),
                                    default=None),
        "batch_replay": {"records": n_rec, "scalar_fallback": 0,
                         "fallback_frac": 0.0},
        "scenarios": blocks,
    }
    # Execution-grounded anchor: where the port's calibration artifact
    # exists, the report records what the analytic constants were fitted
    # against (not asserted — drift gating is `cli calibrate --check`'s)
    anchor = execution_anchor()
    if anchor is not None:
        report["execution"] = anchor
    if out:
        p = Path(out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(report, indent=2) + "\n")
    return report


def fidelity_table(report: dict) -> List[Dict]:
    """Per-(scenario, schedule) summary rows for reporting (README)."""
    agg: Dict[Tuple[str, str], List[dict]] = {}
    for b in report["scenarios"]:
        for r in b["rows"]:
            agg.setdefault((r["scenario"], r["schedule"]), []).append(r)
    out = []
    for (name, sched), rows in sorted(agg.items()):
        out.append({
            "scenario": name, "schedule": sched, "n": len(rows),
            "max_abs_err": max(abs(r["err"]) for r in rows),
            "mean_err": sum(r["err"] for r in rows) / len(rows),
            "mean_bubble_event": sum(r["bubble_event"] for r in rows)
            / len(rows),
            "mean_bubble_analytic": sum(r["bubble_analytic"] for r in rows)
            / len(rows),
        })
    return out
