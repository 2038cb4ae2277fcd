"""Study CLI — the run path over ``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.cli scenarios/paper_qwen3.json
    PYTHONPATH=src python -m repro_torch.cli scenarios/tinyllama_quick.json \
        --device cpu
    PYTHONPATH=src python -m repro_torch.cli --model qwen3_moe_235b_a22b \
        --C 4e6 --fabrics oi,ib --driver exhaustive --top 5

Runs ``Study.run()`` on scenario JSON files (flags override fields) or on
a scenario built from flags alone (``--model all`` sweeps the whole
zoo), prints the best points + Pareto summary, and writes one versioned
``StudyResult`` JSON artifact per study.  The study's device work (the
scan's cost terms, the event wavefront) runs on ``--device``: the card
by default, which must be there; ``--device cpu`` runs the plain paths.

``calibrate`` is the execution-grounded loop (``repro_torch.obs.profile``
+ ``repro_torch.calib``): time the port's kernels on ``--device`` (on
the card, the hand-written CUDA kernels in float32), fit the analytic
cost constants (effective peak FLOP/s, HBM bytes/s, and the
``M/(M+half)`` efficiency curves), and write the schema-versioned
artifact (``CALIB_h100.json`` by default; a scenario's
``calibration`` field reads it) — or, with ``--check``, re-measure and
gate drift against an artifact.

    PYTHONPATH=src python -m repro_torch.cli calibrate --device cpu --quick

The ``validate`` subcommand runs the event-driven fidelity harness
(``repro_torch.events.validate``) over scenario presets: each study runs
on ``--device``, its top points are replayed by the scalar
discrete-event engine (host code) under the requested pipeline
schedules and compared against the analytic model, writing a versioned
fidelity report (``artifacts/fidelity_report_h100.json`` by default;
the reference's ``FIDELITY.json`` and ``CALIB.json`` are refused).

    PYTHONPATH=src python -m repro_torch.cli validate --device cpu

Observability (``repro_torch.obs``): ``--trace out.json`` on a study,
``validate`` or ``calibrate`` run writes the HOST trace (where the
pipeline spent its wall time) as Chrome Trace Event JSON — open it in
https://ui.perfetto.dev.  The ``timeline`` subcommand replays a
scenario's best pipelined design point through the event engine with
full timeline recording and writes the SIMULATED step as a Perfetto
trace (one track per pipeline stage and per rail, OCS reconfigurations
as instant markers).

    PYTHONPATH=src python -m repro_torch.cli timeline \
        scenarios/tinyllama_quick.json --schedule interleaved --device cpu

The ``lint`` subcommand runs chiplint over the port's tree
(``repro_torch.analysis``: parity drift between the mirrored engines,
host syncs on the card's call graph, unit mismatches, determinism and
the metric schema) against ``chiplint_torch_baseline.json``; it reads
source files only and needs no card.

    PYTHONPATH=src python -m repro_torch.cli lint

The reference CLI's ``bench`` subcommand is not ported.

Exit codes: 0 ok; 2 bad arguments; 3 when a study found NO feasible
design point (every sweep cell infeasible); ``validate``: 1 when any
asserted point exceeds the fidelity tolerance; ``calibrate``: 1, and
nothing written, when on the card a fitted peak is over the card's or
a fit's half is at the top of its search (``calib.card_fit_faults``),
and with ``--check`` when any gated constant drifted beyond tolerance;
``lint``: 1 on findings the baseline does not cover or on stale baseline
entries.
"""
from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.api import DRIVERS, Scenario, Study, StudyResult

EXIT_OK, EXIT_USAGE, EXIT_INFEASIBLE = 0, 2, 3


# ---------------------------------------------------------------------------
# Validated comma-list parsing (--fabrics/--dies/--m/--cpo/--objectives)
# ---------------------------------------------------------------------------
def _csv(conv, what: str):
    """argparse type: reject empty items and duplicates with one clear
    message instead of a deep traceback out of the engine."""

    def parse(text: str) -> Tuple:
        items = [t.strip() for t in text.split(",")]
        if not text.strip() or any(not t for t in items):
            raise argparse.ArgumentTypeError(
                f"empty entry in {what} list {text!r}")
        try:
            vals = tuple(conv(t) for t in items)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{what} list {text!r} has a non-{conv.__name__} "
                f"entry") from None
        if len(set(vals)) != len(vals):
            raise argparse.ArgumentTypeError(
                f"duplicate entries in {what} list {text!r}")
        return vals

    return parse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenario", nargs="*",
                    help="scenario JSON file(s); flags override fields")
    ap.add_argument("--model", default=None,
                    help="config name, or 'all' for the whole zoo")
    ap.add_argument("--C", type=float, default=None,
                    help="total cluster compute, TFLOPS")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--fabrics", type=_csv(str, "--fabrics"), default=None)
    ap.add_argument("--dies", type=_csv(int, "--dies"), default=None)
    ap.add_argument("--m", type=_csv(int, "--m"), default=None)
    ap.add_argument("--cpo", type=_csv(float, "--cpo"), default=None)
    ap.add_argument("--objectives", type=_csv(str, "--objectives"),
                    default=None)
    ap.add_argument("--driver", default=None, choices=DRIVERS.names())
    ap.add_argument("--budget", type=int, default=None,
                    help="per-cell budget for non-exhaustive drivers")
    ap.add_argument("--generations", type=int, default=None)
    ap.add_argument("--no-reuse", action="store_true")
    ap.add_argument("--refine", action="store_true",
                    help="(legacy) refine the top --top points; "
                         "refinement is otherwise on by default with "
                         "--refine-top winners")
    ap.add_argument("--refine-top", type=int, default=None,
                    help="scalar-oracle refinement of the top N points "
                         "(0 disables)")
    ap.add_argument("--keep-top", type=int, default=None,
                    help="records kept in the artifact (0 = all)")
    ap.add_argument("--validate-top", type=int, default=None,
                    help="event-replay validation of the top N records "
                         "(stamps validated_step_time/fidelity_err)")
    ap.add_argument("--schedule", default=None,
                    choices=("gpipe", "1f1b", "interleaved", "search"),
                    help="pipeline schedule(s) the event engine uses; "
                         "'search' makes the schedule a search "
                         "dimension (event re-rank of the frontier)")
    ap.add_argument("--top", type=int, default=5,
                    help="best points to print")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="smoke mode: first grid cell only, small budgets")
    ap.add_argument("--out", default="artifacts/studies",
                    help="output .json file (single study) or directory")
    ap.add_argument("--device", default="cuda",
                    help="where the study's device work runs (default "
                         "cuda; cpu runs the plain paths)")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="write the host trace (Chrome Trace Event "
                         "JSON, Perfetto-loadable) covering every study")
    return ap


# ---------------------------------------------------------------------------
# Scenario assembly
# ---------------------------------------------------------------------------
_FLAG_FIELDS = {          # argparse dest -> Scenario field
    "model": "model", "C": "total_tflops", "seq_len": "seq_len",
    "global_batch": "global_batch", "fabrics": "fabrics",
    "dies": "dies_per_mcm", "m": "m", "cpo": "cpo_ratio",
    "objectives": "objectives", "driver": "driver",
    "refine_top": "refine_top", "keep_top": "keep_top", "seed": "seed",
    "validate_top": "validate_top", "schedule": "schedule",
}


def _overrides(args) -> dict:
    over = {field: getattr(args, dest)
            for dest, field in _FLAG_FIELDS.items()
            if getattr(args, dest) is not None}
    if args.no_reuse:
        over["reuse"] = False
    if args.refine and args.refine_top is None:
        over["refine_top"] = args.top       # legacy: refine top_k=--top
    kw = {}
    if args.budget is not None:
        kw["budget"] = args.budget
    if args.generations is not None:
        kw["generations"] = args.generations
    if kw:
        over["driver_kw"] = kw
    return over


def _quick(sc: Scenario) -> Scenario:
    """Smoke-mode shrink: one MCM grid cell, small budgets."""
    kw = dict(sc.driver_kw)
    for k, cap in (("budget", 32), ("generations", 3), ("pop_size", 16),
                   ("outer_iters", 2), ("inner_budget", 8),
                   ("rounds", 2), ("walkers", 4)):
        if k in kw:
            kw[k] = min(kw[k], cap)
    if sc.driver in ("random", "prf"):
        kw["budget"] = min(kw.get("budget", 32), 32)
    return sc.replace(dies_per_mcm=sc.dies_per_mcm[:1], m=sc.m[:1],
                      cpo_ratio=sc.cpo_ratio[:1], fabrics=sc.fabrics[:1],
                      refine_top=min(sc.refine_top, 3),
                      keep_top=min(sc.keep_top, 32) or 32,
                      validate_top=min(sc.validate_top, 2), driver_kw=kw)


def build_scenarios(args) -> List[Scenario]:
    over = _overrides(args)
    out: List[Scenario] = []
    if args.scenario:
        for path in args.scenario:
            d = Scenario.load(path).to_dict()
            kw = dict(over)
            if "driver_kw" in kw:
                kw["driver_kw"] = {**d.get("driver_kw", {}),
                                   **kw["driver_kw"]}
            d.update(kw)
            out.append(Scenario.from_dict(d))
    else:
        base = dict(over)
        base.setdefault("total_tflops", 4e6)
        models = [base.pop("model", "qwen3_moe_235b_a22b")]
        if models == ["all"]:
            from repro_torch.configs import ARCH_IDS
            models = list(ARCH_IDS)
        out = [Scenario(model=m, **base) for m in models]
    if args.quick:
        out = [_quick(sc) for sc in out]
    return out


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------
def _print_study(res: StudyResult, top: int):
    sc = res.scenario
    prov = res.provenance
    n_eval = prov.get("grid_evaluated", prov.get("n_evaluated", 0))
    print(f"\n=== {sc.name}: driver={sc.driver} C={sc.total_tflops:.0e} "
          f"— {n_eval} points evaluated in "
          f"{res.timings.get('total_s', 0.0):.2f}s ===")
    if res.best is None:
        print("  no feasible design point")
        return
    shown = 0
    for r in res.records:
        if not r.feasible or (res.points and r.source == "refined"):
            continue
        m = r.metrics
        print(f"  {m['throughput']:.3e} tok/s  mfu={m['mfu']:.2f}  "
              f"${m['cost'] / 1e6:7.1f}M {m['power'] / 1e6:5.2f}MW  "
              f"{r.fabric:6s} m={r.mcm['m']:<2d} "
              f"r={r.mcm['cpo_ratio']:.1f} {r.strategy}")
        shown += 1
        if shown >= top:
            break
    for r in res.records:
        if r.source == "refined":
            print(f"  refined: {r.throughput:.3e} tok/s  "
                  f"${r.metrics['cost'] / 1e6:.1f}M  "
                  f"(exact topo/OCS cost)")
    print(f"  pareto set ({'/'.join(sc.objectives)}): "
          f"{len(res.pareto)} non-dominated records")
    rr = res.provenance.get("event_rerank")
    if rr:
        wins = ", ".join(f"{k}:{v}" for k, v in
                         sorted(rr["winners"].items()))
        print(f"  event re-rank: {rr['n_reranked']} rows x "
              f"{len(rr['candidates'])} schedule candidates "
              f"(winners {wins})")
    val = res.provenance.get("validate")
    if val:
        err = val.get("max_abs_err")
        fb = val.get("n_scalar_fallback", 0)
        tail = (f", {fb}/{val['n_validated']} scalar-engine fallback"
                if fb else "")
        print(f"  event-validated {val['n_validated']} records "
              f"({val['schedule']}): max |fidelity err| "
              f"{err * 100:.1f}%{tail}" if err is not None else
              f"  event-validated 0 records")


def _out_path(out: str, sc: Scenario, n_studies: int) -> Path:
    p = Path(out)
    if p.suffix == ".json" and n_studies == 1:
        return p
    return p / f"{sc.name}.json"


@contextmanager
def _maybe_tracing(path: Optional[str]):
    """Install a host tracer for the block when ``path`` is given and
    write the Chrome trace on exit."""
    if not path:
        yield None
        return
    from repro_torch.obs import (chrome_trace_from_tracer, tracing,
                                 write_chrome_trace)
    with tracing() as tr:
        yield tr
    p = write_chrome_trace(path, chrome_trace_from_tracer(tr))
    print(f"  wrote host trace {p} — open in https://ui.perfetto.dev")


# ---------------------------------------------------------------------------
# `validate` subcommand — the event-driven fidelity harness
# ---------------------------------------------------------------------------
def build_validate_parser() -> argparse.ArgumentParser:
    from repro_torch.events.validate import DEFAULT_FIDELITY_PATH
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli validate",
        description="Event-driven fidelity harness: run each scenario's "
                    "study on --device, replay its top design points "
                    "with the scalar event engine and compare against "
                    "the analytic model.")
    ap.add_argument("scenario", nargs="*",
                    help="scenario JSON file(s); default: scenarios/*.json")
    ap.add_argument("--top", type=int, default=4,
                    help="points replayed per scenario")
    ap.add_argument("--schedules", type=_csv(str, "--schedules"),
                    default=("gpipe", "1f1b", "interleaved"),
                    help="pipeline schedules to replay")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="asserted |err| bound for gpipe/1f1b rows "
                         "(default 0.15)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke mode: first scenario, top 2, "
                         "gpipe+1f1b only")
    ap.add_argument("--out", default=DEFAULT_FIDELITY_PATH,
                    help="fidelity report JSON path (the reference's "
                         "FIDELITY.json is refused)")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="write the harness host trace (Chrome Trace "
                         "Event JSON, Perfetto-loadable)")
    ap.add_argument("--device", default="cuda",
                    help="where the studies' device work runs (default "
                         "cuda; cpu runs the plain paths)")
    return ap


def main_validate(argv: List[str]) -> int:
    from repro_torch.events.validate import DEFAULT_TOLERANCE, validate_zoo
    ap = build_validate_parser()
    args = ap.parse_args(argv)
    paths = args.scenario or sorted(
        str(p) for p in Path("scenarios").glob("*.json"))
    tol = DEFAULT_TOLERANCE if args.tolerance is None else args.tolerance
    top, schedules = args.top, tuple(args.schedules)
    if args.quick:
        paths = paths[:1]
        top = min(top, 2)
        schedules = tuple(s for s in schedules
                          if s in ("gpipe", "1f1b")) or ("gpipe",)
    try:
        with _maybe_tracing(args.trace):
            report = validate_zoo(paths, top=top, schedules=schedules,
                                  tolerance=tol, out=args.out,
                                  device=args.device)
    except (ValueError, KeyError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
    print(f"\n=== fidelity report: {report['n_scenarios']} scenarios, "
          f"{report['n_rows']} replays, tolerance ±{tol:.0%} "
          f"(studies on {report['device']}) ===")
    for block in report["scenarios"]:
        by_sched: dict = {}
        for r in block["rows"]:
            by_sched.setdefault(r["schedule"], []).append(r)
        parts = []
        for sched, rows in sorted(by_sched.items()):
            worst = max(abs(r["err"]) for r in rows)
            parts.append(f"{sched}: max|err| {worst * 100:4.1f}%")
        print(f"  {block['scenario']:24s} "
              f"({block['n_points']} pts)  " + "   ".join(parts))
    print(f"  wrote {args.out}")
    if report["n_violations"]:
        print(f"FAIL: {report['n_violations']} asserted replays exceed "
              f"±{tol:.0%}")
        return 1
    print(f"OK: all {report['n_asserted']} asserted replays within "
          f"±{tol:.0%} of the analytic model")
    return EXIT_OK


# ---------------------------------------------------------------------------
# `timeline` subcommand — the simulated-step Perfetto trace
# ---------------------------------------------------------------------------
def build_timeline_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli timeline",
        description="Replay a scenario's best design point through the "
                    "event engine with full timeline recording and "
                    "write the simulated training step as Chrome Trace "
                    "Event JSON (one track per pipeline stage / rail; "
                    "open in https://ui.perfetto.dev — the bubble is "
                    "the white space).")
    ap.add_argument("scenario", help="scenario JSON file")
    ap.add_argument("--schedule", default="1f1b",
                    choices=("gpipe", "1f1b", "interleaved"),
                    help="pipeline schedule to replay")
    ap.add_argument("--top", type=int, default=8,
                    help="top records considered when picking the "
                         "(preferably pipelined) point to replay")
    ap.add_argument("--out", default=None,
                    help="trace JSON path (default: artifacts/"
                         "timeline_<scenario>_<schedule>.json)")
    ap.add_argument("--device", default="cuda",
                    help="where the study's device work runs (default "
                         "cuda; cpu runs the plain paths)")
    return ap


def main_timeline(argv: List[str]) -> int:
    from repro_torch.events import replay
    from repro_torch.obs import (chrome_trace_from_event_result, track_idle,
                                 write_chrome_trace)
    from repro_torch.obs.bench import pipelined_programs
    ap = build_timeline_parser()
    args = ap.parse_args(argv)
    try:
        sc = Scenario.load(args.scenario)
        prog = pipelined_programs(sc, schedule=args.schedule,
                                  top=args.top, device=args.device)
    except (ValueError, KeyError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
    ev = replay(prog, record_timeline=True)
    trace = chrome_trace_from_event_result(ev, title=sc.name)
    out = args.out or (f"artifacts/timeline_{sc.name}_"
                       f"{args.schedule}.json")
    path = write_chrome_trace(out, trace)
    idle = track_idle(trace)
    total_idle = sum(v["idle_us"] for v in idle.values())
    total_busy = sum(v["busy_us"] for v in idle.values())
    print(f"=== {sc.name}: schedule={ev.schedule} pp={ev.n_stages} "
          f"n_micro={ev.n_micro} ===")
    print(f"  step {ev.step_time * 1e3:.3f} ms  bubble {ev.bubble:.3f}  "
          f"reconf {ev.n_reconf} (wait {ev.reconf_wait_s * 1e3:.3f} ms)")
    print(f"  device tracks: {len(idle)}  busy {total_busy / 1e3:.3f} ms"
          f"  idle {total_idle / 1e3:.3f} ms "
          f"({total_idle / max(total_idle + total_busy, 1e-12):.0%})")
    print(f"  wrote {path} — open in https://ui.perfetto.dev")
    return EXIT_OK


# ---------------------------------------------------------------------------
# `calibrate` subcommand — measured kernel constants + the drift gate
# ---------------------------------------------------------------------------
def build_calibrate_parser() -> argparse.ArgumentParser:
    from repro_torch.calib import DEFAULT_CALIB_PATH
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli calibrate",
        description="Execution-grounded calibration (repro_torch.obs."
                    "profile + repro_torch.calib): run the port's "
                    "kernels over an (M, N) grid, fit the analytic cost "
                    "constants (effective peak FLOP/s, HBM bytes/s, and "
                    "the M/(M+half) efficiency curves), and write the "
                    "schema-versioned artifact.  --check re-measures "
                    "and gates per-kernel drift against the artifact "
                    "instead (exit 1 on breach).")
    ap.add_argument("--out", default=DEFAULT_CALIB_PATH,
                    help="calibration artifact path (also the artifact "
                         "--check compares against)")
    ap.add_argument("--kernels", type=_csv(str, "--kernels"),
                    default=None,
                    help="comma list of kernels (default: all; see "
                         "repro_torch.obs.profile.PROFILE_KERNELS)")
    ap.add_argument("--quick", action="store_true",
                    help="CI grid: drop the most expensive point per "
                         "kernel, 2 reps")
    ap.add_argument("--check", action="store_true",
                    help="drift mode: re-measure and compare against "
                         "--out instead of rewriting it")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (default cuda; cpu times "
                         "the plain versions)")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="write the profile host trace (spans + "
                         "achieved-rate counter tracks, Perfetto-"
                         "loadable)")
    return ap


def main_calibrate(argv: List[str]) -> int:
    from repro_torch.calib import (card_fit_faults, check_drift,
                                   fit_calibration, load_calibration,
                                   write_calibration)
    from repro_torch.obs.profile import profile_kernels
    ap = build_calibrate_parser()
    args = ap.parse_args(argv)
    try:
        committed = load_calibration(args.out) if args.check else None
        with _maybe_tracing(args.trace):
            measurements = profile_kernels(args.kernels, quick=args.quick,
                                           device=args.device)
        calib = fit_calibration(measurements, quick=args.quick,
                                device=args.device)
    except (ValueError, KeyError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
    eff = calib["effective"]
    prov = calib["provenance"]
    print(f"\n=== calibrate: {len(measurements)} measurements, "
          f"{len(calib['kernels'])} kernels "
          f"({prov['backend']}/{prov.get('card', prov['device'])}) ===")
    impls = {r["kernel"]: r["impl"] for r in measurements}
    for name, f in sorted(calib["kernels"].items()):
        unit = "FLOP/s" if f["kind"] == "compute" else "B/s"
        tail = (f"  n_half={f['n_half']:7.1f}" if "n_half" in f else "")
        print(f"  {name:22s} {f['kind']:7s} peak {f['peak']:.3e} {unit}"
              f"  m_half={f['m_half']:7.1f}  "
              f"resid {f['rel_rmse'] * 100:4.1f}%{tail}  [{impls[name]}]")
    if "die_tflops" in eff:
        print(f"  effective: die_tflops={eff['die_tflops']:.4f} "
              f"gemm_m_half={eff.get('gemm_m_half', 0.0):.1f} "
              f"gemm_n_half={eff.get('gemm_n_half', 0.0):.1f}")
    if "hbm_bw_per_die" in eff:
        print(f"  effective: hbm_bw_per_die="
              f"{eff['hbm_bw_per_die']:.3e} B/s")
    faults = card_fit_faults(calib) if prov["backend"] == "cuda" else []
    for f in faults:
        print(f"  FAIL {f}")
    if faults:
        print("FAIL: the card's fits cannot stand; nothing written")
        return 1

    if args.check:
        print(f"\ndrift vs {args.out}:")
        rows = check_drift(calib, committed)
        n_fail = sum(not r["ok"] for r in rows)
        n_gated = sum(r["asserted"] for r in rows)
        if n_fail:
            print(f"FAIL: {n_fail}/{n_gated} gated constants drifted "
                  f"beyond tolerance")
            return 1
        print(f"OK: all {n_gated} gated constants within tolerance")
        return EXIT_OK

    try:
        print(f"  wrote {write_calibration(calib, args.out)}")
    except (ValueError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
    return EXIT_OK


# ---------------------------------------------------------------------------
# `lint` subcommand — chiplint, the AST invariant analyzer
# ---------------------------------------------------------------------------
def build_lint_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli lint",
        description="chiplint: AST-based invariant analysis "
                    "(repro_torch.analysis) — parity drift between the "
                    "scalar/batched/event-DAG engines, host syncs on the "
                    "card's call graph (torch-hygiene), physical-unit "
                    "mismatches, determinism and metric-schema "
                    "violations.  Exit 1 on findings not covered by the "
                    "baseline, or on stale baseline entries.")
    ap.add_argument("--root", default=".",
                    help="repository root to analyze (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="grandfathered-findings file (default: "
                         "<root>/chiplint_torch_baseline.json; absent "
                         "file = empty baseline)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings, "
                         "keeping the reasons of entries that stay, and "
                         "exit 0")
    ap.add_argument("--json", default=None, metavar="REPORT_JSON",
                    help="also write the machine-readable findings "
                         "report")
    return ap


def main_lint(argv: List[str]) -> int:
    import json

    from repro_torch.analysis import (DEFAULT_CONFIG, diff_baseline,
                                      load_baseline, load_baseline_reasons,
                                      run_lint, save_baseline)
    from repro_torch.analysis.findings import DEFAULT_BASELINE, report_dict

    ap = build_lint_parser()
    args = ap.parse_args(argv)
    root = Path(args.root)
    if not root.is_dir():
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: no such directory: "
                            f"{root}\n")
    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE

    report = run_lint(root, DEFAULT_CONFIG)
    try:
        baseline = load_baseline(baseline_path)
        reasons = load_baseline_reasons(baseline_path)
    except (ValueError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
    if args.update_baseline:
        p = save_baseline(baseline_path, report.findings, reasons)
        print(f"chiplint: baselined {len(report.findings)} finding(s) "
              f"-> {p}")
        return EXIT_OK
    new, stale = diff_baseline(report.findings, baseline)

    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            report_dict(report.findings, new, stale,
                        report.n_suppressed, report.n_files),
            indent=1) + "\n")
        print(f"  wrote {out}")

    for f in new:
        print(f.render())
    for fp in stale:
        print(f"stale baseline entry (fix shipped? run "
              f"--update-baseline): {fp}")
    n_base = len(report.findings) - len(new)
    print(f"chiplint: {report.n_files} files, "
          f"{len(report.findings)} finding(s) "
          f"({n_base} baselined, {len(new)} new, "
          f"{report.n_suppressed} suppressed, "
          f"{len(stale)} stale baseline)")
    return EXIT_OK if not new and not stale else 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "validate":
        return main_validate(argv[1:])
    if argv and argv[0] == "timeline":
        return main_timeline(argv[1:])
    if argv and argv[0] == "calibrate":
        return main_calibrate(argv[1:])
    if argv and argv[0] == "lint":
        return main_lint(argv[1:])
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        scenarios = build_scenarios(args)
    except (ValueError, KeyError, OSError) as e:
        ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")

    all_feasible = True
    with _maybe_tracing(args.trace):
        for sc in scenarios:
            try:
                res = Study(sc).run(device=args.device)
            except ValueError as e:      # driver_kw / grid-shape misuse
                ap.exit(EXIT_USAGE, f"{ap.prog}: error: {e}\n")
            _print_study(res, args.top)
            path = res.save(_out_path(args.out, sc, len(scenarios)))
            print(f"  wrote {path}")
            if res.best is None:
                all_feasible = False
    return EXIT_OK if all_feasible else EXIT_INFEASIBLE


if __name__ == "__main__":
    sys.exit(main())
