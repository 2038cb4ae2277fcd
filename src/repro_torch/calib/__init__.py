"""``repro_torch.calib`` — fit analytic cost constants from kernel profiles.

The execution-grounded half of the cost model: ``repro_torch.obs.profile``
measures the port's kernels over an (M, N) grid — on the card its four
hand-written CUDA kernels (flash attention's forward, ``moe_gmm``,
``ssd_scan``, ``rmsnorm``) in float32; this package fits the analytic
constants the simulator runs on — per kernel a
``y = peak * x / (x + half)`` saturation curve (the exact family
``core/simulator._gemm_eff`` models with ``gemm_m_half`` /
``gemm_n_half``), plus the effective peak FLOP/s and HBM bytes/s the
curves saturate to — and writes the schema-versioned artifact
(``CALIB_h100.json`` by default) with full provenance (torch and CUDA
versions, the device and, on the card, its name and power limit as
``nvidia-smi`` reports them, the commit, and the raw measurement rows the
fits came from, each naming the implementation that ran).

Consumers:

* ``HW.calibrated(calib)`` — an ``HW`` running on the measured
  ``effective`` block (``die_tflops`` = fitted peak / 1e12 with
  ``mfu_ceiling=1.0`` — the fitted peak is already the ACHIEVED
  asymptote — and ``model_gemm_eff=True`` with the fitted halves);
* ``Scenario.calibration`` — a path to the artifact; ``build_hw()``
  starts from ``HW.calibrated`` and ``Study.run`` stamps the constants
  into ``StudyResult.provenance["calibration"]``;
* ``python -m repro_torch.cli calibrate`` — measure + fit + write, and
  the ``--check`` drift gate comparing a fresh measurement against an
  artifact.

The reference package's committed ``CALIB.json`` and ``FIDELITY.json``
are read here (an artifact is an artifact) but never written:
``write_calibration`` and ``stamp_fidelity`` refuse them.

Drift gating: fitted PEAKS are asserted within ``2**log2_peak`` of the
committed artifact (default 8x — wide enough for a different host,
narrow enough to catch a 100-1000x regression like a plain-version
fallback or a per-row python loop).  The ``half`` shape constants are
reported but NOT gated — they are poorly conditioned on the quick grid.
"""
from __future__ import annotations

import functools
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CALIB_SCHEMA = 1
DEFAULT_CALIB_PATH = "CALIB_h100.json"

# the reference package's committed artifacts: read, never written
_REPO_ROOT = Path(__file__).resolve().parents[3]
_REFERENCE_ARTIFACTS = ("CALIB.json", "FIDELITY.json")

# |log2(current/committed)| tolerances for `calibrate --check`;
# overridable per-artifact via a committed "check_tolerances" block
DEFAULT_TOLERANCES = {"log2_peak": 3.0, "log2_half": 2.0}

# fit_saturation searches half over [min(x) / span, max(x) * span]
_HALF_SPAN = 16.0

# The H100 SXM's peaks for what calibration measures on it: float32 on
# the FMA pipes (132 SMs x 128 lanes x 2 FLOP x 1.98 GHz) and HBM3.  A
# card's fit past them means the timer or the count is wrong.
CARD_PEAKS = {"compute": 67e12, "memory": 3.35e12}


# ---------------------------------------------------------------------------
# Curve fitting
# ---------------------------------------------------------------------------
def fit_saturation(xs: Sequence[float], ys: Sequence[float]
                   ) -> Tuple[float, float, float]:
    """Least-squares fit of ``y = peak * x / (x + half)``.

    Grid-searches ``half`` over a log-spaced range spanning the data
    (the model is linear in ``peak`` given ``half``, so ``peak`` is
    closed-form per candidate).  Returns ``(peak, half, rel_rmse)``
    where ``rel_rmse`` is the RMS residual relative to the mean level.
    Deterministic; pure python/numpy.
    """
    import numpy as np
    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    if x.size < 2:
        raise ValueError(f"fit_saturation needs >= 2 points, got {x.size}")
    if np.any(x <= 0) or np.any(y <= 0):
        raise ValueError("fit_saturation needs positive x and y")
    halves = np.geomspace(float(x.min()) / _HALF_SPAN,
                          float(x.max()) * _HALF_SPAN, 257)
    best = None
    for h in halves:
        f = x / (x + h)
        p = float((f * y).sum() / (f * f).sum())
        sse = float(((y - p * f) ** 2).sum())
        if best is None or sse < best[0]:
            best = (sse, p, float(h))
    sse, peak, half = best
    rel_rmse = math.sqrt(sse / x.size) / float(y.mean())
    return peak, half, rel_rmse


def _fit_kernel(name: str, rows: List[dict]) -> dict:
    """Fit one kernel's measurement rows (compute kernels fit achieved
    FLOP/s, memory kernels bytes/s) on the M axis, plus the N axis when
    swept (moe_gmm)."""
    kind = rows[0]["kind"]
    rate = "flops_per_s" if kind == "compute" else "bytes_per_s"
    m_rows = [r for r in rows if r["axis"] == "m"]
    peak, half, resid = fit_saturation([r["x"] for r in m_rows],
                                       [r[rate] for r in m_rows])
    out = {"kind": kind, "n_points": len(rows),
           "peak": peak, "m_half": half, "rel_rmse": resid,
           "best_measured": max(r[rate] for r in rows)}
    n_rows = [r for r in rows if r["axis"] == "n"]
    if len(n_rows) >= 2:
        _, n_half, n_resid = fit_saturation([r["x"] for r in n_rows],
                                            [r[rate] for r in n_rows])
        out["n_half"] = n_half
        out["n_rel_rmse"] = n_resid
    return out


def _geomean(vals: Sequence[float]) -> float:
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def _effective(kernels: Dict[str, dict]) -> dict:
    """The ``HW``-field overrides the fits imply.

    ``die_tflops`` is the best compute asymptote and ``hbm_bw_per_die``
    the best memory asymptote; both are ACHIEVED peaks, so
    ``mfu_ceiling`` goes to 1.0 and the shape curve carries the rest
    (``model_gemm_eff=True``).  ``gemm_m_half``/``gemm_n_half`` come
    from the grouped-matmul fit — the direct analog of the simulator's
    GEMM shape curve — falling back to the geometric mean of the
    compute kernels' halves.
    """
    comp = {k: v for k, v in kernels.items() if v["kind"] == "compute"}
    mem = {k: v for k, v in kernels.items() if v["kind"] == "memory"}
    eff: dict = {}
    if comp:
        eff["die_tflops"] = max(v["peak"] for v in comp.values()) / 1e12
        eff["mfu_ceiling"] = 1.0
        eff["model_gemm_eff"] = True
        gmm = kernels.get("moe_gmm")
        eff["gemm_m_half"] = (gmm or {}).get("m_half") or _geomean(
            [v["m_half"] for v in comp.values()])
        eff["gemm_n_half"] = (gmm or {}).get("n_half", 128.0)
    if mem:
        eff["hbm_bw_per_die"] = max(v["peak"] for v in mem.values())
    return eff


# ---------------------------------------------------------------------------
# Artifact build / io
# ---------------------------------------------------------------------------
def _card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _provenance(measurements: List[dict], quick: bool, device) -> dict:
    import platform
    import subprocess

    import torch
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    dev = torch.device(device)
    prov = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else platform.processor() or "cpu"),
        "python": platform.python_version(),
        "machine": platform.machine(),
        "commit": commit,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "quick": bool(quick),
        "n_measurements": len(measurements),
        "wall_s": sum(r["time_s"] * r["reps"] for r in measurements),
    }
    if dev.type == "cuda":
        prov["card"] = _card_line()
    return prov


def fit_calibration(measurements: List[dict], *, quick: bool = False,
                    device="cpu") -> dict:
    """Fit per-kernel curves + the effective constants from
    ``profile_kernels`` output; returns the full CALIB artifact dict
    (measurement rows embedded as the fit's provenance trail).
    ``device`` is where the rows were measured, for the provenance; the
    fit itself is host arithmetic."""
    if not measurements:
        raise ValueError("no measurements to fit")
    by_kernel: Dict[str, List[dict]] = {}
    for r in measurements:
        by_kernel.setdefault(r["kernel"], []).append(r)
    kernels = {name: _fit_kernel(name, rows)
               for name, rows in by_kernel.items()}
    return {
        "schema": CALIB_SCHEMA,
        "provenance": _provenance(measurements, quick, device),
        "check_tolerances": dict(DEFAULT_TOLERANCES),
        "kernels": kernels,
        "effective": _effective(kernels),
        "measurements": measurements,
    }


def card_fit_faults(calib: dict) -> List[str]:
    """Why a card artifact's fits cannot stand, ``[]`` when they can: a
    fitted peak over the card's (``CARD_PEAKS``), or a half at the top
    of ``fit_saturation``'s search, where the rate never bent inside the
    grid and the peak is an extrapolation.  A half at the bottom is a
    rate already flat at the first point, whose peak is its level."""
    faults = []
    for name, f in sorted(calib["kernels"].items()):
        card = CARD_PEAKS[f["kind"]]
        if f["peak"] > card:
            faults.append(f"{name}: fitted peak {f['peak']:.4g} is over "
                          f"the card's {card:.4g}")
        for axis, key in (("m", "m_half"), ("n", "n_half")):
            xs = [r["x"] for r in calib["measurements"]
                  if r["kernel"] == name and r["axis"] == axis]
            if key in f and f[key] >= max(xs) * _HALF_SPAN * (1 - 1e-9):
                faults.append(f"{name}: {key} {f[key]:.6g} is at the top "
                              f"of the fit's search ({_HALF_SPAN:g} x the "
                              f"largest {axis}, {max(xs)}): the rate never "
                              f"bent in the grid")
    return faults


def _refuse_reference_artifact(path) -> Path:
    p = Path(path)
    if p.resolve() in {_REPO_ROOT / n for n in _REFERENCE_ARTIFACTS}:
        raise ValueError(f"{p} is the reference package's committed "
                         f"artifact; the port writes its own (default "
                         f"{DEFAULT_CALIB_PATH})")
    return p


def write_calibration(calib: dict, path) -> Path:
    p = _refuse_reference_artifact(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(calib, indent=1, sort_keys=True) + "\n")
    load_calibration.cache_clear()
    return p


def _validate_calib(calib: dict, origin: str) -> dict:
    schema = calib.get("schema")
    if schema != CALIB_SCHEMA:
        raise ValueError(f"{origin}: unsupported calibration schema "
                         f"{schema!r} (this build reads {CALIB_SCHEMA})")
    for key in ("kernels", "effective", "provenance"):
        if not isinstance(calib.get(key), dict):
            raise ValueError(f"{origin}: calibration artifact has no "
                             f"{key!r} block")
    return calib


@functools.lru_cache(maxsize=16)
def load_calibration(path) -> dict:
    """Read + schema-validate a CALIB.json artifact (small, cached)."""
    p = Path(path)
    if not p.exists():
        raise ValueError(f"no calibration artifact at {p} — run "
                         f"`python -m repro_torch.cli calibrate` first")
    try:
        calib = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"{p}: not valid JSON: {e}") from None
    return _validate_calib(calib, str(p))


# ---------------------------------------------------------------------------
# Drift gate (`cli calibrate --check`)
# ---------------------------------------------------------------------------
def _drift_row(name: str, cur: Optional[float], ref: Optional[float],
               tol_log2: float, asserted: bool) -> dict:
    if not cur or not ref or cur <= 0 or ref <= 0:
        drift, ok = float("inf"), False
    else:
        drift = abs(math.log2(cur / ref))
        ok = drift <= tol_log2
    if not asserted:
        ok = True
    return {"metric": name, "current": cur, "committed": ref,
            "drift_log2": drift, "tol_log2": tol_log2,
            "asserted": asserted, "ok": ok}


def check_drift(current: dict, committed: dict) -> List[dict]:
    """Per-kernel relative drift of ``current`` fits vs the committed
    artifact; prints one uniform OK/FAIL/info line per constant
    (``obs.bench.enforce`` style) and returns the row dicts.  Asserted:
    per-kernel peaks + the effective peaks.  Reported only: the
    ``half`` shape constants (see module docstring)."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(committed.get("check_tolerances", {}))
    rows: List[dict] = []
    # kernels absent from the CURRENT run (a --kernels subset check)
    # are simply not compared; a kernel the committed artifact lacks
    # still FAILs via the missing-ref path below.
    names = sorted(current["kernels"])
    for name in names:
        cur = current["kernels"][name]
        ref = committed["kernels"].get(name, {})
        rows.append(_drift_row(f"{name}.peak", cur.get("peak"),
                               ref.get("peak"), tol["log2_peak"], True))
        rows.append(_drift_row(f"{name}.m_half", cur.get("m_half"),
                               ref.get("m_half"), tol["log2_half"], False))
        if "n_half" in ref or "n_half" in cur:
            rows.append(_drift_row(
                f"{name}.n_half", cur.get("n_half"), ref.get("n_half"),
                tol["log2_half"], False))
    for f in ("die_tflops", "hbm_bw_per_die"):
        if f not in current["effective"]:
            continue            # subset run measured no such kernels
        rows.append(_drift_row(
            f"effective.{f}", current["effective"][f],
            committed["effective"].get(f), tol["log2_peak"], True))
    for r in rows:
        if not r["asserted"]:
            mark = "info"
        else:
            mark = "OK  " if r["ok"] else "FAIL"
        cur, ref = r["current"], r["committed"]
        if cur and ref and math.isfinite(r["drift_log2"]):
            detail = (f"{cur:.3e} vs {ref:.3e} "
                      f"(drift {2 ** r['drift_log2']:.2f}x"
                      f"{'' if r['asserted'] else ', not gated'}"
                      f" <= {2 ** r['tol_log2']:.0f}x)")
        else:
            detail = f"{cur!r} vs {ref!r} (missing)"
        print(f"  {mark} calibrate.{r['metric']}: {detail}")
    return rows


# ---------------------------------------------------------------------------
# Stack integration blocks
# ---------------------------------------------------------------------------
# where an artifact was measured (an artifact of the reference package
# has ``jax`` in place of ``torch``/``cuda``, and no ``card``)
_MEASURED_ON = ("torch", "cuda", "backend", "device", "card", "commit",
                "created")

def calibration_block(path) -> dict:
    """The ``StudyResult.provenance['calibration']`` block for a run
    with ``Scenario.calibration`` set: the effective constants the
    study executed on plus the artifact's measurement provenance."""
    calib = load_calibration(path)
    prov = calib["provenance"]
    return {"schema": calib["schema"], "path": str(path),
            "effective": dict(calib["effective"]),
            "measured_on": {k: prov.get(k) for k in
                            _MEASURED_ON}}


def execution_block(calib: dict, source: str = DEFAULT_CALIB_PATH) -> dict:
    """The execution-grounded block of the fidelity report: the
    measured anchor behind the analytic-vs-event agreement."""
    prov = calib["provenance"]
    return {
        "source": str(source),
        "calib_schema": calib["schema"],
        "measured_on": {k: prov.get(k) for k in _MEASURED_ON},
        "effective": dict(calib["effective"]),
        "kernels": {name: {"kind": f["kind"], "peak": f["peak"],
                           "m_half": f["m_half"],
                           "rel_rmse": f["rel_rmse"]}
                    for name, f in sorted(calib["kernels"].items())},
    }


def stamp_fidelity(calib: dict, fidelity_path) -> Optional[Path]:
    """Rewrite the fidelity report at ``fidelity_path`` (the caller's;
    never the reference's committed ``FIDELITY.json``) with this
    calibration's ``execution`` block (no-op returning None when the
    report is absent)."""
    p = _refuse_reference_artifact(fidelity_path)
    if not p.exists():
        return None
    report = json.loads(p.read_text())
    report["execution"] = execution_block(calib, source=DEFAULT_CALIB_PATH)
    p.write_text(json.dumps(report, indent=2) + "\n")
    return p
