"""Chrome Trace Event Format export — open the JSON in Perfetto
(https://ui.perfetto.dev) or chrome://tracing.

Two producers share the format:

* ``chrome_trace_from_tracer`` — the HOST trace: where ``Study.run()``
  spent its wall time (sweep rounds, refinement, validation), one
  nested-span track plus one counter track per metric name.

* ``chrome_trace_from_event_result`` — the SIMULATED step: an
  ``EventResult`` replayed with ``record_timeline=True`` becomes one
  track per pipeline stage (compute tiles and PHASE-tagged collectives)
  plus one track per (rail, stage) resource, with OCS reconfigurations
  as instant markers and explicit ``ocs_wait`` stall spans.  Timestamps
  are simulated seconds scaled to microseconds, so a gpipe and an
  interleaved trace of the same design point are directly diffable —
  the bubble is the white space.

``validate_chrome_trace`` structurally checks the required keys and
types (what tests pin), and ``track_idle`` computes per-track busy/idle
from the events themselves — the device tracks' busy and idle that
``cli timeline`` prints.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import Tracer

# Process ids in the simulated-step trace
PID_HOST = 1
PID_DEVICES = 1
PID_RAILS = 2

_NS_PER_US = 1000.0
_S_TO_US = 1e6


def _meta(pid: int, name: str, tid: Optional[int] = None) -> dict:
    ev = {"ph": "M", "pid": pid, "ts": 0,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


# ---------------------------------------------------------------------------
# Host trace (Tracer -> spans + counter tracks)
# ---------------------------------------------------------------------------
def chrome_trace_from_tracer(tracer: Tracer,
                             process_name: str = "repro_torch host"
                             ) -> dict:
    events: List[dict] = [_meta(PID_HOST, process_name),
                          _meta(PID_HOST, "spans", tid=1)]
    for e in tracer.events:
        events.append({
            "name": e["name"], "cat": "host", "ph": "X",
            "ts": e["ts_ns"] / _NS_PER_US,
            "dur": e["dur_ns"] / _NS_PER_US,
            "pid": PID_HOST, "tid": 1,
            "args": dict(e["args"] or {}),
        })
    for name, ts_ns, value in tracer.counter_samples:
        events.append({
            "name": name, "cat": "metric", "ph": "C",
            "ts": ts_ns / _NS_PER_US, "pid": PID_HOST,
            "args": {"value": value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Simulated-step trace (EventResult -> device/rail tracks)
# ---------------------------------------------------------------------------
def chrome_trace_from_event_result(ev, title: str = "simulated step"
                                   ) -> dict:
    """Chrome trace of one event-engine replay.  ``ev`` must come from
    ``replay(prog, record_timeline=True)`` — otherwise the per-device
    and per-rail timelines are empty and there is nothing to draw."""
    if not ev.device_timeline:
        raise ValueError(
            "EventResult has no device timeline; replay the program "
            "with record_timeline=True")
    events: List[dict] = [
        _meta(PID_DEVICES, f"{title} [{ev.schedule}] devices"),
        _meta(PID_RAILS, f"{title} [{ev.schedule}] rails"),
    ]
    for s in range(ev.n_stages):
        events.append(_meta(PID_DEVICES, f"stage {s}", tid=s))
    rail_tid: Dict[Tuple[str, int], int] = {}
    for rail, s, _label, _t0, _t1 in ev.rail_timeline:
        rail_tid.setdefault((rail, s), len(rail_tid))
    for rail, s, _t, _w in ev.reconf_events:
        rail_tid.setdefault((rail, s), len(rail_tid))
    for (rail, s), tid in sorted(rail_tid.items(), key=lambda kv: kv[1]):
        events.append(_meta(PID_RAILS, f"rail {rail} / stage {s}",
                            tid=tid))
    for s, kind, phase, label, t0, t1 in ev.device_timeline:
        events.append({
            "name": label, "cat": kind, "ph": "X",
            "ts": t0 * _S_TO_US, "dur": (t1 - t0) * _S_TO_US,
            "pid": PID_DEVICES, "tid": int(s),
            "args": {"phase": phase, "kind": kind},
        })
    for rail, s, label, t0, t1 in ev.rail_timeline:
        events.append({
            "name": label, "cat": "rail", "ph": "X",
            "ts": t0 * _S_TO_US, "dur": (t1 - t0) * _S_TO_US,
            "pid": PID_RAILS, "tid": rail_tid[(rail, s)],
            "args": {"rail": rail},
        })
    for rail, s, t, wait in ev.reconf_events:
        tid = rail_tid[(rail, s)]
        events.append({
            "name": "ocs_reconfig", "cat": "ocs", "ph": "i", "s": "t",
            "ts": t * _S_TO_US, "pid": PID_RAILS, "tid": tid,
            "args": {"rail": rail, "wait_s": wait},
        })
        if wait > 0:
            events.append({
                "name": "ocs_wait", "cat": "ocs", "ph": "X",
                "ts": t * _S_TO_US, "dur": wait * _S_TO_US,
                "pid": PID_RAILS, "tid": tid,
                "args": {"rail": rail},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schedule": ev.schedule,
                          "n_stages": ev.n_stages,
                          "n_micro": ev.n_micro,
                          "step_time_s": ev.step_time,
                          "bubble": ev.bubble}}


# ---------------------------------------------------------------------------
# IO + structural validation
# ---------------------------------------------------------------------------
def write_chrome_trace(path, trace: dict) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace) + "\n")
    return p


def validate_chrome_trace(trace: dict) -> Dict[str, int]:
    """Structural check of the Chrome Trace Event Format contract; raises
    ``ValueError`` on the first violation, returns per-phase counts."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' key")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    counts: Dict[str, int] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        ph = e.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"event {i} missing string 'ph'")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"event {i} ({ph}) missing string 'name'")
        if not isinstance(e.get("pid"), int):
            raise ValueError(f"event {i} ({ph}) missing int 'pid'")
        if ph in ("X", "C", "i", "M"):
            if ph != "M" and not isinstance(e.get("ts"), (int, float)):
                raise ValueError(f"event {i} ({ph}) missing numeric 'ts'")
        else:
            raise ValueError(f"event {i} has unsupported phase {ph!r}")
        if ph == "X":
            if not isinstance(e.get("tid"), int):
                raise ValueError(f"event {i} (X) missing int 'tid'")
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event {i} (X) needs numeric 'dur' >= 0, got {dur!r}")
        elif ph == "i":
            if e.get("s") not in ("t", "p", "g"):
                raise ValueError(f"event {i} (i) needs scope 's' in "
                                 f"t/p/g, got {e.get('s')!r}")
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"event {i} (C) needs numeric 'args'")
        elif ph == "M":
            if e.get("name") not in ("process_name", "thread_name"):
                raise ValueError(f"event {i} (M) has unknown metadata "
                                 f"name {e.get('name')!r}")
            if not isinstance(e.get("args"), dict):
                raise ValueError(f"event {i} (M) missing 'args'")
        counts[ph] = counts.get(ph, 0) + 1
    return counts


def track_idle(trace: dict, pid: int = PID_DEVICES
               ) -> Dict[int, Dict[str, float]]:
    """Per-track busy/idle (µs) for the "X" events of one process,
    measured against the process-wide [earliest start, latest end]
    window so tracks share a time base.  Busy is the union of event
    intervals (overlaps counted once); idle is the rest of the window —
    on a device track, the pipeline bubble."""
    per_tid: Dict[int, List[Tuple[float, float]]] = {}
    lo, hi = float("inf"), float("-inf")
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("pid") != pid:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        per_tid.setdefault(int(e["tid"]), []).append((t0, t1))
        lo, hi = min(lo, t0), max(hi, t1)
    out: Dict[int, Dict[str, float]] = {}
    span = max(hi - lo, 0.0) if per_tid else 0.0
    for tid, iv in per_tid.items():
        iv.sort()
        busy, cur0, cur1 = 0.0, iv[0][0], iv[0][1]
        for t0, t1 in iv[1:]:
            if t0 > cur1:
                busy += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        busy += cur1 - cur0
        out[tid] = {"span_us": span, "busy_us": busy,
                    "idle_us": max(span - busy, 0.0)}
    return out
