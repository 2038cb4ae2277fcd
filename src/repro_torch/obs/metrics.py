"""Named counters and gauges with a frozen JSON snapshot schema.

Counters are monotonically increasing event counts
(``batch_replay.records``, ``dse.cache.hits``); gauges are
last-write-wins levels.  Names are dotted
``<subsystem>.<noun>[.<qualifier>]`` — see DESIGN.md §observability for
the naming discipline.

Two accumulation levels:

* a process-global root registry (``root()``) that everything folds
  into eventually, and
* contextvar-stacked SCOPES (``with scope() as m:``) giving a region —
  one ``Study.run()``, one fidelity harness sweep — its own registry.
  On exit a scope folds its counts into its parent (outer scope or the
  root), so per-run metric blocks and whole-process totals coexist.

``inc``/``gauge`` write to the innermost scope and, when a tracer is
installed (``repro_torch.obs.trace``), also emit a counter sample so Perfetto
renders the counter as a track over time.  ``snapshot()`` is the frozen
wire format (``METRICS_SCHEMA``) embedded in ``StudyResult.provenance``
and round-tripped through its JSON artifact.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Optional

from repro_torch.obs import trace as _trace

# Frozen snapshot schema: {"schema": 1, "counters": {name: number},
# "gauges": {name: number}}.  Bump only on incompatible change.
METRICS_SCHEMA = 1

# Declared metric names.  Every ``inc``/``gauge`` call site with a
# literal name uses a name listed here, so a typo'd metric name does not
# silently fork the snapshot schema consumers key on.  The reference's
# ``*.jax_*`` counters (jit calls, pad rows, retraces) have device-named
# counterparts: ``*.device_calls`` counts the calls that ran the scan's
# terms or the wavefront on the chosen device.
KNOWN_COUNTERS = frozenset({
    "batch_replay.device_calls",
    "batch_replay.records",
    "batched_sim.device_calls",
    "compile_batch.records",
    "dse.cache.fallback_rows",
    "dse.cache.hits",
    "dse.cache.sim",
    "outer.event_replayed",
    "outer.variant_cache.hits",
    "outer.variants_evaluated",
    "profile.kernels",
    "profile.measurements",
})
KNOWN_GAUGES = frozenset({
    "profile.achieved_gbs",
    "profile.achieved_tflops",
})


class Metrics:
    """One registry of counters and gauges."""

    __slots__ = ("counters", "gauges")

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    def inc(self, name: str, n: float = 1) -> float:
        v = self.counters.get(name, 0) + n
        self.counters[name] = v
        return v

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def snapshot(self) -> dict:
        return {"schema": METRICS_SCHEMA,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges)}

    def fold_into(self, parent: "Metrics") -> None:
        for k, v in self.counters.items():
            parent.counters[k] = parent.counters.get(k, 0) + v
        parent.gauges.update(self.gauges)


_ROOT = Metrics()
_SCOPE: ContextVar[Optional[Metrics]] = ContextVar(
    "repro_obs_metrics", default=None)


def root() -> Metrics:
    """The process-global registry every scope eventually folds into."""
    return _ROOT


def active() -> Metrics:
    """The innermost scope, or the root when none is open."""
    m = _SCOPE.get()
    return m if m is not None else _ROOT


def inc(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` in the active registry (and sample
    it on the installed tracer, if any)."""
    v = active().inc(name, n)
    tr = _trace.current_tracer()
    if tr is not None:
        tr.sample(name, v)


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` in the active registry (and, like ``inc``,
    sample it on the installed tracer)."""
    active().gauge(name, value)
    tr = _trace.current_tracer()
    if tr is not None:
        tr.sample(name, float(value))


@contextmanager
def scope():
    """Fresh registry for the block; folds into the parent on exit."""
    m = Metrics()
    token = _SCOPE.set(m)
    try:
        yield m
    finally:
        _SCOPE.reset(token)
        m.fold_into(active())
