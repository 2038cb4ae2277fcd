"""Contextvar-scoped tracing spans — the host-side flight recorder.

A ``Tracer`` collects COMPLETED spans: every ``with span("name", k=v):``
block appends one ``{name, ts_ns, dur_ns, depth, args}`` record when it
exits, timestamped with ``time.perf_counter_ns`` relative to the
tracer's birth.  Spans nest lexically and are LIFO-checked — closing a
span that is not the innermost open one raises, as does a clock that
runs backwards, so a trace that exports cleanly is structurally sound
by construction.

The layer is built to be left in hot loops permanently: when no tracer
is installed (the default), ``span()`` returns a module-level no-op
singleton — no allocation, no clock read, two dict lookups — so
instrumented code costs nothing when tracing is off (pinned by an
allocation guard in tests/test_obs.py).

Install a tracer for a region with::

    with tracing() as tr:
        with span("study.run", driver="exhaustive"):
            ...
    export.chrome_trace_from_tracer(tr)

The contextvar scoping means concurrent tasks (threads, asyncio) each
see their own tracer, and library code never needs a tracer argument.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple

_TRACER: ContextVar[Optional["Tracer"]] = ContextVar(
    "repro_obs_tracer", default=None)


class Tracer:
    """Accumulates completed spans and counter samples for one region."""

    def __init__(self):
        self.t0_ns = time.perf_counter_ns()
        self.events: List[Dict[str, Any]] = []
        # (name, ts_ns, value) — cumulative counter values over time,
        # exported as Chrome-trace "C" counter tracks
        self.counter_samples: List[Tuple[str, int, float]] = []
        self._stack: List["_Span"] = []

    def now_ns(self) -> int:
        return time.perf_counter_ns() - self.t0_ns

    def sample(self, name: str, value: float) -> None:
        self.counter_samples.append((name, self.now_ns(), float(value)))

    @property
    def depth(self) -> int:
        return len(self._stack)


class _Span:
    """Live span; records itself on the owning tracer at ``__exit__``."""

    __slots__ = ("tracer", "name", "args", "start_ns", "_depth")

    def __init__(self, tracer: Tracer, name: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.start_ns = 0
        self._depth = 0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self._depth = len(tr._stack)
        tr._stack.append(self)
        self.start_ns = tr.now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self.tracer
        if not tr._stack or tr._stack[-1] is not self:
            open_name = tr._stack[-1].name if tr._stack else None
            raise RuntimeError(
                f"span {self.name!r} closed out of LIFO order "
                f"(innermost open span: {open_name!r})")
        tr._stack.pop()
        end_ns = tr.now_ns()
        if end_ns < self.start_ns:
            raise RuntimeError(
                f"span {self.name!r}: end {end_ns} < start "
                f"{self.start_ns} — non-monotonic clock")
        tr.events.append({"name": self.name, "ts_ns": self.start_ns,
                          "dur_ns": end_ns - self.start_ns,
                          "depth": self._depth, "args": self.args})
        return False


class _NullSpan:
    """Zero-cost stand-in handed out when tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args: Any):
    """Context manager timing one region.  With no tracer installed this
    returns a shared no-op singleton: safe (and free) in hot loops."""
    tr = _TRACER.get()
    if tr is None:
        return _NULL_SPAN
    return _Span(tr, name, args or None)


def current_tracer() -> Optional[Tracer]:
    return _TRACER.get()


@contextmanager
def tracing(tracer: Optional[Tracer] = None):
    """Install ``tracer`` (or a fresh one) for the dynamic extent of the
    block; yields the tracer for export."""
    tr = tracer if tracer is not None else Tracer()
    token = _TRACER.set(tr)
    try:
        yield tr
    finally:
        _TRACER.reset(token)
    if tr._stack:
        raise RuntimeError(
            f"{len(tr._stack)} span(s) never closed "
            f"(innermost: {tr._stack[-1].name!r})")
