"""``repro_torch.obs`` — tracing spans and named counters.

* ``trace``   — contextvar-scoped nested spans with a no-op fast path
  (``span``; ``trace.tracing`` installs a tracer for a region);
* ``metrics`` — named counters/gauges, scoped registries, frozen JSON
  snapshot schema (``METRICS_SCHEMA``).

The Chrome-trace export, the bench gate and the kernel profiler come
with the port's timer and calibration (ROADMAP A4, A5).
"""
from repro_torch.obs.metrics import gauge, inc, scope
from repro_torch.obs.trace import span

__all__ = ["gauge", "inc", "scope", "span"]
