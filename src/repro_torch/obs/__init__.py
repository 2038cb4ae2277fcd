"""``repro_torch.obs`` — tracing spans and named counters.

* ``trace``   — contextvar-scoped nested spans with a no-op fast path
  (``span``; ``trace.tracing`` installs a tracer for a region);
* ``metrics`` — named counters/gauges, scoped registries, frozen JSON
  snapshot schema (``METRICS_SCHEMA``);
* ``bench``   — ``time_fn``, the timer of the kernel measurements;
* ``profile`` — the kernel profiling harness behind ``cli calibrate``.

The Chrome-trace export and the bench gate over the ``BENCH_*`` files
are not ported.
"""
from repro_torch.obs.metrics import gauge, inc, scope
from repro_torch.obs.trace import span

__all__ = ["gauge", "inc", "scope", "span"]
