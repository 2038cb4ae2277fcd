"""``repro_torch.obs`` — structured tracing, counters, Perfetto timelines.

* ``trace``   — contextvar-scoped nested spans with a no-op fast path
  (``span``; ``tracing`` installs a tracer for a region);
* ``metrics`` — named counters/gauges, scoped registries, frozen JSON
  snapshot schema (``METRICS_SCHEMA``);
* ``export``  — Chrome Trace Event Format JSON (Perfetto /
  chrome://tracing) for both the host pipeline and the simulated
  training step, plus structural validation and per-track idle
  accounting;
* ``bench``   — ``time_fn``, the timer of the kernel measurements, and
  ``pipelined_records``, a study's pipelined top records (the program
  ``cli timeline`` replays, the rows the card's wavefront is checked on);
* ``profile`` — the kernel profiling harness behind ``cli calibrate``.

The bench gate over the reference's ``BENCH_*`` files is not ported.
"""
from repro_torch.obs.metrics import gauge, inc, scope
from repro_torch.obs.trace import Tracer, current_tracer, span, tracing
from repro_torch.obs.export import (PID_DEVICES,  # noqa: F401
                                    chrome_trace_from_event_result,
                                    chrome_trace_from_tracer, track_idle,
                                    validate_chrome_trace,
                                    write_chrome_trace)

__all__ = ["gauge", "inc", "scope", "Tracer", "current_tracer", "span",
           "tracing", "PID_DEVICES", "chrome_trace_from_event_result",
           "chrome_trace_from_tracer", "track_idle",
           "validate_chrome_trace", "write_chrome_trace"]
