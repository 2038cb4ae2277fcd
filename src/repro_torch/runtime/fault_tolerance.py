"""Fault-tolerant training runtime (counterpart of
``repro/runtime/fault_tolerance.py``), on one device.

Mechanisms:

  * checkpoint/restart — ``CheckpointManager`` (async, atomic); restart
    resumes bit-exactly because the data pipeline is stateless
    (batch = f(seed, step)) and the restore copies the saved values into
    the live parameters, m and v.
  * preemption handling — SIGTERM/SIGINT flips a flag; the loop finishes
    the current step, writes a final synchronous checkpoint and returns
    cleanly.
  * watchdog — a step deadline, checked once each step has returned: a
    step that went over it raises ``TimeoutError`` (a runner would
    restart the job from the last checkpoint).  It cannot fire while a
    step still runs, so a step that hangs is not caught here.
  * straggler mitigation — per-step wall times (``clock``, the wall
    clock by default) feed an EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged with their step id; the
    synchronous-SGD semantics are unchanged.

Each step's time is the device's: the loop waits for the card
(``torch.cuda.synchronize``) before it reads the clock, where the step's
metrics lie on one.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import torch


class Watchdog:
    """Raises from ``check`` when more than ``deadline_s`` has passed
    since the last ``pet``; the loop checks after each step returns."""

    def __init__(self, deadline_s: float = 1800.0):
        self.deadline_s = deadline_s
        self._last = time.monotonic()

    def pet(self):
        self._last = time.monotonic()

    def check(self):
        if time.monotonic() - self._last > self.deadline_s:
            raise TimeoutError(
                f"step exceeded {self.deadline_s}s — slow step or failing "
                f"device; restart from last checkpoint")


def _wait_for_step(metrics: dict) -> None:
    """Block until the step that produced ``metrics`` has finished on its
    device (a CPU step has finished when it returns)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class FaultTolerantLoop:
    def __init__(self, train_step: Callable, ckpt_mgr, pipeline,
                 checkpoint_every: int = 50, watchdog_s: float = 1800.0,
                 straggler_factor: float = 3.0,
                 clock: Callable[[], float] = time.perf_counter):
        self.train_step = train_step
        self.ckpt = ckpt_mgr
        self.pipeline = pipeline
        self.checkpoint_every = checkpoint_every
        self.watchdog = Watchdog(watchdog_s)
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.preempted = False
        self.step_times = []
        self.straggler_steps = []
        self._ewma: Optional[float] = None
        self._orig_handlers = {}

    # ------------------------------------------------------------------
    def _install_signals(self):
        def handler(signum, frame):
            self.preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _restore_signals(self):
        for sig, h in self._orig_handlers.items():
            signal.signal(sig, h)
        self._orig_handlers = {}

    # ------------------------------------------------------------------
    def resume_or_init(self, state):
        """Restore the latest committed checkpoint into ``state`` if one
        exists -> (state, its step; 0 without a checkpoint)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        restored, extra = self.ckpt.restore(latest, state)
        if "seed" in extra and "step" in extra:  # the pipeline's state
            self.pipeline.restore(extra)
        else:
            self.pipeline.restore({"seed": self.pipeline.state.seed,
                                   "step": latest})
        return restored, latest

    def run(self, state, n_steps: int, start_step: int = 0,
            on_metrics: Optional[Callable] = None):
        """Run up to ``n_steps`` total steps; returns (state, last_step)."""
        self._install_signals()
        try:
            step = start_step
            while step < n_steps and not self.preempted:
                t0 = self.clock()
                batch = self.pipeline.batch_at(step)
                state, metrics = self.train_step(state, batch)
                _wait_for_step(metrics)
                dt = self.clock() - t0
                self.watchdog.check()
                self.watchdog.pet()
                self.step_times.append(dt)
                if self._ewma is None:
                    self._ewma = dt
                elif dt > self.straggler_factor * self._ewma:
                    self.straggler_steps.append((step, dt, self._ewma))
                else:
                    self._ewma = 0.9 * self._ewma + 0.1 * dt
                step += 1
                self.pipeline.state = self.pipeline.state.advance()
                if on_metrics is not None:
                    on_metrics(step, metrics, dt)
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state,
                                   extra=self.pipeline.checkpoint())
            if self.preempted:
                # graceful preemption: final synchronous checkpoint
                self.ckpt.async_write = False
                self.ckpt.save(step, state,
                               extra=self.pipeline.checkpoint())
            self.ckpt.wait()
            return state, step
        finally:
            self._restore_signals()
