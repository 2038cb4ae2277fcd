"""Fluid discrete-event replay of a compiled ``StepProgram``.

The engine executes the per-microbatch task DAG on the derived topology:
every pipeline stage is a device advancing IN ORDER through its static
schedule (``dag.device_op_order``), compute tiles take fixed time, and
collectives are FLUID FLOWS on shared rail resources — at any instant a
flow's rate is its fair share ``capacity / sum(active multiplicities)``
of every resource it traverses (its parallelism's rail, plus the
device's HBM relay engine — paper insight 5: every relayed chunk is a
read + write).  Whenever a flow starts or finishes, rates are rebalanced
and completions reprojected — congestion is resolved from the actual
schedule, not assumed.

Reused rails (the dynamic CP/EP pair) carry a configuration state: a
flow needing the other configuration triggers an explicit OCS
reconfiguration event, charged ``hw.ocs_switch_latency_s`` minus the
time the idle bank already had to re-train (two-bank model); under the
paper's ``ocs_reuse_mode="paper"`` the swap is counted but free.

The result is an ``EventResult``: schedule-resolved step time, per-phase
busy time, per-rail utilization, measured bubble / exposure /
peak-in-flight actuals, byte-conservation counters and the event count.
Deterministic: no randomness; heap ties break on a sequence counter.
Host code (heapq and Python floats): the ground truth the batched
wavefront (``repro_torch.events.batch``) and the analytic model are
held against, with the same float operations in the same order as the
reference package's engine, so both give the same ``EventResult``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.events.dag import (StepProgram, TaskSpec,
                                    device_op_order, op_dependency)


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------
@dataclass
class EventResult:
    """Schedule-resolved replay of one training step."""

    step_time: float
    makespan_body: float            # last node end (pre-DP)
    analytic_step_time: float
    err: float                      # (event - analytic) / analytic
    schedule: str
    n_stages: int
    v: int
    n_micro: int
    bubble: float                   # measured: makespan / mean busy - 1
    exposed_comm: float             # comm time with no concurrent compute
    dp_exposed: float               # DP tail beyond the last node end
    peak_inflight: int              # max fwd-done minus bwd-done per stage
    n_events: int
    n_reconf: int
    reconf_wait_s: float
    phase_times: Dict[str, float]   # rep-stage busy seconds per phase
    link_util: Dict[str, float]     # bytes / (capacity * step) per rail
    bytes_moved: Dict[str, float]   # per-parallelism, rep device
    timeline: List[Tuple[str, str, float, float]] = field(
        default_factory=list)       # (phase, label, start, end), rep stage
    # full ``record_timeline=True`` capture, every stage (repro_torch.obs
    # exports these as Perfetto tracks — one per device, one per rail):
    device_timeline: List[Tuple[int, str, str, str, float, float]] = \
        field(default_factory=list)  # (stage, kind, phase, label, t0, t1)
    rail_timeline: List[Tuple[str, int, str, float, float]] = field(
        default_factory=list)        # (rail, stage, label, t0, t1)
    reconf_events: List[Tuple[str, int, float, float]] = field(
        default_factory=list)        # (rail, stage, t, wait_s)


# ---------------------------------------------------------------------------
# Internal state
# ---------------------------------------------------------------------------
class _Rail:
    __slots__ = ("cap", "active", "config", "last_swap", "bytes_done")

    def __init__(self, cap: float):
        self.cap = cap
        self.active = 0.0           # sum of active flow weights
        self.config = ""
        self.last_swap = -math.inf
        self.bytes_done = 0.0


class _Flow:
    __slots__ = ("task", "dev", "node", "tidx", "remaining", "rails",
                 "weights", "rate", "epoch", "fluid", "projected")

    def __init__(self, task: TaskSpec, dev: int, node: "_Node", tidx: int,
                 rails: List[_Rail], weights: List[float]):
        self.task = task
        self.dev = dev
        self.node = node
        self.tidx = tidx
        self.remaining = float(task.nbytes)
        self.rails = rails
        self.weights = weights
        self.rate = 0.0
        self.epoch = 0
        self.fluid = task.latency <= 0.0
        self.projected = False


class _Node:
    """One (dir, stage, chunk, micro) instance with task timings."""

    __slots__ = ("key", "tasks", "starts", "ends", "scheduled", "n_done",
                 "start_t", "end_t")

    def __init__(self, key, tasks: Tuple[TaskSpec, ...]):
        self.key = key
        self.tasks = tasks
        self.starts: List[Optional[float]] = [None] * len(tasks)
        self.ends: List[Optional[float]] = [None] * len(tasks)
        self.scheduled = [False] * len(tasks)
        self.n_done = 0
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None


class _Replay:
    def __init__(self, prog: StepProgram, record_timeline: bool,
                 rep_stage: int):
        self.prog = prog
        self.pp, self.v, self.nm = prog.n_stages, prog.v, prog.n_micro
        self.rep = min(rep_stage, self.pp - 1)
        self.record_timeline = record_timeline
        # per-stage resources: stages occupy disjoint MCM groups, so
        # rails never cross stages; the HBM relay is per die
        self.rails: Dict[Tuple[str, int], _Rail] = {}
        for s in range(self.pp):
            for name, cap in prog.resources.items():
                self.rails[(name, s)] = _Rail(cap)
            self.rails[("hbm", s)] = _Rail(prog.hbm_relay_bw)
        self.orders = [device_op_order(prog.schedule, self.pp, self.v,
                                       self.nm, s) for s in range(self.pp)]
        self.nodes: Dict[tuple, _Node] = {}
        for s in range(self.pp):
            for d, c, m in self.orders[s]:
                tmpl = prog.fwd_node if d == "F" else prog.bwd_node
                self.nodes[(d, s, c, m)] = _Node((d, s, c, m), tmpl)
        self.dp_nodes: Dict[int, _Node] = {}
        if prog.dp_tasks:
            for s in range(self.pp):
                self.dp_nodes[s] = _Node(("D", s, 0, 0), prog.dp_tasks)
        self.tau_b = prog.node_span("bwd")
        self.op_idx = [0] * self.pp
        self.dev_node: List[Optional[_Node]] = [None] * self.pp
        self.dp_started = [False] * self.pp
        self.dp_planned: set = set()
        self.dev_busy = [0.0] * self.pp
        self.fwd_done = [0] * self.pp
        self.bwd_done = [0] * self.pp
        self.peak_inflight = 0
        self.compute_active = [0] * self.pp
        self.flow_active = [0] * self.pp
        self.exposed_s = [0.0] * self.pp
        self.flows: Dict[int, _Flow] = {}
        self.heap: List[tuple] = []
        self.seq = 0
        self.now = 0.0
        self.n_events = 0
        self.n_reconf = 0
        self.reconf_wait = 0.0
        self.phase_times: Dict[str, float] = {}
        self.bytes_moved: Dict[str, float] = {}
        self.timeline: List[Tuple[str, str, float, float]] = []
        self.device_timeline: List[Tuple[int, str, str, str,
                                         float, float]] = []
        self.rail_timeline: List[Tuple[str, int, str, float, float]] = []
        self.reconf_events: List[Tuple[str, int, float, float]] = []

    # -- plumbing ----------------------------------------------------------
    def push(self, t: float, kind: str, data: tuple):
        heapq.heappush(self.heap, (t, self.seq, kind, data))
        self.seq += 1

    def node_of(self, key) -> _Node:
        return self.dp_nodes[key[1]] if key[0] == "D" else self.nodes[key]

    def advance(self, t: float):
        dt = t - self.now
        if dt > 0:
            for f in self.flows.values():
                if f.rate > 0 and f.remaining > 0:
                    f.remaining = max(f.remaining - f.rate * dt, 0.0)
            for s in range(self.pp):
                if self.flow_active[s] > 0 and self.compute_active[s] == 0:
                    self.exposed_s[s] += dt
        self.now = t

    def rebalance(self):
        for fid, f in self.flows.items():
            if not f.fluid or f.remaining <= 0:
                continue
            rate = math.inf
            for r, wgt in zip(f.rails, f.weights):
                rate = min(rate, r.cap / max(r.active, wgt))
            if rate != f.rate or not f.projected:
                f.rate = rate
                f.epoch += 1
                f.projected = True
                if rate > 0:
                    self.push(self.now + f.remaining / rate, "flow_done",
                              (fid, f.epoch))

    # -- device scheduling -------------------------------------------------
    def try_start_next(self, s: int):
        """In-order: start device ``s``'s next op if the device is idle
        and the op's cross-DAG dependency has completed."""
        if self.dev_node[s] is not None:
            return
        if self.op_idx[s] >= len(self.orders[s]):
            self.maybe_start_dp(s, final=True)
            return
        d, c, m = self.orders[s][self.op_idx[s]]
        node = self.nodes[(d, s, c, m)]
        dep = op_dependency(d, s, c, m, self.pp, self.v)
        if dep is not None:
            dn = self.nodes.get(dep)
            if dn is None or dn.end_t is None:
                return               # retried when the dep completes
        self.op_idx[s] += 1
        self.dev_node[s] = node
        node.start_t = self.now
        if d == "B":
            self.plan_dp_launch(s)
        self.begin_task(node, 0)

    def plan_dp_launch(self, s: int):
        """When a bwd node starts, check whether the DP all-reduce can
        launch within it: remaining bwd work after the launch point must
        equal the overlap credit (the analytic overlap model,
        event-resolved at sub-node granularity)."""
        if self.dp_started[s] or s in self.dp_planned \
                or s not in self.dp_nodes:
            return
        rest = sum(1 for k in range(self.op_idx[s], len(self.orders[s]))
                   if self.orders[s][k][0] == "B") * self.tau_b
        credit = self.prog.dp_overlap
        if rest + self.tau_b <= credit:
            self.dp_planned.add(s)
            self.start_dp(s)
        elif rest < credit:
            self.dp_planned.add(s)
            delay = max(0.0, self.tau_b - (credit - rest))
            self.push(self.now + delay, "dp_begin", (s,))

    def start_dp(self, s: int):
        if self.dp_started[s]:
            return
        self.dp_started[s] = True
        node = self.dp_nodes[s]
        node.start_t = self.now
        self.begin_task(node, 0)

    def maybe_start_dp(self, s: int, final: bool = False):
        """Launch the DP all-reduce once the stage's remaining bwd work
        (steady-state estimate) fits inside the overlap credit — the
        analytic overlap model, event-resolved."""
        if self.dp_started[s] or s not in self.dp_nodes:
            return
        if not final:
            remaining = sum(
                1 for k in range(self.op_idx[s], len(self.orders[s]))
                if self.orders[s][k][0] == "B") * self.tau_b
            if self.dev_node[s] is not None:
                remaining += self.tau_b      # current node, conservatively
            if remaining > self.prog.dp_overlap:
                return
        self.start_dp(s)

    # -- tasks -------------------------------------------------------------
    def begin_task(self, node: _Node, i: int):
        node.scheduled[i] = True
        node.starts[i] = self.now
        task = node.tasks[i]
        s = node.key[1]
        if task.kind == "compute":
            self.compute_active[s] += 1
            self.push(self.now + task.dur, "task_done", (node.key, i))
        else:
            self.launch_flow(node, i)
        self.schedule_successors(node)

    def launch_flow(self, node: _Node, i: int):
        task = node.tasks[i]
        s = node.key[1]
        rail = self.rails[(task.rail, s)]
        if task.config and rail.config != task.config:
            if rail.config:          # initial configuration is free
                # bank-swap model: the links are banked across the
                # n_micro microbatches (the analytic gate's assumption,
                # _bank_swap_reuse_ok), so a configuration swapped in
                # now had n_micro inter-swap gaps to retrain; the swap
                # only stalls when even that pipelined window is
                # shorter than the MEMS reconfiguration time
                wait = 0.0 if self.prog.ocs_paper_mode else max(
                    0.0, self.prog.ocs_switch_latency_s
                    - (self.now - rail.last_swap) * max(self.nm, 1))
                self.n_reconf += 1
                self.reconf_wait += wait
                if self.record_timeline:
                    self.reconf_events.append(
                        (task.rail, s, self.now, wait))
                rail.config = task.config
                rail.last_swap = self.now
                if wait > 0:
                    node.starts[i] = None        # restarts after the swap
                    self.push(self.now + wait, "task_begin", (node.key, i))
                    return
            else:
                rail.config = task.config
                rail.last_swap = self.now
        f = _Flow(task, s, node, i, [rail, self.rails[("hbm", s)]],
                  [float(task.mult), 1.0])
        fid = self.seq
        self.seq += 1
        self.flows[fid] = f
        for r, wgt in zip(f.rails, f.weights):
            r.active += wgt
        self.flow_active[s] += 1
        if not f.fluid:
            self.push(self.now + task.latency, "flow_fluid", (fid,))
            self.rebalance()         # co-located flows see the new sharer
        else:
            self.rebalance()

    def schedule_successors(self, node: _Node):
        """Schedule every not-yet-scheduled task whose preds permit a
        start time (overlap windows look ahead into fixed-duration
        predecessors)."""
        for j, t in enumerate(node.tasks):
            if node.scheduled[j] or not t.preds:
                continue
            best = 0.0
            ok = True
            for k, slack in t.preds:
                if node.starts[k] is None or not node.scheduled[k]:
                    ok = False
                    break
                if node.ends[k] is not None:
                    cand = max(node.ends[k] - slack, node.starts[k])
                elif slack > 0 and node.tasks[k].kind == "compute":
                    cand = max(node.starts[k] + node.tasks[k].dur - slack,
                               node.starts[k])
                else:
                    ok = False
                    break
                best = max(best, cand)
            if not ok:
                continue
            node.scheduled[j] = True
            if best <= self.now:
                node.scheduled[j] = False     # begin_task re-marks it
                self.begin_task(node, j)
            else:
                self.push(best, "task_begin", (node.key, j))

    def finish_task(self, node: _Node, i: int):
        task = node.tasks[i]
        s = node.key[1]
        node.ends[i] = self.now
        node.n_done += 1
        if task.kind == "compute":
            self.compute_active[s] -= 1
        if self.record_timeline:
            kind = ("dp" if node.key[0] == "D"
                    else "compute" if task.kind == "compute" else "coll")
            self.device_timeline.append(
                (s, kind, task.phase, task.label, node.starts[i], self.now))
            if task.kind != "compute":
                self.rail_timeline.append(
                    (task.rail, s, task.label, node.starts[i], self.now))
        if s == self.rep and node.key[0] != "D":
            self.phase_times[task.phase] = \
                self.phase_times.get(task.phase, 0.0) \
                + (self.now - node.starts[i])
            if self.record_timeline:
                self.timeline.append((task.phase, task.label,
                                      node.starts[i], self.now))
        self.schedule_successors(node)
        if node.n_done < len(node.tasks):
            return
        node.end_t = self.now
        if node.key[0] == "D":
            return
        self.dev_busy[s] += node.end_t - node.start_t
        if node.key[0] == "F":
            self.fwd_done[s] += 1
        else:
            self.bwd_done[s] += 1
        self.peak_inflight = max(self.peak_inflight,
                                 self.fwd_done[s] - self.bwd_done[s])
        self.dev_node[s] = None
        self.maybe_start_dp(s)
        for s2 in range(self.pp):     # this node may unblock peers
            self.try_start_next(s2)

    # -- main loop ---------------------------------------------------------
    def run(self):
        for s in range(self.pp):
            self.try_start_next(s)
        n_tasks = len(self.nodes) * max(len(self.prog.fwd_node), 1)
        max_events = 400 * (n_tasks + 64)
        while self.heap:
            self.n_events += 1
            if self.n_events > max_events:
                raise RuntimeError(
                    "event-engine runaway: schedule deadlock suspected")
            t, _, kind, data = heapq.heappop(self.heap)
            self.advance(t)
            if kind == "task_begin":
                key, i = data
                node = self.node_of(key)
                if node.starts[i] is None:
                    self.begin_task(node, i)
            elif kind == "task_done":
                key, i = data
                self.finish_task(self.node_of(key), i)
                self.rebalance()
            elif kind == "dp_begin":
                (s,) = data
                self.start_dp(s)
            elif kind == "flow_fluid":
                (fid,) = data
                f = self.flows.get(fid)
                if f is not None:
                    f.fluid = True
                    self.rebalance()
            elif kind == "flow_done":
                fid, epoch = data
                f = self.flows.get(fid)
                if f is None or f.epoch != epoch:
                    continue          # stale projection
                if f.remaining > 1e-9 * max(f.task.nbytes, 1.0):
                    f.projected = False
                    self.rebalance()
                    continue
                for r, wgt in zip(f.rails, f.weights):
                    r.active -= wgt
                    r.bytes_done += f.task.nbytes * wgt
                del self.flows[fid]
                self.flow_active[f.dev] -= 1
                if f.dev == self.rep:
                    p = f.task.parallelism
                    self.bytes_moved[p] = \
                        self.bytes_moved.get(p, 0.0) + f.task.nbytes
                self.finish_task(f.node, f.tidx)
                self.rebalance()
        unfinished = [n.key for n in self.nodes.values() if n.end_t is None]
        if unfinished:
            raise RuntimeError(
                f"replay incomplete: {len(unfinished)} nodes never "
                f"finished (first: {unfinished[0]}) — schedule deadlock")

    def result(self) -> EventResult:
        prog = self.prog
        body_end = max((n.end_t for n in self.nodes.values()), default=0.0)
        step = body_end
        dp_exposed = 0.0
        for node in self.dp_nodes.values():
            if node.end_t is not None:
                step = max(step, node.end_t)
                dp_exposed = max(dp_exposed, node.end_t - body_end)
        busy_mean = sum(self.dev_busy) / max(self.pp, 1)
        bubble = body_end / busy_mean - 1.0 if busy_mean > 0 else 0.0
        link_util: Dict[str, float] = {}
        for (name, _s), r in self.rails.items():
            if r.bytes_done > 0 and step > 0:
                u = r.bytes_done / (r.cap * step)
                link_util[name] = max(link_util.get(name, 0.0), u)
        analytic = prog.analytic.step_time if prog.analytic \
            else float("nan")
        return EventResult(
            step_time=step, makespan_body=body_end,
            analytic_step_time=analytic,
            err=(step - analytic) / analytic if analytic else float("nan"),
            schedule=prog.schedule, n_stages=self.pp, v=self.v,
            n_micro=self.nm, bubble=bubble,
            exposed_comm=max(self.exposed_s, default=0.0),
            dp_exposed=max(dp_exposed, 0.0),
            peak_inflight=self.peak_inflight, n_events=self.n_events,
            n_reconf=self.n_reconf, reconf_wait_s=self.reconf_wait,
            phase_times=self.phase_times, link_util=link_util,
            bytes_moved=self.bytes_moved, timeline=self.timeline,
            device_timeline=self.device_timeline,
            rail_timeline=self.rail_timeline,
            reconf_events=self.reconf_events)


def replay(prog: StepProgram, record_timeline: bool = False,
           rep_stage: int = 0) -> EventResult:
    """Replay one training step of ``prog``; see the module docstring."""
    r = _Replay(prog, record_timeline, rep_stage)
    r.run()
    return r.result()
