"""Task-DAG compilation for the event-driven timeline validator.

``compile_step`` turns one design point — (Workload, Strategy, MCMArch,
fabric, optional derived OITopology) — into a ``StepProgram``: the
per-microbatch task DAG one training step executes under a selectable
pipeline schedule (``gpipe`` / ``1f1b`` / ``interleaved``).  Nodes are
(pipeline stage, virtual chunk, microbatch, direction) units whose task
chains interleave compute tiles with collective invocations tagged by
``traffic.PHASE``; collectives carry BYTES and a rail resource, not a
precomputed duration — their time emerges from the replay engine's
per-rail fair-share (``repro_torch.events.engine``).

Cost primitives are shared with the analytic model: traffic volumes come
from ``traffic.traffic_volumes``, the intra/inter split from
``simulator.map_intra``, OI link allocation and the dynamic-reuse
bank-swap gate replicate ``simulator.simulate`` exactly (same functions,
same order), and per-rail capacities mirror the bandwidth expressions of
``batched_sim._terms_core``.  The event engine therefore diffs against
the analytic model on SCHEDULE STRUCTURE (pipeline bubbles, overlap,
congestion, OCS reconfiguration) — not on unit costs.  See DESIGN.md
§events.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware import HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology, allocate_links
from repro_torch.core.simulator import (SimResult, _bank_swap_reuse_ok, _gemm_eff,
                                  map_intra, simulate)
from repro_torch.core.traffic import (PARALLELISMS, PHASE, Strategy,
                                reusable_pairs, traffic_volumes)
from repro_torch.core.workload import Workload

SCHEDULES = ("gpipe", "1f1b", "interleaved")


# ---------------------------------------------------------------------------
# Task / program data model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TaskSpec:
    """One task of a node template.

    ``kind`` is ``compute`` (fixed ``dur``) or ``coll`` (a flow of
    ``nbytes`` on ``rail``, behind a fixed serial ``latency``).  ``mult``
    is the number of identical sibling flows the replayed representative
    stands for on its rail (the dies of an MCM share the rail, so a
    collective of a fully-lockstep group contends with ``mult`` copies
    of itself).  ``preds`` are node-internal dependencies as
    ``(task_index, slack_s)`` — a positive slack lets this task start
    that many seconds BEFORE the predecessor finishes (the CP /
    ring-attention overlap window).  ``config`` names the rail
    configuration a reuse-shared rail must be switched to before the
    flow can start (OCS reconfiguration events).
    """

    kind: str                      # "compute" | "coll"
    label: str
    phase: str                     # traffic.PHASE tag or "compute"
    parallelism: str = ""
    dur: float = 0.0               # compute only
    nbytes: float = 0.0            # coll only (per device copy)
    rail: str = ""                 # resource template name (coll only)
    mult: int = 1                  # sibling flows sharing the rail
    latency: float = 0.0           # fixed serial launch/propagation time
    config: str = ""               # required rail configuration
    preds: Tuple[Tuple[int, float], ...] = ()


@dataclass(frozen=True)
class StepProgram:
    """Compiled one-step task DAG plus the resources it runs on."""

    workload: Workload
    strategy: Strategy
    mcm: MCMArch
    fabric: str
    schedule: str
    n_stages: int                  # pp
    v: int                         # virtual chunks per stage (interleaved)
    n_micro: int
    fwd_node: Tuple[TaskSpec, ...]
    bwd_node: Tuple[TaskSpec, ...]
    dp_tasks: Tuple[TaskSpec, ...]     # chained segments (intra -> inter)
    dp_overlap: float                  # seconds creditable against bwd
    resources: Dict[str, float]        # rail template name -> capacity B/s
    hbm_relay_bw: float                # per-die relay cap (hbm_bw / 2)
    reuse_rail: str = ""               # shared rail template ("" = none)
    reuse_pair: Optional[Tuple[str, str]] = None
    ocs_paper_mode: bool = False
    ocs_switch_latency_s: float = 0.0
    analytic: Optional[SimResult] = None
    bytes_expected: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, float] = field(default_factory=dict)

    # -- steady-state node spans (the batch-replay unit costs) ----------
    def steady_rate(self, t: TaskSpec) -> float:
        """Per-copy flow rate when every sibling is active (the analytic
        model's bandwidth assumption)."""
        return min(self.resources[t.rail] / t.mult, self.hbm_relay_bw)

    def task_cost(self, t: TaskSpec) -> float:
        if t.kind == "compute":
            return t.dur
        return t.latency + t.nbytes / self.steady_rate(t)

    def node_span(self, direction: str) -> float:
        """Steady-state span of one (stage, chunk, micro) node."""
        tasks = self.fwd_node if direction == "fwd" else self.bwd_node
        starts: List[float] = []
        ends: List[float] = []
        for t in tasks:
            start = 0.0
            for j, slack in t.preds:
                # slack may pull the start earlier, but never before the
                # predecessor itself started
                start = max(start, max(ends[j] - slack, starts[j]))
            starts.append(start)
            ends.append(start + self.task_cost(t))
        return max(ends) if ends else 0.0

    def dp_cost(self) -> float:
        return sum(self.task_cost(t) for t in self.dp_tasks)

    def spans(self) -> Tuple[float, float, float, float]:
        """(fwd span, bwd span, dp cost, dp overlap credit), memoized
        per instance: batch replay reads these once per record and the
        Python task walk would otherwise dominate its setup."""
        cached = self.__dict__.get("_span_cache")
        if cached is None:
            cached = (self.node_span("fwd"), self.node_span("bwd"),
                      self.dp_cost(), self.dp_overlap)
            object.__setattr__(self, "_span_cache", cached)
        return cached


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _Segment:
    rail: str
    mult: int
    alpha: float               # per-hop launch latency on this segment


def _chain(tasks: List[TaskSpec]) -> Tuple[TaskSpec, ...]:
    """Default-serialize a task list: each task after the previous one,
    preserving explicitly-set preds (the CP overlap pair)."""
    import dataclasses
    out: List[TaskSpec] = []
    for i, t in enumerate(tasks):
        if not t.preds and i > 0:
            t = dataclasses.replace(t, preds=((i - 1, 0.0),))
        out.append(t)
    return tuple(out)


def compile_step(w: Workload, s: Strategy, mcm: MCMArch,
                 fabric: str = "oi", topo: Optional[OITopology] = None,
                 reuse: bool = True, hw: Optional[HW] = None,
                 schedule: str = "1f1b",
                 virtual_chunks: Optional[int] = None) -> StepProgram:
    """Compile one design point into its per-microbatch task DAG."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"known: {list(SCHEDULES)}")
    hw = hw or mcm.hw
    analytic = simulate(w, s, mcm, fabric=fabric, topo=topo, reuse=reuse,
                        hw=hw)
    if not analytic.feasible:
        raise ValueError(f"infeasible design point: {analytic.reason}")
    intra, inter = map_intra(w, s, mcm)
    n_micro = max(s.n_micro, 1)
    layers_stage = max(w.n_layers // s.pp, 1)
    attn_stage = max(w.n_attn_layers // s.pp, 1) if w.n_attn_layers else 0
    moe_stage = max(w.n_moe_layers // s.pp, 1) if w.n_moe_layers else 0

    v = virtual_chunks if virtual_chunks is not None else \
        (2 if schedule == "interleaved" else 1)
    v = max(1, min(v, layers_stage, n_micro))
    if schedule != "interleaved":
        v = 1

    # ---------------- unit costs (identical to simulate()) -------------
    flops_dev = w.step_flops() / mcm.n_devices
    eff = _gemm_eff(w, s, hw) if hw.model_gemm_eff else 1.0
    t_comp = flops_dev / (mcm.die_flops * hw.mfu_ceiling * eff)
    local_params = (w.nonexpert_params / (s.tp * s.pp)
                    + w.expert_params / (s.tp * s.pp * s.ep))
    hbm_stream = (local_params * w.bytes_param * 2.0 * n_micro
                  + local_params * 16.0
                  + 12.0 * w.tokens_per_step / (s.dp * s.cp * s.tp)
                  * w.d_model * w.bytes_act * layers_stage)
    t_mem = hbm_stream / mcm.hbm_bw
    tile = max(t_comp, t_mem)

    vols = traffic_volumes(w, s)
    inter_vols = {p: vols[p] for p in PARALLELISMS
                  if inter.get(p, 1) > 1 and vols[p] > 0}
    hbm_relay = mcm.hbm_bw / 2.0

    # ---------------- reuse decision + link allocation ------------------
    # replicates simulate()'s dynamic-reuse block operation-for-operation
    reuse_pair: Optional[Tuple[str, str]] = None
    alloc: Dict[str, int] = {}
    if fabric == "oi":
        if topo is not None:
            alloc = dict(topo.link_alloc)
            reuse_pair = topo.reuse_pair
        else:
            if reuse:
                pairs = [pr for pr in reusable_pairs(w, s)
                         if pr[0] in inter_vols and pr[1] in inter_vols]
                reuse_pair = pairs[0] if pairs else None
            alloc = allocate_links(inter_vols, mcm.total_links, reuse_pair)
        if reuse_pair is not None:
            gap = t_comp / max(layers_stage * n_micro, 1) / 2.0
            if hw.ocs_reuse_mode == "paper":
                pass
            elif not _bank_swap_reuse_ok(gap, n_micro, hw):
                reuse_pair = None
                alloc = allocate_links(inter_vols, mcm.total_links, None)

    # ---------------- per-parallelism comm segments ---------------------
    resources: Dict[str, float] = {}
    segments: Dict[str, List[_Segment]] = {p: [] for p in PARALLELISMS}
    reuse_rail = ""
    for p in PARALLELISMS:
        deg = s.degree(p)
        if deg <= 1 or vols[p] == 0.0:
            continue
        if intra.get(p, 1) > 1:
            if fabric == "nvlink":
                cap = hw.nvlink_bw * hw.fabric_eff_elec
            else:
                cap = mcm.intra_ring_bw(intra[p])
            name = f"intra:{p}"
            resources[name] = cap
            segments[p].append(_Segment(name, 1, hw.lat_intra_s))
        if inter.get(p, 1) > 1:
            if fabric in ("ib", "nvlink"):
                name = "pipe"
                resources[name] = hw.ib_bw * hw.fabric_eff_elec
                segments[p].append(_Segment(name, 1, hw.lat_ib_s))
            else:
                # only the (CP, EP) pair time-divides ONE rail with
                # mid-layer bank swaps (the paper's primary pair —
                # per-layer attention/FFN alternation).  Step-edge
                # pairs (X, DP) are modelled as disjoint rails of the
                # shared allocation: a single long all-reduce cannot
                # bank-swap against per-layer traffic, and the HBM
                # relay still congests them when they overlap.
                if reuse_pair == ("CP", "EP") and p in reuse_pair:
                    name = "oi:CP+EP"
                    reuse_rail = name
                else:
                    name = f"oi:{p}"
                links = max(alloc.get(p, 1), 1)
                resources[name] = links * hw.oi_link_bw * hw.fabric_eff_oi
                segments[p].append(_Segment(name, mcm.dies_per_mcm,
                                            hw.lat_oi_s))

    # invocation counts / hops — simulate()'s latency model
    inv = {"TP": 8 * layers_stage * n_micro,
           "CP": 2 * attn_stage * n_micro,
           "EP": 4 * moe_stage * n_micro,
           "DP": 1,
           "PP": 2 * n_micro}
    hops = {"TP": s.tp - 1, "CP": s.cp - 1,
            "EP": max(int(math.ceil(math.log2(max(s.ep, 2)))), 1),
            "DP": 2 * (s.dp - 1), "PP": 1}

    def coll(p: str, share: float, overlap_pred=None) -> List[TaskSpec]:
        """Coll tasks for parallelism ``p`` carrying ``share`` of its
        per-step bytes+latency (one task per segment, chained)."""
        out = []
        for seg in segments[p]:
            cfg = p if (reuse_pair is not None and p in reuse_pair
                        and seg.rail == reuse_rail) else ""
            out.append(TaskSpec(
                kind="coll", label=f"{p.lower()}", phase=PHASE[p],
                parallelism=p, nbytes=vols[p] * share, rail=seg.rail,
                mult=seg.mult, latency=inv[p] * hops[p] * seg.alpha * share,
                config=cfg,
                preds=(overlap_pred,) if overlap_pred and not out else ()))
        return out

    # ---------------- node templates ------------------------------------
    has_cp = bool(segments["CP"])
    nmv = n_micro * v

    def build_node(direction: str) -> Tuple[TaskSpec, ...]:
        import dataclasses
        dirfrac = (1.0 / 3.0) if direction == "fwd" else (2.0 / 3.0)
        node_tile = tile * dirfrac / nmv
        share = 0.5 / nmv            # fwd/bwd halves of per-layer comm
        credit = 0.3 * t_comp * hw.cp_overlap_frac * dirfrac / nmv
        tasks: List[TaskSpec] = []
        barrier = None               # (attn_i, cp_last_i) sync point

        def add_attn_cp():
            nonlocal barrier
            tasks.append(TaskSpec(kind="compute", label="attn",
                                  phase="attention", dur=0.3 * node_tile))
            ai = len(tasks) - 1
            tasks.extend(coll("CP", share, overlap_pred=(ai, credit)))
            barrier = (ai, len(tasks) - 1)

        def add_after_barrier(t: TaskSpec):
            nonlocal barrier
            if barrier is not None:
                t = dataclasses.replace(
                    t, preds=((barrier[0], 0.0), (barrier[1], 0.0)))
                barrier = None
            tasks.append(t)

        other_t = TaskSpec(kind="compute", label="ffn", phase="ffn",
                           dur=(0.7 if has_cp else 1.0) * node_tile)
        tasks.extend(coll("TP", share))
        if direction == "fwd":
            if has_cp:
                add_attn_cp()
            add_after_barrier(other_t)
            tasks.extend(coll("EP", share))
        else:
            tasks.append(other_t)
            tasks.extend(coll("EP", share))
            if has_cp:
                add_attn_cp()
        if s.pp > 1 and vols["PP"] > 0:
            # one stage-boundary send per node; charged uniformly across
            # stages as the analytic model does (interleaving pays v of
            # them per microbatch — a real cost the analytic model
            # cannot see)
            for t in coll("PP", 0.5 / n_micro):
                add_after_barrier(t)
        return _chain(tasks)

    fwd_node = build_node("fwd")
    bwd_node = build_node("bwd")
    dp_tasks = _chain(coll("DP", 1.0))
    dp_overlap = (2.0 / 3.0) * t_comp * hw.dp_overlap_frac \
        if dp_tasks else 0.0

    bytes_expected = {}
    for p in PARALLELISMS:
        nseg = len(segments[p])
        if not nseg or vols[p] == 0.0:
            continue
        mult_v = v if p == "PP" else 1
        bytes_expected[p] = vols[p] * nseg * mult_v

    prog = StepProgram(
        workload=w, strategy=s, mcm=mcm, fabric=fabric, schedule=schedule,
        n_stages=s.pp, v=v, n_micro=n_micro,
        fwd_node=fwd_node, bwd_node=bwd_node, dp_tasks=dp_tasks,
        dp_overlap=dp_overlap, resources=resources,
        hbm_relay_bw=hbm_relay, reuse_rail=reuse_rail,
        reuse_pair=reuse_pair,
        ocs_paper_mode=hw.ocs_reuse_mode == "paper",
        ocs_switch_latency_s=hw.ocs_switch_latency_s,
        analytic=analytic, bytes_expected=bytes_expected,
        meta={"t_comp": t_comp, "t_mem": t_mem, "tile": tile,
              "reuse_active": float(reuse_pair is not None)})
    return prog


# ---------------------------------------------------------------------------
# Pipeline schedules: static per-device op orders
# ---------------------------------------------------------------------------
def _fwd_order(pp: int, v: int, nm: int) -> List[Tuple[int, int]]:
    """Interleaved (chunk, micro) forward order: microbatch groups of
    ``pp`` cycle through the virtual chunks (Megatron's interleaved
    ordering); degenerates to plain micro order at v == 1."""
    out = []
    i = 0
    while len(out) < nm * v:
        c = (i // pp) % v
        m = (i // (pp * v)) * pp + i % pp
        i += 1
        if m < nm:
            out.append((c, m))
    return out


def device_op_order(schedule: str, pp: int, v: int, nm: int, stage: int
                    ) -> List[Tuple[str, int, int]]:
    """Static (dir, chunk, micro) execution order for one device-stage."""
    if schedule == "gpipe":
        fwd = [("F", c, m) for c in range(v) for m in range(nm)]
        bwd = [("B", c, m) for c in reversed(range(v))
               for m in reversed(range(nm))]
        return fwd + bwd
    # 1F1B family: warmup forwards, steady (F, B) pairs, cooldown bwds
    fwd = [("F", c, m) for c, m in _fwd_order(pp, v, nm)]
    if schedule == "interleaved":
        bwd = [("B", v - 1 - c, m) for c, m in _fwd_order(pp, v, nm)]
        warm = min(len(fwd), (pp - stage - 1) * 2 + (v - 1) * pp)
    elif schedule == "1f1b":
        bwd = [("B", 0, m) for m in range(nm)]
        warm = min(len(fwd), pp - stage - 1)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    order = fwd[:warm]
    rest = fwd[warm:]
    for i, b in enumerate(bwd):
        if i < len(rest):
            order.append(rest[i])
        order.append(b)
    return order


def op_dependency(direction: str, stage: int, chunk: int, micro: int,
                  pp: int, v: int) -> Optional[Tuple[str, int, int, int]]:
    """Cross-node dependency of one op: (dir, stage, chunk, micro) of the
    node whose END this op's START waits for (None = no dependency)."""
    vs = chunk * pp + stage
    if direction == "F":
        if vs == 0:
            return None
        if stage > 0:
            return ("F", stage - 1, chunk, micro)
        return ("F", pp - 1, chunk - 1, micro)
    if vs == pp * v - 1:
        return ("F", stage, chunk, micro)       # own forward
    if stage < pp - 1:
        return ("B", stage + 1, chunk, micro)
    return ("B", 0, chunk + 1, micro)
