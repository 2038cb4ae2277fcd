"""ChipLight cross-layer optimisation (paper §IV-B, Fig 6).

Nested flow:
  * inner search — PARALLEL-CENTRIC para-topo co-exploration: scan the
    ENTIRE strategy grid with the vectorized batched simulator
    (repro_torch.dse, its cost terms on the chosen device), then give
    the top-throughput candidates the full scalar treatment — project
    traffic (network-independent), map TP (+ maybe one more group)
    intra-MCM, allocate links traffic-proportionally (Eq. l_p), apply
    dynamic link reuse (Eq. 1), derive the fewest-OCS physical topology,
    evaluate with the simulator;
  * outer search — heuristic planner (§IV-B-3) reads simulator logs
    (compute util, memory pressure, comm bottleneck) and moves the MCM
    architecture (N, x, y, m, r) to break the bottleneck or trim waste
    (``propose_moves`` / ``propose_mcm``; the population search lives in
    ``repro_torch.dse.outer``).

Outputs a performance-cost Pareto frontier over (MCM arch, topology,
strategy) plus the best point; ``railx_search`` is the RailX baseline.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost import cluster_cost
from repro_torch.core.hardware import HW, DEFAULT_HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology, RailDim, allocate_links, \
    derive_physical_cached
from repro_torch.core.simulator import SimResult, map_intra, simulate
from repro_torch.core.traffic import Strategy, traffic_volumes, reusable_pairs
from repro_torch.core.workload import Workload


# ---------------------------------------------------------------------------
# Strategy enumeration
# ---------------------------------------------------------------------------
def _divisors(n: int) -> List[int]:
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    return sorted(set(out + [n // d for d in out]))


def enumerate_strategies(w: Workload, mcm: MCMArch,
                         max_pp: int = 32,
                         min_layers_per_stage: int = 4) -> List[Strategy]:
    n = mcm.n_devices
    dies = mcm.dies_per_mcm
    moe = w.model.moe
    out = []
    tps = [t for t in _divisors(dies) if w.d_model % t == 0]
    for tp in tps:
        rest1 = n // tp
        # pipeline-stage granularity: embedding/head stages + interleaving
        # overhead make <4 layers per stage impractical
        pps = [p for p in _divisors(rest1)
               if p <= min(max_pp, w.n_layers // min_layers_per_stage)
               or p == 1]
        for pp in pps:
            rest2 = rest1 // pp
            if moe is not None:
                eps = [e for e in _divisors(rest2)
                       if moe.n_experts % e == 0]
            else:
                eps = [1]
            for ep in eps:
                rest3 = rest2 // ep
                cps = [c for c in _divisors(rest3)
                       if c <= 64 and w.seq_len % c == 0 and
                       (c == 1 or w.n_attn_layers > 0)]
                for cp in cps:
                    dp = rest3 // cp
                    if dp > 1 and w.global_batch % dp != 0:
                        continue
                    if pp > 1:
                        n_micro = min(4 * pp,
                                      max(w.global_batch // max(dp, 1), 1))
                        if n_micro < pp:
                            continue
                    else:
                        n_micro = 1
                    s = Strategy(tp=tp, dp=dp, pp=pp, cp=cp, ep=ep,
                                 n_micro=n_micro)
                    if map_intra(w, s, mcm) is not None:
                        out.append(s)
    return out


# ---------------------------------------------------------------------------
# Para-topo evaluation (one design point of the inner search)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DesignPoint:
    strategy: Strategy
    mcm: MCMArch
    topo: Optional[OITopology]
    sim: SimResult
    cost: float
    fabric: str = "oi"

    @property
    def throughput(self) -> float:
        return self.sim.throughput


def evaluate_point(w: Workload, s: Strategy, mcm: MCMArch,
                   fabric: str = "oi", reuse: bool = True,
                   hw: Optional[HW] = None) -> Optional[DesignPoint]:
    hw = hw or mcm.hw
    mapping = map_intra(w, s, mcm)
    if mapping is None:
        return None
    intra, inter = mapping
    topo = None
    if fabric == "oi":
        vols = traffic_volumes(w, s)
        inter_vols = {p: vols[p] for p, d in inter.items()
                      if d > 1 and vols[p] > 0}
        reuse_pair = None
        if reuse:
            pairs = [pr for pr in reusable_pairs(w, s)
                     if pr[0] in inter_vols and pr[1] in inter_vols]
            reuse_pair = pairs[0] if pairs else None
        alloc = allocate_links(inter_vols, mcm.total_links, reuse_pair)
        inter_deg = {p: d for p, d in inter.items() if d > 1}
        topo = derive_physical_cached(inter_deg, alloc, mcm, mcm.n_mcm, hw,
                                      reuse_pair=reuse_pair)
        if topo is None and reuse_pair is not None:
            alloc = allocate_links(inter_vols, mcm.total_links, None)
            topo = derive_physical_cached(inter_deg, alloc, mcm, mcm.n_mcm,
                                          hw, reuse_pair=None)
        if topo is None and inter_deg:
            return None
    sim = simulate(w, s, mcm, fabric=fabric, topo=topo, reuse=reuse, hw=hw)
    if not sim.feasible:
        return None
    cost = cluster_cost(mcm, topo, fabric=fabric, hw=hw).total
    return DesignPoint(strategy=s, mcm=mcm, topo=topo, sim=sim, cost=cost,
                       fabric=fabric)


# ---------------------------------------------------------------------------
# Inner search
# ---------------------------------------------------------------------------
def inner_search(w: Workload, mcm: MCMArch, fabric: str = "oi",
                 reuse: bool = True, budget: int = 64,
                 hw: Optional[HW] = None, seed: int = 0,
                 method: str = "batched", device="cuda"
                 ) -> Tuple[Optional[DesignPoint], List[DesignPoint]]:
    """Parallel-centric para-topo search; returns (best, evaluated).

    The batched engine (repro_torch.dse) scans the ENTIRE strategy grid
    in one vectorized call, its cost terms on ``device`` — no surrogate
    sampling needed at the strategy level — then the top candidates by
    batched throughput get the full scalar treatment (physical-topology
    derivation, exact OCS cost).  The scan is topology-blind, so a
    candidate can still fail physical-rail derivation; the ranking is
    walked (bounded at ``4 * budget``) until ``budget`` points survive,
    rather than returning nothing.

    ``method="batched"`` (default) gives the survivors the scalar
    treatment vectorized (``repro_torch.dse.search.refine_cell_rows``:
    one batched call + memoized rail derivation for the whole walk
    window); ``method="scalar"`` is the original per-point
    ``evaluate_point`` loop, kept as the parity reference.  ``seed`` is
    kept for API compatibility; both paths are deterministic.
    """
    del seed
    hw = hw or mcm.hw
    # lazy import: repro_torch.dse depends on repro_torch.core, not vice
    # versa
    from repro_torch.dse.batched_sim import batched_simulate
    from repro_torch.dse.space import enumerate_strategy_batch

    batch = enumerate_strategy_batch(w, mcm)
    if not len(batch):
        return None, []
    res = batched_simulate(w, batch, mcm, fabric=fabric, reuse=reuse, hw=hw,
                           device=device)
    feas = np.nonzero(res.feasible)[0]
    ranked = feas[np.argsort(-res.throughput[feas], kind="stable")]
    cand = ranked[: budget * 4]

    if method == "batched":
        from repro_torch.dse.search import refine_cell_rows
        # two passes: most candidates survive rail derivation, so refine
        # one budget's worth first and top up only on a shortfall
        evaluated = refine_cell_rows(w, mcm, batch, cand[:budget],
                                     fabric=fabric, reuse=reuse, hw=hw,
                                     device=device)
        if len(evaluated) < budget and len(cand) > budget:
            evaluated += refine_cell_rows(w, mcm, batch, cand[budget:],
                                          fabric=fabric, reuse=reuse,
                                          hw=hw, device=device)
            evaluated = evaluated[:budget]
    elif method == "scalar":
        evaluated = []
        for i in cand:
            s = Strategy(tp=int(batch.tp[i]), dp=int(batch.dp[i]),
                         pp=int(batch.pp[i]), cp=int(batch.cp[i]),
                         ep=int(batch.ep[i]), n_micro=int(batch.n_micro[i]))
            pt = evaluate_point(w, s, mcm, fabric, reuse, hw)
            if pt is not None:
                evaluated.append(pt)
                if len(evaluated) >= budget:
                    break
    else:
        raise ValueError(f"unknown inner_search method {method!r}; "
                         f"use 'batched' or 'scalar'")
    best = max(evaluated, key=lambda p: p.throughput, default=None)
    return best, evaluated


# ---------------------------------------------------------------------------
# Outer search: heuristic planner over MCM architecture
# ---------------------------------------------------------------------------
def propose_moves(cur: MCMArch, logs: Optional[Dict[str, float]],
                  rng: np.random.Generator) -> List[MCMArch]:
    """Bottleneck-driven candidate moves (paper §IV-B-3), as a PURE move
    generator: reads the best point's simulator ``logs`` (None = the
    inner search found nothing feasible) and returns every architecture
    the heuristics propose.  Keeps C ~ constant by moving dies between
    packages when scale changes.  ``rng`` is consumed only by the
    last-resort random jitter move, in the same order the single-walker
    planner always used."""
    if logs is None:
        # infeasible inner search — most often memory capacity: raise m
        return [dataclasses.replace(cur, m=min(cur.m + 2, 16))]
    moves = []
    if logs.get("mem_pressure", 0) > 0.85 or logs.get("hbm_bw_bound"):
        moves.append(dataclasses.replace(cur, m=min(cur.m + 2, 16)))
    if logs.get("nop_bound"):
        if cur.m > 2:
            moves.append(dataclasses.replace(cur, m=cur.m - 1))
        if cur.dies_per_mcm > 4:
            moves.append(_rescale_dies(cur, cur.dies_per_mcm // 2))
    if logs.get("oi_bound"):
        if cur.cpo_ratio < 0.95:
            moves.append(dataclasses.replace(
                cur, cpo_ratio=min(cur.cpo_ratio + 0.1, 1.0)))
        moves.append(_rescale_dies(cur, cur.dies_per_mcm * 2))
    if not moves and logs.get("compute_util", 0) > 0.75:
        # healthy: trim over-provisioned resources to cut cost
        if cur.cpo_ratio > 0.3:
            moves.append(dataclasses.replace(
                cur, cpo_ratio=cur.cpo_ratio - 0.1))
        if cur.m > 4:
            moves.append(dataclasses.replace(cur, m=cur.m - 1))
    if not moves:
        moves.append(dataclasses.replace(
            cur, m=int(np.clip(cur.m + rng.integers(-2, 3), 1, 16))))
    return moves


def propose_mcm(cur: MCMArch, best: Optional[DesignPoint],
                rng: np.random.Generator) -> MCMArch:
    """Single-walker planner step: generate the bottleneck-driven moves
    and pick one uniformly (the pre-population behaviour, bit-for-bit:
    same rng consumption order)."""
    moves = propose_moves(cur, best.sim.logs if best is not None else None,
                          rng)
    if best is None:
        return moves[0]
    pick = moves[int(rng.integers(len(moves)))]
    return pick if pick.feasible() else cur


def _rescale_dies(cur: MCMArch, new_dies: int) -> MCMArch:
    """Move dies between packages at constant cluster compute.  A target
    die count that cannot tile ``n_devices`` exactly would silently
    shrink (or grow) the cluster — reject the move instead (the caller
    treats the unchanged architecture as a no-op candidate)."""
    total = cur.n_devices
    new_dies = max(1, new_dies)
    n_mcm = max(int(round(total / new_dies)), 1)
    if n_mcm * new_dies != total:
        return cur
    x = int(math.sqrt(new_dies))
    while new_dies % x:
        x -= 1
    return dataclasses.replace(cur, x=x, y=new_dies // x, n_mcm=n_mcm)


# ---------------------------------------------------------------------------
# Pareto utilities + full nested optimisation
# ---------------------------------------------------------------------------
def pareto_front(points: List[DesignPoint]) -> List[DesignPoint]:
    """Max throughput, min cost — cost-ascending, one representative per
    exact (cost, throughput) pair.  The dominance test is the ONE Pareto
    engine, ``repro_torch.dse.pareto.pareto_mask`` (same semantics the
    batched sweeps use)."""
    if not points:
        return []
    from repro_torch.dse.pareto import pareto_mask   # lazy: no cycle
    obj = np.array([[p.throughput, p.cost] for p in points], np.float64)
    idx = np.nonzero(pareto_mask(obj, [True, False]))[0]
    idx = sorted(idx, key=lambda i: (points[i].cost, -points[i].throughput))
    front, seen = [], set()
    for i in idx:
        key = (points[i].cost, points[i].throughput)
        if key not in seen:
            seen.add(key)
            front.append(points[i])
    return front


@dataclass
class DSEResult:
    best: Optional[DesignPoint]
    frontier: List[DesignPoint]
    history: List[DesignPoint] = field(default_factory=list)
    outer_trace: List[Dict] = field(default_factory=list)
    # engine bookkeeping (points simulated, cache hits, ...) — filled by
    # repro_torch.dse.outer; empty for directly-assembled results
    stats: Dict = field(default_factory=dict)


def chiplight_optimize(w: Workload, total_tflops: float,
                       dies_per_mcm: int = 16, m0: int = 6,
                       outer_iters: int = 8, inner_budget: int = 48,
                       fabric: str = "oi", reuse: bool = True,
                       hw: HW = DEFAULT_HW, seed: int = 0,
                       cpo0: float = 0.6,
                       inner_method: str = "batched",
                       device="cuda") -> DSEResult:
    """Nested outer/inner optimisation (paper §IV-B) — compatibility
    wrapper for the single-walker scalar flow, now hosted by
    ``repro_torch.dse.outer.outer_search(walkers=1, method="scalar")``.

    One ``np.random.default_rng(seed)`` drives every ``propose_mcm``
    move (the inner scan is deterministic), so the whole run is
    reproducible from ``(w, total_tflops, ..., seed)`` alone.  The MCM
    proposed by the LAST planner move is evaluated too — ``outer_trace``
    has ``outer_iters + 1`` entries, one per inner search.  The inner
    scans' cost terms run on ``device``.
    """
    from repro_torch.dse.outer import outer_search   # lazy: no cycle
    return outer_search(w, total_tflops, dies_per_mcm=dies_per_mcm,
                        m0=m0, rounds=outer_iters,
                        inner_budget=inner_budget, walkers=1,
                        fabric=fabric, reuse=reuse, hw=hw, seed=seed,
                        cpo0=cpo0, method="scalar",
                        inner_method=inner_method, device=device)


# ---------------------------------------------------------------------------
# RailX baseline (prior network design [20])
# ---------------------------------------------------------------------------
def railx_topology(mcm: MCMArch, inter_degrees: Dict[str, int],
                   inter_vols: Dict[str, float],
                   reuse_pair=None, hw: HW = DEFAULT_HW
                   ) -> Optional[OITopology]:
    """HammingMesh-like: exactly TWO rail dimensions with UNIFORM links.

    Parallelism groups are packed onto the two dims; links are split
    50/50 regardless of traffic — the contrast with ChipLight's
    traffic-proportional allocation.
    """
    ps = [p for p, d in inter_degrees.items() if d > 1]
    n = 1
    for p in ps:
        n *= inter_degrees[p]
    if n == 1:
        return OITopology(dims=(), mapping=(), link_alloc={})
    l_half = max(mcm.total_links // 2, 1)
    best = None
    for mask in range(1, 1 << len(ps)):
        g1 = [ps[i] for i in range(len(ps)) if mask & (1 << i)]
        g2 = [p for p in ps if p not in g1]
        n1 = 1
        for p in g1:
            n1 *= inter_degrees[p]
        n2 = n // n1
        if n1 < 2 and g1:
            continue
        if g2 and n2 < 2:
            continue
        dims, mapping = [], []
        for grp, ni in ((g1, n1), (g2, n2)):
            if not grp:
                continue
            k = max(1, math.ceil(ni / hw.ocs_ports))
            if k > l_half:
                continue
            dims.append(RailDim(n=ni, r=l_half, k=k))
            mapping.append(tuple(grp))
        if len(dims) != (2 if g2 else 1):
            continue
        # uniform split within a dim, reuse only if the pair landed together
        alloc = {}
        rp = None
        for grp, d in zip(mapping, dims):
            if (reuse_pair and all(q in grp for q in reuse_pair)):
                rp = reuse_pair
                vmax = max(inter_vols.get(q, 0.0) for q in reuse_pair)
                vols_grp = {p: inter_vols.get(p, 0.0) for p in grp}
                others = {p: v for p, v in vols_grp.items()
                          if p not in reuse_pair}
                denom = sum(others.values()) + vmax
                l_r = max(int(d.r * vmax / denom), 1) if denom else d.r
                for p in reuse_pair:
                    alloc[p] = l_r
                rest = d.r - l_r
                so = sum(others.values())
                for p, v in others.items():
                    alloc[p] = max(int(rest * v / so), 1) if so else 1
            else:
                vols_grp = {p: max(inter_vols.get(p, 0.0), 1.0)
                            for p in grp}
                sv = sum(vols_grp.values())
                for p, v in vols_grp.items():
                    alloc[p] = max(int(d.r * v / sv), 1)
        topo = OITopology(dims=tuple(dims), mapping=tuple(mapping),
                          link_alloc=alloc, reuse_pair=rp)
        errs = topo.validate(mcm, hw, n_mcm_expected=n)
        if errs:
            continue
        if best is None or topo.ocs_count() < best.ocs_count():
            best = topo
    return best


def railx_evaluate_point(w: Workload, s: Strategy, mcm: MCMArch,
                         reuse: bool = True, hw: HW = DEFAULT_HW
                         ) -> Optional[DesignPoint]:
    """One design point on the RailX network: derive the uniform two-dim
    rail topology and simulate with its link allocation (the railx
    analogue of ``evaluate_point``; also the refinement oracle for the
    batched railx sweep)."""
    mapping = map_intra(w, s, mcm)
    if mapping is None:
        return None
    intra, inter = mapping
    vols = traffic_volumes(w, s)
    inter_vols = {p: vols[p] for p, d in inter.items()
                  if d > 1 and vols[p] > 0}
    rp = None
    if reuse:
        prs = [pr for pr in reusable_pairs(w, s)
               if pr[0] in inter_vols and pr[1] in inter_vols]
        rp = prs[0] if prs else None
    inter_deg = {p: d for p, d in inter.items() if d > 1}
    topo = railx_topology(mcm, inter_deg, inter_vols, reuse_pair=rp, hw=hw)
    if topo is None and inter_deg:
        return None
    sim = simulate(w, s, mcm, fabric="oi", topo=topo, reuse=reuse, hw=hw)
    if not sim.feasible:
        return None
    cost = cluster_cost(mcm, topo, fabric="oi", hw=hw).total
    return DesignPoint(s, mcm, topo, sim, cost)


def railx_search(w: Workload, mcm: MCMArch, reuse: bool = True,
                 budget: int = 64, hw: HW = DEFAULT_HW, seed: int = 0
                 ) -> Tuple[Optional[DesignPoint], List[DesignPoint]]:
    """Best strategy on the RailX network (fair comparison: same budget).

    The scalar reference loop; the batched engine sweeps the same grids
    at array speed via ``sweep_design_space(alloc_mode="railx")``."""
    evaluated = []
    for s in enumerate_strategies(w, mcm)[: budget * 4]:
        pt = railx_evaluate_point(w, s, mcm, reuse=reuse, hw=hw)
        if pt is not None:
            evaluated.append(pt)
    best = max(evaluated, key=lambda p: p.throughput, default=None)
    return best, evaluated
