"""ChipLight cross-layer optimisation (paper §IV-B, Fig 6): the scalar
oracle pieces the study's batched path needs.

* ``enumerate_strategies`` / ``_divisors`` — the strategy grid;
* ``evaluate_point`` — the full scalar treatment of one design point
  (traffic, intra-MCM mapping, traffic-proportional link allocation with
  dynamic reuse, fewest-OCS physical topology, simulator, exact cost);
* the RailX baseline (``railx_topology`` / ``railx_evaluate_point`` /
  ``railx_search``).

The nested inner/outer optimiser (``inner_search``, the MCM planner,
``chiplight_optimize``) belongs to the ``chiplight-outer`` driver and
comes with it (ROADMAP A3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
