"""Bridge: ChipLight DSE output -> a concrete device mesh + sharding
intent (counterpart of ``repro/parallel/plan.py``).

A ``ParallelPlan`` captures the strategy the cross-layer optimiser picked.
On a physical (data, model) / (pod, data, model) mesh
(``launch/mesh.py``):
  * TP  -> ``model`` axis (intra-MCM HBD, paper Obs 1),
  * DP / FSDP -> ``data`` (+ ``pod``) axes,
  * EP  -> ``model`` axis when n_experts divides it (expert sharding,
           ``parallel/moe_a2a.py``), otherwise experts stay sharded on
           width,
  * CP  -> rides the ``data`` axis,
  * PP  -> the plan's ``pp`` (the analytic model's pipeline; no stage
           runtime in either package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.optimizer import DesignPoint
from repro_torch.core.traffic import Strategy


@dataclass(frozen=True)
class ParallelPlan:
    tp: int
    dp: int
    pp: int = 1
    cp: int = 1
    ep: int = 1
    n_micro: int = 1
    reuse_pair: Optional[tuple] = None
    link_alloc: Optional[dict] = None

    @property
    def strategy(self) -> Strategy:
        return Strategy(tp=self.tp, dp=self.dp, pp=self.pp, cp=self.cp,
                        ep=self.ep, n_micro=self.n_micro)

    def mesh_shape(self, pod: int = 1):
        if pod > 1:
            return (pod, self.dp // pod, self.tp), ("pod", "data", "model")
        return (self.dp, self.tp), ("data", "model")


def plan_from_design(pt: DesignPoint) -> ParallelPlan:
    s = pt.strategy
    return ParallelPlan(
        tp=s.tp, dp=s.dp * s.cp * s.ep,   # CP/EP ride the data axis
        pp=s.pp, cp=s.cp, ep=s.ep, n_micro=s.n_micro,
        reuse_pair=pt.topo.reuse_pair if pt.topo else None,
        link_alloc=dict(pt.topo.link_alloc) if pt.topo else None)
