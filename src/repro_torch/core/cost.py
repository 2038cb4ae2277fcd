"""Cluster cost model (Chiplet Actuary [36] / RailX [20] style).

Components: yield-adjusted logic silicon, HBM stacks, advanced packaging,
CPO optical ports, OCS switches (per port), fibers, or IB NICs for the
electrical baselines.  Absolute dollars are estimates; all paper
experiments compare *relative* cost, which these constants preserve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.hardware import HW, DEFAULT_HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology


@dataclass(frozen=True)
class CostBreakdown:
    silicon: float
    hbm: float
    packaging: float
    cpo: float
    ocs: float
    fiber: float
    nic: float

    @property
    def total(self) -> float:
        return (self.silicon + self.hbm + self.packaging + self.cpo
                + self.ocs + self.fiber + self.nic)


def cluster_cost(mcm: MCMArch, topo: Optional[OITopology] = None,
                 fabric: str = "oi", hw: Optional[HW] = None
                 ) -> CostBreakdown:
    hw = hw or mcm.hw
    n_dev = mcm.n_devices
    silicon = n_dev * hw.die_cost(mcm.hw.die_area_mm2)
    hbm = n_dev * mcm.m * hw.hbm_die_cost

    # packaging: interposer area ~ dies + HBM + CPO shoreline (x1.6 overhead)
    die_area = mcm.hw.die_area_mm2
    hbm_area = 110.0  # mm^2 per stack
    pkg_area = 1.6 * (mcm.dies_per_mcm * die_area
                      + mcm.dies_per_mcm * mcm.m * hbm_area)
    packaging = mcm.n_mcm * (hw.pkg_base_cost
                             + hw.pkg_cost_per_mm2 * pkg_area)

    cpo = ocs = fiber = nic = 0.0
    if fabric == "oi":
        links = mcm.n_mcm * mcm.total_links
        cpo = links * hw.cpo_cost_per_link
        fiber = links * hw.fiber_cost_per_link
        if topo is not None:
            ocs = topo.ocs_count() * hw.ocs_ports * hw.ocs_cost_per_port
    elif fabric == "ib":
        nic = n_dev * hw.nic_cost_ib
    elif fabric == "nvlink":
        # NVLink domain + IB scale-out, folded into per-device NIC+switch
        nic = n_dev * (hw.nic_cost_ib + 500.0)
    return CostBreakdown(silicon=silicon, hbm=hbm, packaging=packaging,
                         cpo=cpo, ocs=ocs, fiber=fiber, nic=nic)
