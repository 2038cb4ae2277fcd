"""MCM architecture model (paper §IV-A, Fig 5a).

Cluster compute C is the input constant; it is split into N MCMs of
``x*y`` logic dies, each coupled with ``m`` memory dies.  Optical I/O dies
sit at the package edge: each perimeter edge unit provides ``o`` links, so
an MCM exposes L = 2*(x+y)*o external links.  The logic-die edge is shared
between D2D (NoP) interfaces, HBM PHYs and (on perimeter dies) CPO — the
m <-> B_p <-> o beachfront trade-off the paper explores.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.hardware import HW, DEFAULT_HW


@dataclass(frozen=True)
class MCMArch:
    n_mcm: int                  # N  — number of MCMs in the cluster
    x: int                      # logic-die grid
    y: int
    m: int                      # memory dies per logic die
    cpo_ratio: float = 0.6      # r — fraction of outer edge used for CPO
    hw: HW = field(default_factory=lambda: DEFAULT_HW)

    # ------------------------------------------------------------------
    @property
    def dies_per_mcm(self) -> int:
        return self.x * self.y

    @property
    def n_devices(self) -> int:
        return self.n_mcm * self.dies_per_mcm

    @property
    def die_flops(self) -> float:
        return self.hw.die_tflops * 1e12

    @property
    def mcm_flops(self) -> float:
        return self.die_flops * self.dies_per_mcm

    @property
    def cluster_tflops(self) -> float:
        """Total compute C in TFLOPS (the paper's x-axis)."""
        return self.hw.die_tflops * self.n_devices

    # ------------------------------------------------------------------
    # Beachfront accounting (per logic die)
    @property
    def hbm_bw(self) -> float:
        """Memory bandwidth per logic die."""
        return self.m * self.hw.hbm_bw_per_die

    @property
    def hbm_capacity(self) -> float:
        return self.m * self.hw.hbm_cap_per_die

    def _edge_budget(self) -> float:
        return 4.0 * self.hw.die_edge_mm

    def hbm_edge(self) -> float:
        return self.m * self.hw.hbm_phy_mm

    def cpo_edge(self) -> float:
        """Outer-perimeter edge length used by CPO on a perimeter die."""
        return self.cpo_ratio * self.hw.die_edge_mm

    def d2d_edge_per_side(self) -> float:
        """Edge length available for one D2D (NoP neighbour) interface.

        Remaining beachfront after HBM (all dies) and CPO (perimeter dies,
        conservatively charged to every die) is split across the mesh
        degree (4 for interior dies).
        """
        free = self._edge_budget() - self.hbm_edge() - self.cpo_edge()
        return max(free, 0.0) / 4.0

    @property
    def nop_bw(self) -> float:
        """NoP bandwidth per D2D neighbour link (B/s, per direction)."""
        return self.hw.d2d_gbps_per_mm * self.d2d_edge_per_side()

    def feasible(self) -> bool:
        return (self.d2d_edge_per_side() > 0.5     # >0.5mm per interface
                and self.m >= 1 and self.x >= 1 and self.y >= 1)

    # ------------------------------------------------------------------
    # Optical links
    @property
    def links_per_edge_unit(self) -> int:
        """o — optical links provided per perimeter edge unit (one die)."""
        bw = self.hw.cpo_gbps_per_mm * self.cpo_edge()
        return int(bw // self.hw.oi_link_bw)

    @property
    def total_links(self) -> int:
        """L = 2*(x+y)*o."""
        return 2 * (self.x + self.y) * self.links_per_edge_unit

    @property
    def oi_bw_total(self) -> float:
        return self.total_links * self.hw.oi_link_bw

    # ------------------------------------------------------------------
    def intra_ring_bw(self, group: int) -> float:
        """Effective per-device ring bandwidth for a group of ``group``
        devices embedded in the x*y NoP mesh.

        A ring of g dies embedded in a mesh uses one mesh link per hop;
        per the paper, mesh NoP gets less efficient at larger scale — we
        model a sqrt penalty from ring-to-mesh embedding dilation.
        """
        if group <= 1:
            return float("inf")
        dilation = max(1.0, math.sqrt(group) / 2.0)
        return self.nop_bw / dilation


def mcm_from_compute(total_tflops: float, dies_per_mcm: int, m: int,
                     cpo_ratio: float = 0.6, hw: HW = DEFAULT_HW,
                     aspect=None) -> MCMArch:
    """Build an MCMArch from the cluster compute constant C (paper-style).

    Grid aspect defaults to the most square x*y factorisation.
    """
    n_dev = max(int(round(total_tflops / hw.die_tflops)), 1)
    # round the MCM count to a power of two: clusters are provisioned in
    # factorable sizes so parallelism degrees can tile them (paper tables
    # use powers of two throughout)
    n_mcm = max(n_dev // dies_per_mcm, 1)
    n_mcm = 2 ** int(round(math.log2(n_mcm))) if n_mcm > 1 else 1
    if aspect is None:
        x = int(math.sqrt(dies_per_mcm))
        while dies_per_mcm % x:
            x -= 1
    else:
        x = aspect
    y = dies_per_mcm // x
    return MCMArch(n_mcm=n_mcm, x=x, y=y, m=m, cpo_ratio=cpo_ratio, hw=hw)
