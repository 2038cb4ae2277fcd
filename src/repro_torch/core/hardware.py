"""Hardware constants for the ChipLight cluster model.

Sources: the paper §V-A — logic die parameters from H100 [34], memory die
HBM3 [35], chiplet D2D from [8] (658 GB/s/mm @ 0.29 pJ/b), CPO from
[12],[32] (128 GB/s/mm, 400 GB/s links), MEMS OCS as in TPUv4 [13],
cost structure per Chiplet Actuary [36] / RailX [20].  Where the paper is
silent we document our assumption inline.

The TPU-v5e constants at the bottom are for the JAX dry-run roofline only
(the assignment's target runtime), NOT for the paper-faithful experiments.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace


@dataclass(frozen=True)
class HW:
    # ---- logic die (H100-class) ----
    die_tflops: float = 989.0          # BF16 dense TFLOPs per H100-class die
    die_area_mm2: float = 814.0
    die_edge_mm: float = 28.5          # ~sqrt(area), square-die assumption
    sram_bytes: float = 50e6

    # ---- memory die (HBM3 stack) ----
    hbm_bw_per_die: float = 0.55e12    # B/s  (6 stacks ~ 3.3 TB/s on H100)
    hbm_cap_per_die: float = 16e9      # bytes (6 x 16 GB = 96 GB class)
    hbm_phy_mm: float = 9.0            # die-edge length consumed per stack
    h100_hbm_dies: int = 6

    # ---- electrical interconnect ----
    nvlink_bw: float = 900e9           # B/s per GPU (paper Fig 1)
    nvlink_domain: int = 8             # GPUs per NVLink scale-up node
    ib_bw: float = 60e9                # B/s per device (paper)

    # ---- chiplet D2D / NoP ----
    d2d_gbps_per_mm: float = 658e9     # B/s per mm of die edge [8]
    d2d_energy_pj_b: float = 0.29

    # ---- optics ----
    cpo_gbps_per_mm: float = 128e9     # B/s per mm of die edge [12],[32]
    oi_link_bw: float = 400e9          # B/s per optical link (paper §III-A)
    ocs_ports: int = 136               # MEMS OCS radix (Google Palomar)
    ocs_switch_latency_s: float = 10e-3   # ms-scale MEMS reconfiguration
    # Dynamic-link-reuse switching model:
    #  'banked' — links flip between the CP/EP configurations only when a
    #             bank-swap schedule gives them >= T_switch of slack
    #             (our physical model; with 10 ms MEMS this DISABLES reuse
    #             at large scale — a quantified limitation of the paper's
    #             assumption, see EXPERIMENTS.md §Fig8),
    #  'paper'  — reconfiguration is hidden inside compute gaps, as the
    #             paper asserts ('switching latency smaller than the
    #             traffic interval ... satisfied in practice').
    ocs_reuse_mode: str = "banked"
    ocs_cost_per_port: float = 300.0   # $ (TopoOpt/RailX-class estimate)
    fiber_cost_per_link: float = 50.0

    # ---- silicon cost model (Chiplet Actuary-style) ----
    wafer_cost: float = 17000.0        # $ per 300 mm wafer, 4 nm class
    wafer_diameter_mm: float = 300.0
    defect_density_per_cm2: float = 0.1
    yield_alpha: float = 6.0           # clustering parameter
    hbm_die_cost: float = 150.0        # $ per stack
    pkg_cost_per_mm2: float = 0.03     # $ interposer+substrate per mm^2
    pkg_base_cost: float = 80.0
    cpo_cost_per_link: float = 120.0   # $ per 400G optical port (CPO side)
    nic_cost_ib: float = 1500.0        # $ per device (IB NIC+cabling)

    # ---- modelled efficiencies ----
    mfu_ceiling: float = 0.55          # achievable fraction of peak FLOPs
    # per-hop collective launch/propagation latency, charged PER INVOCATION
    # (layer x microbatch), by fabric class:
    lat_intra_s: float = 0.7e-6        # NoP / NVLink hop
    lat_oi_s: float = 1.2e-6           # OCS circuit (fiber + serdes)
    lat_ib_s: float = 3.0e-6           # IB switch traversal
    # GEMM shape efficiency: utilisation ~ M/(M+gemm_m_half) in the token
    # (M) dim and analogous in the TP-sharded width (N) dim — models MXU /
    # tensor-core underutilisation when parallelism slices matmuls thin.
    # OFF by default: the paper's ASTRA-sim methodology charges compute at
    # a constant-MFU roofline; enabling this is our beyond-paper realism
    # ablation (see EXPERIMENTS.md).
    model_gemm_eff: bool = False
    gemm_m_half: float = 128.0
    gemm_n_half: float = 128.0
    # achieved fraction of line rate per fabric class: packet-switched
    # electrical clos suffers protocol + ECMP-collision losses; OCS
    # circuits are contention-free (a core ChipLight/TPUv4 argument).
    fabric_eff_elec: float = 0.65
    fabric_eff_oi: float = 0.9
    # Collective exposure follows the paper's ASTRA-sim methodology where
    # comm phases serialise with compute inside a layer; only partial
    # overlap is credited (bucketed DP AR in bwd, ring-attention CP).
    dp_overlap_frac: float = 0.5       # DP AR overlappable with bwd compute
    cp_overlap_frac: float = 0.5       # ring-attention overlap

    @classmethod
    def calibrated(cls, calib: dict, base: "HW" = None) -> "HW":
        """An ``HW`` running on the MEASURED constants of a CALIB.json
        artifact (``repro_torch.calib``): the artifact's ``effective`` block
        overrides the matching fields of ``base`` (default constants
        when omitted).  The fitted peaks are ACHIEVED asymptotes, so
        the block ships ``mfu_ceiling=1.0`` and turns the fitted
        ``M/(M+half)`` shape curve on (``model_gemm_eff=True``)."""
        eff = calib.get("effective")
        if not isinstance(eff, dict) or not eff:
            raise ValueError("calibration artifact has no 'effective' "
                             "block — re-run `cli calibrate`")
        known = {f.name for f in fields(cls)}
        bad = sorted(set(eff) - known)
        if bad:
            raise ValueError(f"calibration 'effective' block has "
                             f"unknown HW fields {bad}")
        return replace(base if base is not None else cls(), **eff)

    def die_cost(self, area_mm2: float) -> float:
        """Yield-adjusted cost of one logic die of the given area."""
        import math
        r = self.wafer_diameter_mm / 2.0
        dies = (math.pi * r * r / area_mm2
                - math.pi * 2.0 * r / math.sqrt(2.0 * area_mm2))
        d0a = self.defect_density_per_cm2 * (area_mm2 / 100.0)
        y = (1.0 + d0a / self.yield_alpha) ** (-self.yield_alpha)
        return self.wafer_cost / max(dies, 1.0) / max(y, 1e-6)


DEFAULT_HW = HW()


def scaled_die(hw: HW, scale: float) -> HW:
    """A logic die scaled to ``scale`` x the H100 compute (area ∝ compute).

    Edge scales with sqrt(area); per-die HBM attach capability unchanged.
    Used by the Fig 9(b) single-die-scale exploration.
    """
    import math
    return replace(hw,
                   die_tflops=hw.die_tflops * scale,
                   die_area_mm2=hw.die_area_mm2 * scale,
                   die_edge_mm=hw.die_edge_mm * math.sqrt(scale))


# --- TPU v5e constants (assignment roofline; NOT the paper's hardware) ---
TPU_V5E_FLOPS = 197e12        # bf16 FLOP/s per chip
TPU_V5E_HBM_BW = 819e9        # B/s
TPU_V5E_ICI_BW = 50e9         # B/s per link
TPU_V5E_HBM_GB = 16.0
