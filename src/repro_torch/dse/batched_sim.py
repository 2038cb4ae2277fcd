"""Vectorized (SoA) port of ``core.simulator.simulate``.

Evaluates a whole ``StrategyBatch`` on one (MCM, fabric) cell with a
fixed number of numpy array ops — no per-point Python.  Parity contract:
for every point i, ``batched_simulate(w, batch, mcm, fabric, reuse,
hw)`` reproduces ``simulate(w, batch[i], mcm, fabric, topo=None, reuse,
hw)`` — same feasibility mask, same step time (float64, same operation
order; held element-wise against the reference in
tests/test_torch_dse.py).  The
scalar simulator remains the oracle; this module is the hot path.

The compute/collective cost terms (``_terms_core``) run in float64
torch on the chosen ``device`` — the card by default; ``device="cpu"``
runs the same torch code on CPU tensors, the plain path.  The terms are
written so that the card and the CPU round every operation alike and
agree bit for bit with the scalar simulator's numpy mirror: each
expression keeps its operand order, the five-term sum is an explicit
left-to-right chain, no division takes a Python scalar (torch turns
``x / c`` on the card and ``c / x`` everywhere into a reciprocal and a
product, which rounds twice), and the one square root, of whole group
sizes, comes from a correctly rounded table (``_run_terms``).

The integer/combinatorial stages (intra-MCM packing, link allocation,
reuse-pair choice) run in numpy on the host (ROADMAP queues them for
the device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hardware import HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.workload import Workload
from repro_torch.dse.space import P_IDX, StrategyBatch
from repro_torch.models.common import check_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span


@dataclass(frozen=True)
class MCMBatch:
    """Per-design-point MCM parameters (SoA) — lets ONE batched_simulate
    call span heterogeneous MCM variants (the cross-cell fused sweep).

    For a homogeneous batch just pass an ``MCMArch``; everything here is
    scalar-broadcast from its properties, so results are bit-identical
    either way.
    """

    dies_per_mcm: np.ndarray      # (B,) int
    n_devices: np.ndarray         # (B,) int
    n_mcm: np.ndarray             # (B,) int
    m: np.ndarray                 # (B,) int HBM stacks per die
    hbm_bw: np.ndarray            # (B,) B/s per die
    hbm_capacity: np.ndarray      # (B,) bytes per die
    nop_bw: np.ndarray            # (B,) B/s per D2D link
    total_links: np.ndarray       # (B,) optical links per MCM
    die_flops: np.ndarray         # (B,) FLOP/s per die

    _FIELDS = ("dies_per_mcm", "n_devices", "n_mcm", "m", "hbm_bw",
               "hbm_capacity", "nop_bw", "total_links", "die_flops")

    def __len__(self) -> int:
        return int(self.dies_per_mcm.shape[0])

    def take(self, idx) -> "MCMBatch":
        if np.ndim(self.dies_per_mcm) == 0:      # scalar pseudo-batch
            return self
        return MCMBatch(*(getattr(self, f)[idx] for f in self._FIELDS))

    @classmethod
    def from_mcms(cls, mcms, idx: np.ndarray) -> "MCMBatch":
        """Gather per-point parameters: point i uses mcms[idx[i]]."""
        idx = np.asarray(idx, np.int64)
        def g(fn, dtype):
            vals = np.array([fn(m) for m in mcms], dtype)
            return vals[idx]
        return cls(
            dies_per_mcm=g(lambda m: m.dies_per_mcm, np.int64),
            n_devices=g(lambda m: m.n_devices, np.int64),
            n_mcm=g(lambda m: m.n_mcm, np.int64),
            m=g(lambda m: m.m, np.int64),
            hbm_bw=g(lambda m: m.hbm_bw, np.float64),
            hbm_capacity=g(lambda m: m.hbm_capacity, np.float64),
            nop_bw=g(lambda m: m.nop_bw, np.float64),
            total_links=g(lambda m: m.total_links, np.int64),
            die_flops=g(lambda m: m.die_flops, np.float64))


def _mcm_params(mcm) -> "MCMBatch":
    """Normalize MCMArch -> scalar-field pseudo-batch (broadcasts)."""
    if isinstance(mcm, MCMBatch):
        return mcm
    return MCMBatch(
        dies_per_mcm=np.int64(mcm.dies_per_mcm),
        n_devices=np.int64(mcm.n_devices),
        n_mcm=np.int64(mcm.n_mcm),
        m=np.int64(mcm.m),
        hbm_bw=np.float64(mcm.hbm_bw),
        hbm_capacity=np.float64(mcm.hbm_capacity),
        nop_bw=np.float64(mcm.nop_bw),
        total_links=np.int64(mcm.total_links),
        die_flops=np.float64(mcm.die_flops))

# reuse-pair candidates, in ``reusable_pairs`` candidate order
_REUSE_CANDS = (("CP", "EP"), ("CP", "DP"), ("EP", "DP"), ("PP", "DP"))

# simple board-power model for the Pareto objective (documented in
# DESIGN.md): static die/HBM/optics power + utilisation-scaled dynamic
DIE_IDLE_W = 150.0          # leakage + uncore per logic die
DIE_DYN_W = 550.0           # dynamic at full compute utilisation
HBM_W_PER_STACK = 30.0
OI_W_PER_LINK = 15.0        # CPO 400G port, both ends + laser
NIC_W_PER_DEV = 25.0        # IB NIC (electrical fabrics)


def board_power(mcm, fabric: str, util: float) -> float:
    """Scalar board power for one MCMArch at the given compute
    utilisation — the same model the batched path applies element-wise,
    so refined (scalar-oracle) records stay comparable to sweep rows."""
    n_dev = mcm.n_devices
    power = n_dev * (DIE_IDLE_W + DIE_DYN_W * util) \
        + n_dev * mcm.m * HBM_W_PER_STACK
    if fabric == "oi":
        return power + mcm.n_mcm * mcm.total_links * OI_W_PER_LINK
    return power + n_dev * NIC_W_PER_DEV

# infeasibility reason codes
OK, BAD_DEVICES, UNMAPPABLE, HBM_CAPACITY = 0, 1, 2, 3
REASONS = {OK: "", BAD_DEVICES: "strategy devices != cluster",
           UNMAPPABLE: "unmappable intra-MCM packing",
           HBM_CAPACITY: "HBM capacity"}


@dataclass(frozen=True)
class BatchedSimResult:
    """SoA mirror of a list of ``SimResult`` (arrays over the batch)."""

    feasible: np.ndarray        # (B,) bool
    step_time: np.ndarray       # (B,) float64, inf where infeasible
    throughput: np.ndarray      # (B,) tokens/s, 0 where infeasible
    mfu: np.ndarray             # (B,)
    power: np.ndarray           # (B,) watts, inf where infeasible
    t_comp: np.ndarray          # (B,)
    t_mem: np.ndarray           # (B,)
    t_coll: np.ndarray          # (B, 5) per-parallelism, P_ORDER
    exposed: np.ndarray         # (B,) serial comm exposure (non-DP)
    dp_exposed: np.ndarray      # (B,)
    bubble: np.ndarray          # (B,)
    reuse_active: np.ndarray    # (B,) bool
    reason_code: np.ndarray     # (B,) int, REASONS

    def __len__(self) -> int:
        return int(self.step_time.shape[0])

    def logs(self) -> Dict[str, np.ndarray]:
        """Array analogue of ``SimResult.logs`` (planner-facing signals)."""
        with np.errstate(invalid="ignore"):
            util = np.where(self.feasible, self.t_comp / self.step_time, 0.0)
        return {
            "compute_util": util,
            "exposed_comm": self.exposed + self.dp_exposed,
            "bubble": self.bubble,
            "reuse_active": self.reuse_active.astype(float),
            "hbm_bw_bound": (self.t_mem > self.t_comp).astype(float),
        }


# ---------------------------------------------------------------------------
# Vectorized intra-MCM packing (port of simulator.map_intra)
# ---------------------------------------------------------------------------
def map_intra_batch(batch: StrategyBatch, mcm: MCMArch
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (mappable (B,), intra (B,5), inter (B,5)) degree arrays.

    Mirrors ``map_intra``: TP always intra; if the package is larger,
    the first exact-fit group among CP, EP, PP fills it, else a
    hierarchical DP slice; otherwise the point is unmappable.
    """
    dies = mcm.dies_per_mcm
    deg = batch.degrees()                       # (B, 5)
    tp, dp, pp, cp, ep = (deg[:, P_IDX[p]] for p in
                          ("TP", "DP", "PP", "CP", "EP"))
    ok = (tp <= dies) & (dies % np.maximum(tp, 1) == 0) & (tp >= 1)
    rem = np.where(ok, dies // np.maximum(tp, 1), 0)

    intra = np.ones_like(deg)
    inter = deg.copy()
    intra[:, P_IDX["TP"]] = tp
    inter[:, P_IDX["TP"]] = 1

    need = ok & (rem > 1)
    cp_fit = need & (cp == rem)
    ep_fit = need & ~cp_fit & (ep == rem)
    pp_fit = need & ~cp_fit & ~ep_fit & (pp == rem)
    for name, fit in (("CP", cp_fit), ("EP", ep_fit), ("PP", pp_fit)):
        i = P_IDX[name]
        intra[:, i] = np.where(fit, rem, intra[:, i])
        inter[:, i] = np.where(fit, 1, inter[:, i])
    rem2 = np.where(cp_fit | ep_fit | pp_fit, 1, rem)

    need2 = ok & (rem2 > 1)
    dp_fit = need2 & (dp % np.maximum(rem2, 1) == 0)
    i = P_IDX["DP"]
    intra[:, i] = np.where(dp_fit, rem2, intra[:, i])
    inter[:, i] = np.where(dp_fit, dp // np.maximum(rem2, 1), inter[:, i])
    rem3 = np.where(dp_fit, 1, rem2)

    mappable = ok & (rem3 <= 1)
    return mappable, intra, inter


# ---------------------------------------------------------------------------
# Vectorized traffic volumes (port of traffic.traffic_volumes)
# ---------------------------------------------------------------------------
def traffic_volumes_batch(w: Workload, batch: StrategyBatch) -> np.ndarray:
    """(B, 5) bytes/device/step per parallelism, in P_ORDER.

    Degrees are pre-cast to float64 once (exact for these magnitudes)
    so each expression below is pure float arithmetic — the values stay
    bit-identical to ``traffic_volumes``'s int->float promotions.
    """
    B = len(batch)
    tp, dp, pp, cp, ep = (batch.tp.astype(np.float64),
                          batch.dp.astype(np.float64),
                          batch.pp.astype(np.float64),
                          batch.cp.astype(np.float64),
                          batch.ep.astype(np.float64))
    vols = np.zeros((B, 5))
    layers_ps = np.maximum(w.n_layers // batch.pp, 1)
    attn_ps = np.maximum(w.n_attn_layers // batch.pp, 1) \
        if w.n_attn_layers else 0
    moe_ps = np.maximum(w.n_moe_layers // batch.pp, 1) \
        if w.n_moe_layers else 0
    t_stage = w.tokens_per_step / (dp * cp)
    act = t_stage * w.d_model * w.bytes_act

    v_tp = 8.0 * layers_ps * act * (tp - 1.0) / tp
    vols[:, P_IDX["TP"]] = np.where(tp > 1, v_tp, 0.0)

    if w.n_attn_layers:
        kv_shard = np.minimum(tp, w.model.attn.n_kv_heads) \
            if w.model.attn else tp
        kv = t_stage * w.kv_bytes_per_token / kv_shard
        v_cp = 2.0 * attn_ps * (cp - 1.0) * kv
        vols[:, P_IDX["CP"]] = np.where(cp > 1, v_cp, 0.0)

    if w.n_moe_layers:
        topk = w.model.moe.top_k
        v_ep = (4.0 * moe_ps * (t_stage / tp) * topk
                * w.d_model * w.bytes_act * (ep - 1.0) / ep)
        vols[:, P_IDX["EP"]] = np.where(ep > 1, v_ep, 0.0)

    local = (w.nonexpert_params / (tp * pp)
             + w.expert_params / (tp * pp * ep))
    v_dp = 2.0 * local * w.bytes_grad * (dp - 1.0) / dp
    vols[:, P_IDX["DP"]] = np.where(dp > 1, v_dp, 0.0)

    v_pp = 2.0 * (t_stage / tp) * w.d_model * w.bytes_act
    vols[:, P_IDX["PP"]] = np.where(pp > 1, v_pp, 0.0)
    return vols


# ---------------------------------------------------------------------------
# HBM capacity demand (port of simulate's capacity check)
# ---------------------------------------------------------------------------
def hbm_demand_batch(w: Workload, batch: StrategyBatch
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (HBM bytes demanded, local parameter count): weights +
    optimizer state + pipeline-held activations.  The ONE batched copy
    of the oracle's capacity-check expressions — both the feasibility
    gate here and the refinement stage's ``mem_pressure`` log go
    through it, so they cannot drift."""
    tp, dp, pp, cp, ep = batch.tp, batch.dp, batch.pp, batch.cp, batch.ep
    nm = np.maximum(batch.n_micro, 1)
    layers_stage = np.maximum(w.n_layers // pp, 1)
    local_params = (w.nonexpert_params / (tp * pp)
                    + w.expert_params / (tp * pp * ep))
    mem_bytes = local_params * (2 + 2) + local_params * 12 / dp
    tokens_micro = w.tokens_per_step / (dp * cp * nm)
    act_bytes = (tokens_micro * w.d_model * w.bytes_act / tp
                 * layers_stage * 2 * np.minimum(pp, nm))
    return mem_bytes + act_bytes, local_params


# ---------------------------------------------------------------------------
# Vectorized link allocation (port of network.allocate_links)
# ---------------------------------------------------------------------------
def _trim_over_budget(alloc, usage, total_links, inter_mask, active,
                      pair_a=None, pair_b=None, first=None):
    """Shared trim loop: decrement the largest claim (first-max in
    P_ORDER, matching dict iteration order) until within budget or all
    claims are at the 1-link floor.  Overshoot is bounded by the number
    of min-1 bumps, so this converges in <= 6 passes."""
    B = alloc.shape[0]
    rows = np.arange(B)
    done = ~active
    for _ in range(8):
        tot = usage.sum(1)
        over = ~done & (tot > total_links)
        if not over.any():
            break
        masked = np.where(inter_mask, usage, -1)
        j = np.argmax(masked, 1)
        mx = masked[rows, j]
        act = over & (mx > 1)
        done |= over & (mx <= 1)
        if not act.any():
            break
        usage[rows[act], j[act]] -= 1
        alloc[rows[act], j[act]] -= 1
        if pair_a is not None:
            hit = act & (j == first)
            r = rows[hit]
            alloc[r, pair_a[hit]] = usage[r, j[hit]]
            alloc[r, pair_b[hit]] = usage[r, j[hit]]
    return alloc


def allocate_links_batch(vols: np.ndarray, inter_mask: np.ndarray,
                         total_links: int,
                         pair_a: Optional[np.ndarray] = None,
                         pair_b: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, 5) link allocation (integer-valued float64); pair_a/pair_b
    are per-row parallelism indices of the reuse pair (-1 = no reuse).
    Mirrors ``network.allocate_links`` including its overshoot trim."""
    B = vols.shape[0]
    rows = np.arange(B)
    L = np.asarray(total_links, np.float64)
    Lc = L[:, None] if L.ndim else L          # per-point budgets (MCMBatch)
    mvols = np.where(inter_mask, vols, 0.0)
    ssum = mvols.sum(1)
    ssafe = np.where(ssum > 0, ssum, 1.0)
    alloc = np.where(inter_mask,
                     np.maximum(np.floor(Lc * mvols
                                         / ssafe[:, None]), 1.0),
                     0.0)                 # integer-valued float64 throughout
    usage = alloc.copy()
    alloc = _trim_over_budget(alloc, usage, total_links, inter_mask,
                              active=ssum > 0)

    if pair_a is None:
        return alloc
    has = (pair_a >= 0)
    if not has.any():
        return alloc
    pa = np.where(has, pair_a, 0)
    pb = np.where(has, pair_b, 0)
    va = vols[rows, pa]
    vb = vols[rows, pb]
    vmax = np.maximum(va, vb)
    pair_slots = np.zeros_like(inter_mask)
    pair_slots[rows, pa] = True
    pair_slots[rows, pb] = True
    others = inter_mask & ~pair_slots
    so = np.where(others, vols, 0.0).sum(1)
    denom = so + vmax
    dsafe = np.where(denom > 0, denom, 1.0)
    l_reuse = np.maximum(np.floor(L * vmax / dsafe), 1.0)
    rest = L - l_reuse
    so_safe = np.where(so > 0, so, 1.0)
    alloc_r = np.where(
        others, np.maximum(np.floor(rest[:, None] * vols / so_safe[:, None]),
                           1.0), 0.0)
    alloc_r[rows, pa] = l_reuse
    alloc_r[rows, pb] = l_reuse
    # pair links counted once, charged to the member first in P_ORDER
    first = np.minimum(pa, pb)
    usage_r = np.where(others, alloc_r, 0.0)
    usage_r[rows, first] = l_reuse
    alloc_r = _trim_over_budget(alloc_r, usage_r, total_links, inter_mask,
                                active=has, pair_a=pa, pair_b=pb,
                                first=first)
    return np.where(has[:, None], alloc_r, alloc)


# ---------------------------------------------------------------------------
# RailX allocation variant (port of optimizer.railx_topology's link split)
# ---------------------------------------------------------------------------
# inter-parallelism columns in the scalar ``ps`` order (map_intra's inter
# dict: DP, PP, CP, EP) — P_ORDER[1:], so pair indices map via ``- 1``
_RAILX_COLS = ("DP", "PP", "CP", "EP")


def allocate_links_railx_batch(vols: np.ndarray, inter: np.ndarray,
                               inter_mask: np.ndarray, total_links,
                               pair_a: np.ndarray, pair_b: np.ndarray,
                               ocs_ports: int
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """RailX link allocation: at most TWO rail dimensions with UNIFORM
    budgets (``L // 2`` each), parallelism groups packed onto the dims by
    the fewest-OCS split (the grouping search of
    ``core.optimizer.railx_topology``, vectorized over the 15 subset
    masks of the four inter parallelisms), links within a dim split
    traffic-proportionally.  Returns ``(alloc (B, 5), pair_shared (B,),
    derivable (B,))``: ``pair_shared`` marks rows whose reuse pair landed
    on ONE dim (only then can the pair share links), ``derivable`` rows
    with a valid grouping (scan-level signal; refinement re-derives the
    exact topology and drops the rest).  Undervisable-but-active rows get
    a best-effort single-dim split so the scan still ranks them."""
    B = vols.shape[0]
    rows = np.arange(B)
    cols = np.array([P_IDX[p] for p in _RAILX_COLS])
    deg4 = inter[:, cols].astype(np.int64)
    act = deg4 > 1                      # group membership is by DEGREE
    vols4 = vols[:, cols]
    # members with degree > 1 but zero traffic exist in the dim but are
    # outside inter_vols — the scalar code gives them the 1-link floor
    L = np.broadcast_to(np.asarray(total_links, np.int64), (B,))
    l_half = np.maximum(L // 2, 1).astype(np.float64)

    big = np.iinfo(np.int64).max
    best_ocs = np.full(B, big)
    best_mask = np.zeros(B, np.int64)
    for mask in range(1, 16):
        bits = np.array([(mask >> i) & 1 for i in range(4)], bool)
        g1 = act & bits
        g2 = act & ~bits
        valid = ~(bits & ~act).any(1) & g1.any(1)
        n1 = np.where(g1, deg4, 1).prod(1)
        n2 = np.where(g2, deg4, 1).prod(1)
        has2 = g2.any(1)
        # k_i = ceil(n_i / P) passes validate() only at k == 1
        valid &= n1 <= ocs_ports
        valid &= ~has2 | (n2 <= ocs_ports)
        valid &= ~has2 | (2 * l_half <= L)       # sum(R_i) <= L
        ocs = np.where(has2, (n1 + n2) * l_half.astype(np.int64),
                       l_half.astype(np.int64))
        better = valid & (ocs < best_ocs)
        best_ocs = np.where(better, ocs, best_ocs)
        best_mask = np.where(better, mask, best_mask)

    n_act = act.sum(1)
    derivable = (best_ocs < big) | (n_act == 0)
    # best-effort fallback for underivable active rows: one dim, all ps
    best_mask = np.where((n_act > 0) & ~derivable, 15, best_mask)

    bits1 = ((best_mask[:, None] >> np.arange(4)[None, :]) & 1) > 0
    g1 = act & bits1
    g2 = act & ~bits1

    has_pair = (pair_a >= 0)
    pa = np.where(has_pair, pair_a - 1, 0)       # P_ORDER index -> col4
    pb = np.where(has_pair, pair_b - 1, 0)
    pair_slots = np.zeros_like(act)
    pair_slots[rows, pa] = has_pair
    pair_slots[rows, pb] |= has_pair

    def dim_alloc(grp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(alloc4 (B, 4), pair_here (B,)) for one rail dimension."""
        pair_here = has_pair & grp[rows, pa] & grp[rows, pb]
        # plain traffic-proportional split, volumes floored at 1.0
        vf = np.where(grp, np.maximum(vols4, 1.0), 0.0)
        sv = vf.sum(1)
        svs = np.where(sv > 0, sv, 1.0)
        plain = np.where(
            grp, np.maximum(np.floor(l_half[:, None] * vf
                                     / svs[:, None]), 1.0), 0.0)
        if not pair_here.any():
            return plain, pair_here
        # pair shares l_reuse links; others get the remainder (raw vols)
        vmax = np.maximum(vols4[rows, pa], vols4[rows, pb])
        others = grp & ~pair_slots
        vo = np.where(others, vols4, 0.0)
        so = vo.sum(1)
        denom = so + vmax
        l_r = np.where(denom > 0,
                       np.maximum(np.floor(l_half * vmax
                                           / np.where(denom > 0, denom,
                                                      1.0)), 1.0),
                       l_half)
        rest = l_half - l_r
        sos = np.where(so > 0, so, 1.0)
        shared = np.where(
            others,
            np.where(so[:, None] > 0,
                     np.maximum(np.floor(rest[:, None] * vo
                                         / sos[:, None]), 1.0), 1.0),
            0.0)
        shared[rows, pa] = l_r
        shared[rows, pb] = l_r
        # non-pair rows keep the plain split (shared is discarded there)
        return np.where(pair_here[:, None], shared, plain), pair_here

    a1, p1 = dim_alloc(g1)
    a2, p2 = dim_alloc(g2)
    alloc = np.zeros_like(vols)
    alloc[:, cols] = a1 + a2             # groups are disjoint
    return alloc, p1 | p2, derivable


# ---------------------------------------------------------------------------
# Reuse-pair selection (port of traffic.reusable_pairs + simulate filter)
# ---------------------------------------------------------------------------
def pick_reuse_pairs(vols: np.ndarray, inter_mask: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (pair_a, pair_b) parallelism indices of the selected reuse
    pair, or (-1, -1).  Highest min-volume inter-active candidate wins,
    candidate-order tie-break — identical to ``reusable_pairs`` followed
    by the simulator's inter_vols filter."""
    B = vols.shape[0]
    keys = np.full((B, len(_REUSE_CANDS)), -np.inf)
    for k, (a, b) in enumerate(_REUSE_CANDS):
        ia, ib = P_IDX[a], P_IDX[b]
        valid = inter_mask[:, ia] & inter_mask[:, ib]
        keys[:, k] = np.where(valid,
                              np.minimum(vols[:, ia], vols[:, ib]), -np.inf)
    sel = np.argmax(keys, 1)
    any_valid = np.isfinite(keys[np.arange(B), sel])
    ia = np.array([P_IDX[a] for a, _ in _REUSE_CANDS])[sel]
    ib = np.array([P_IDX[b] for _, b in _REUSE_CANDS])[sel]
    return (np.where(any_valid, ia, -1), np.where(any_valid, ib, -1))


def _ceil_log2_int(x: np.ndarray) -> np.ndarray:
    """Exact integer ceil(log2(x)) for x >= 1 (frexp-based, no libm)."""
    x = np.maximum(x, 1).astype(np.int64)
    _, e = np.frexp(x.astype(np.float64))
    is_pow2 = (x & (x - 1)) == 0
    return (e - is_pow2.astype(e.dtype)).astype(np.int64)


# ---------------------------------------------------------------------------
# GEMM shape efficiency (port of simulator._gemm_eff)
# ---------------------------------------------------------------------------
def gemm_eff_batch(w: Workload, batch: StrategyBatch, hw: HW) -> np.ndarray:
    m_tok = w.tokens_per_step / (batch.dp * batch.cp
                                 * np.maximum(batch.n_micro, 1))
    em = lambda m: m / (m + hw.gemm_m_half)
    en = lambda n: n / (n + hw.gemm_n_half)
    model = w.model
    a = model.attn
    tp = batch.tp
    if model.moe is not None:
        moe = model.moe
        m_exp = m_tok * moe.top_k / moe.n_experts
        n_ffn = np.maximum(moe.d_ff_expert / tp, 1.0)
        eff_ffn = em(m_exp) * en(n_ffn)
        ffn_flops = moe.top_k * 3 * model.d_model * moe.d_ff_expert
    else:
        d_ff = model.d_ff if model.d_ff else 2 * model.d_model
        eff_ffn = em(m_tok) * en(np.maximum(d_ff / tp, 1.0))
        ffn_flops = 3 * model.d_model * d_ff
    if a is not None:
        other_w = np.maximum(a.n_heads * a.head_dim / tp, 1.0)
        other_flops = model._attn_params()
    else:
        other_w = np.maximum(2 * model.d_model / tp, 1.0)
        other_flops = model._ssm_params() if model.ssm else \
            2 * model.d_model * model.d_model
    eff_other = em(m_tok) * en(other_w)
    f = ffn_flops / max(ffn_flops + other_flops, 1.0)
    return 1.0 / (f / np.maximum(eff_ffn, 1e-3)
                  + (1 - f) / np.maximum(eff_other, 1e-3))


# ---------------------------------------------------------------------------
# Cost-term core — float64 torch on the chosen device
# ---------------------------------------------------------------------------
def _terms_core(a: Dict[str, torch.Tensor], w_scalars: Tuple, fabric: str,
                hw: HW) -> Dict[str, torch.Tensor]:
    """Collective/memory/exposure terms -> step time.

    ``a`` holds per-point tensors (MCM parameters included, so one call
    can span heterogeneous MCM variants), all on one device.  Every
    expression mirrors ``core.simulator.simulate`` operation-for-
    operation, in its operand order (float64 parity, bit for bit with
    numpy; see the module docstring for the rules that keep it so).
    """
    vols, alloc = a["vols"], a["alloc"]
    inv, hops = a["inv"], a["hops"]
    intra, inter_mask = a["intra"], a["inter_mask"]
    t_comp, local_params = a["t_comp"], a["local_params"]
    layers_stage, nm = a["layers_stage"], a["nm"]
    tp, dp, pp, cp = a["tp"], a["dp"], a["pp"], a["cp"]
    reuse_overhead = a["reuse_overhead"]
    hbm_bw, nop_bw, dies = a["hbm_bw"], a["nop_bw"], a["dies"]

    hbm_cap_bw = hbm_bw / 2.0              # insight 5: relay = read+write
    t_coll = torch.zeros_like(vols)

    # ---- intra-MCM collectives ----
    intra_active = (intra > 1) & (vols > 0)
    if fabric == "nvlink":
        bw_i = torch.clamp(hbm_cap_bw,
                           max=hw.nvlink_bw * hw.fabric_eff_elec)[:, None]
        t_intra = vols / bw_i
    else:
        dil = torch.clamp(a["sqrt_intra"] / 2.0, min=1.0)
        bw_i = torch.minimum(nop_bw[:, None] / dil, hbm_cap_bw[:, None])
        t_intra = vols / bw_i
    t_coll = t_coll + torch.where(intra_active,
                                  t_intra + inv * hops * hw.lat_intra_s, 0.0)

    # ---- inter-MCM collectives ----
    if fabric in ("ib", "nvlink"):
        masked = torch.where(inter_mask, vols, 0.0)
        # numpy's order for a five-element sum: left to right
        shared = (((masked[:, 0] + masked[:, 1]) + masked[:, 2])
                  + masked[:, 3]) + masked[:, 4]
        bw_sh = torch.clamp(hbm_cap_bw, max=hw.ib_bw * hw.fabric_eff_elec)
        t_sh = shared / bw_sh
        shared_safe = torch.where(shared > 0, shared, 1.0)
        t_coll = t_coll + torch.where(
            inter_mask,
            t_sh[:, None] * vols / shared_safe[:, None]
            + inv * hops * hw.lat_ib_s, 0.0)
    elif fabric == "oi":
        links = torch.clamp(alloc, min=1.0)
        bw = torch.minimum(links * hw.oi_link_bw * hw.fabric_eff_oi
                           / dies[:, None], hbm_cap_bw[:, None])
        t_coll = t_coll + torch.where(
            inter_mask, vols / bw + inv * hops * hw.lat_oi_s, 0.0)
    else:
        raise ValueError(fabric)

    # ---- memory streaming ----
    # (bytes_param, tokens_per_step, d_model, bytes_act) — Python floats
    bytes_param, tokens, d_model, bytes_act = w_scalars
    act_per_dev = torch.full_like(dp, 12.0 * tokens) / (dp * cp * tp)
    hbm_stream = (local_params * bytes_param * 2.0 * nm
                  + local_params * 16.0
                  + act_per_dev * d_model * bytes_act * layers_stage)
    t_mem = hbm_stream / hbm_bw

    # ---- exposure / overlap ----
    t_attn = t_comp * 0.3
    exposed = t_coll[:, P_IDX["TP"]]
    exposed = exposed + torch.clamp(t_coll[:, P_IDX["CP"]]
                                    - t_attn * hw.cp_overlap_frac, min=0.0)
    exposed = exposed + t_coll[:, P_IDX["EP"]]
    exposed = exposed + t_coll[:, P_IDX["PP"]]
    t_dp = t_coll[:, P_IDX["DP"]]
    dp_exposed = torch.clamp(t_dp - (2.0 / 3.0) * t_comp
                             * hw.dp_overlap_frac, min=0.0)

    bubble = (pp - 1) / nm
    body = torch.maximum(t_comp, t_mem) + exposed
    step = body * (1.0 + bubble) + dp_exposed + reuse_overhead
    return {"step": step, "t_mem": t_mem, "t_coll": t_coll,
            "exposed": exposed, "dp_exposed": dp_exposed, "bubble": bubble}


_TERM_KEYS = ("vols", "alloc", "inv", "hops", "intra", "inter_mask",
              "t_comp", "local_params", "layers_stage", "nm", "tp", "dp",
              "pp", "cp", "reuse_overhead", "hbm_bw", "nop_bw", "dies")


def _to_device(v, dtype, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(v, dtype=dtype)
    if not arr.flags.writeable:        # a broadcast or read-only view
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _run_terms(a: Dict, fabric: str, hw: HW, device: torch.device
               ) -> Dict[str, np.ndarray]:
    """Move the ``_TERM_KEYS`` arrays to ``device`` (float64; bool for
    ``inter_mask``), run ``_terms_core`` there and bring the terms back
    as float64 numpy arrays (the span ``batched_sim.terms`` times it all,
    copies included)."""
    with span("batched_sim.terms", rows=len(a["vols"]), device=device.type):
        obs_metrics.inc("batched_sim.device_calls")
        t = {k: _to_device(a[k], bool if k == "inter_mask" else np.float64,
                           device) for k in _TERM_KEYS}
        # sqrt of the intra-MCM group sizes (whole numbers) by table
        # lookup: torch's float64 sqrt on the CPU goes through MKL's vector
        # library, which is within an ulp but not correctly rounded;
        # math.sqrt is correctly rounded, as numpy's and the card's are
        n_max = int(np.max(a["intra"], initial=0))
        roots = torch.tensor([math.sqrt(n) for n in range(n_max + 1)],
                             dtype=torch.float64, device=device)
        t["sqrt_intra"] = roots[t["intra"].long()]
        out = _terms_core(t, a["w_scalars"], fabric, hw)
        return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The batched simulator
# ---------------------------------------------------------------------------
def batched_simulate(w: Workload, batch: StrategyBatch, mcm,
                     fabric: str = "oi", reuse: bool = True,
                     hw: Optional[HW] = None,
                     device="cuda",
                     alloc_mode: str = "chiplight") -> BatchedSimResult:
    """``mcm`` may be an ``MCMArch`` (homogeneous batch) or an
    ``MCMBatch`` of per-point parameters (fused cross-variant sweep; an
    explicit ``hw`` is then required).  ``device`` is where the cost
    terms run (a CUDA device that is not there raises).  ``alloc_mode``
    selects the OI link allocator: ``"chiplight"`` (traffic-proportional
    + dynamic reuse) or ``"railx"`` (uniform 50/50 two-rail-dim
    baseline)."""
    if hw is None:
        if isinstance(mcm, MCMBatch):
            raise ValueError("pass hw= explicitly with an MCMBatch")
        hw = mcm.hw
    device = check_device(device)
    mb = _mcm_params(mcm)
    B = len(batch)
    if B == 0:
        z = np.zeros(0)
        zb = np.zeros(0, bool)
        zi = np.zeros(0, np.int64)
        return BatchedSimResult(zb, z, z, z, z, z, z, np.zeros((0, 5)), z,
                                z, z, zb, zi)
    n_dev = mb.n_devices
    tp, dp, pp, cp, ep = (batch.tp, batch.dp, batch.pp, batch.cp, batch.ep)
    nm = np.maximum(batch.n_micro, 1)

    ok_dev = batch.n_devices == n_dev
    mappable, intra, inter = map_intra_batch(batch, mb)

    layers_stage = np.maximum(w.n_layers // pp, 1)
    attn_stage = np.maximum(w.n_attn_layers // pp, 1) \
        if w.n_attn_layers else np.zeros(B, np.int64)
    moe_stage = np.maximum(w.n_moe_layers // pp, 1) \
        if w.n_moe_layers else np.zeros(B, np.int64)

    # ---------------- memory capacity ----------------
    demand, local_params = hbm_demand_batch(w, batch)
    mem_ok = demand <= mb.hbm_capacity

    feasible = ok_dev & mappable & mem_ok
    reason = np.full(B, OK, np.int64)
    reason[~mem_ok] = HBM_CAPACITY
    reason[~mappable] = UNMAPPABLE
    reason[~ok_dev] = BAD_DEVICES

    # ---------------- compact to the feasible rows ----------------
    # infeasible points would only produce discarded numbers; the heavy
    # stages run on the survivors and scatter back at the end.
    sel = None if bool(feasible.all()) else np.nonzero(feasible)[0]
    if sel is not None:
        batch = batch.take(sel)
        mb = mb.take(sel)
        tp, dp, pp, cp, ep = (batch.tp, batch.dp, batch.pp, batch.cp,
                              batch.ep)
        nm = nm[sel]
        n_dev = mb.n_devices
        layers_stage = layers_stage[sel]
        attn_stage = attn_stage[sel]
        moe_stage = moe_stage[sel]
        intra, inter = intra[sel], inter[sel]
        local_params = local_params[sel]
    Bs = len(batch)

    def scatter(fill, vals, shape=None):
        if sel is None:
            return vals
        full = np.full(shape or B, fill)
        full[sel] = vals
        return full

    if Bs == 0:
        return BatchedSimResult(
            feasible=feasible, step_time=np.full(B, np.inf),
            throughput=np.zeros(B), mfu=np.zeros(B),
            power=np.full(B, np.inf), t_comp=np.zeros(B),
            t_mem=np.zeros(B), t_coll=np.zeros((B, 5)),
            exposed=np.zeros(B), dp_exposed=np.zeros(B),
            bubble=np.zeros(B), reuse_active=np.zeros(B, bool),
            reason_code=reason)

    # ---------------- compute time ----------------
    flops_dev = w.step_flops() / n_dev
    if hw.model_gemm_eff:
        eff = gemm_eff_batch(w, batch, hw)
        t_comp = flops_dev / (mb.die_flops * hw.mfu_ceiling * eff)
    else:   # eff == 1.0: multiplying the denominator by it is an identity
        t_comp = flops_dev / (mb.die_flops * hw.mfu_ceiling)
    t_comp = np.broadcast_to(np.asarray(t_comp, np.float64), (Bs,))

    # ---------------- traffic + link allocation ----------------
    vols = traffic_volumes_batch(w, batch)
    inter_mask = (inter > 1) & (vols > 0)

    inv = np.empty((Bs, 5))
    inv[:, P_IDX["TP"]] = 8 * layers_stage * nm
    inv[:, P_IDX["DP"]] = 1.0
    inv[:, P_IDX["PP"]] = 2 * nm
    inv[:, P_IDX["CP"]] = 2 * attn_stage * nm
    inv[:, P_IDX["EP"]] = 4 * moe_stage * nm
    hops = np.empty((Bs, 5))
    hops[:, P_IDX["TP"]] = tp - 1
    hops[:, P_IDX["DP"]] = 2 * (dp - 1)
    hops[:, P_IDX["PP"]] = 1.0
    hops[:, P_IDX["CP"]] = cp - 1
    hops[:, P_IDX["EP"]] = np.maximum(
        _ceil_log2_int(np.maximum(ep, 2)), 1)

    reuse_overhead = np.zeros(Bs)
    reuse_active_s = np.zeros(Bs, bool)
    alloc = np.zeros((Bs, 5))
    if alloc_mode not in ("chiplight", "railx"):
        raise ValueError(f"unknown alloc_mode {alloc_mode!r}; "
                         f"use 'chiplight' or 'railx'")
    if fabric == "oi":
        pair_a = np.full(Bs, -1, np.int64)
        pair_b = np.full(Bs, -1, np.int64)
        if reuse:
            pair_a, pair_b = pick_reuse_pairs(vols, inter_mask)
        alloc_rx = None
        if alloc_mode == "railx":
            alloc_rx, pair_shared, _ = allocate_links_railx_batch(
                vols, inter, inter_mask, mb.total_links, pair_a, pair_b,
                hw.ocs_ports)
            # the pair can only share links when railx co-locates it
            pair_a = np.where(pair_shared, pair_a, -1)
            pair_b = np.where(pair_shared, pair_b, -1)
        pair_pre_gate = pair_a >= 0
        if reuse:
            # bank-swap feasibility of flipping the shared links
            gap = t_comp / np.maximum(layers_stage * nm, 1) / 2.0
            if hw.ocs_reuse_mode != "paper":
                with np.errstate(divide="ignore"):
                    ok_swap = (gap > 0) & (np.ceil(
                        hw.ocs_switch_latency_s / np.where(gap > 0, gap, 1.0)
                    ) <= nm)
                pair_a = np.where(ok_swap, pair_a, -1)
                pair_b = np.where(ok_swap, pair_b, -1)
            reuse_active_s = pair_a >= 0
            if hw.ocs_reuse_mode != "paper":
                reuse_overhead = np.where(
                    reuse_active_s, 2.0 * hw.ocs_switch_latency_s / nm, 0.0)
        if alloc_mode == "railx":
            alloc = alloc_rx
            gated = pair_pre_gate & (pair_a < 0)
            if gated.any():
                # mirror simulate(): a topology reuse pair that cannot
                # bank-swap falls back to the traffic-proportional alloc
                none_p = np.full(Bs, -1, np.int64)
                alloc_cl = allocate_links_batch(
                    vols, inter_mask, mb.total_links, none_p, none_p)
                alloc = np.where(gated[:, None], alloc_cl, alloc_rx)
        else:
            alloc = allocate_links_batch(vols, inter_mask, mb.total_links,
                                         pair_a, pair_b)

    # ---------------- cost terms (on the device) ----------------
    a = {"vols": vols, "alloc": alloc, "inv": inv,
         "hops": hops, "intra": intra.astype(np.float64),
         "inter_mask": inter_mask, "t_comp": t_comp,
         "local_params": local_params,
         "layers_stage": layers_stage.astype(np.float64),
         "nm": nm.astype(np.float64), "tp": tp.astype(np.float64),
         "dp": dp.astype(np.float64), "pp": pp.astype(np.float64),
         "cp": cp.astype(np.float64), "reuse_overhead": reuse_overhead,
         "hbm_bw": np.broadcast_to(np.asarray(mb.hbm_bw, np.float64),
                                   (Bs,)),
         "nop_bw": np.broadcast_to(np.asarray(mb.nop_bw, np.float64),
                                   (Bs,)),
         "dies": np.broadcast_to(
             np.asarray(mb.dies_per_mcm, np.float64), (Bs,)),
         "w_scalars": (float(w.bytes_param), float(w.tokens_per_step),
                       float(w.d_model), float(w.bytes_act))}
    with np.errstate(divide="ignore", invalid="ignore"):
        t = _run_terms(a, fabric, hw, device)
        step = t["step"]
        thpt = w.tokens_per_step / step
        mfu = w.step_flops() / step / (mb.die_flops * n_dev)
        util = t_comp / step

    # board power: static + utilisation-scaled dynamic (see DESIGN.md)
    power = n_dev * (DIE_IDLE_W + DIE_DYN_W * util) \
        + n_dev * mb.m * HBM_W_PER_STACK
    if fabric == "oi":
        power = power + mb.n_mcm * mb.total_links * OI_W_PER_LINK
    else:
        power = power + n_dev * NIC_W_PER_DEV

    return BatchedSimResult(
        feasible=feasible,
        step_time=scatter(np.inf, step),
        throughput=scatter(0.0, thpt),
        mfu=scatter(0.0, np.broadcast_to(np.asarray(mfu, np.float64),
                                         (Bs,))),
        power=scatter(np.inf, np.broadcast_to(
            np.asarray(power, np.float64), (Bs,))),
        t_comp=scatter(0.0, t_comp),
        t_mem=scatter(0.0, t["t_mem"]),
        t_coll=scatter(0.0, t["t_coll"], shape=(B, 5)),
        exposed=scatter(0.0, t["exposed"]),
        dp_exposed=scatter(0.0, t["dp_exposed"]),
        bubble=scatter(0.0, t["bubble"]),
        reuse_active=scatter(False, reuse_active_s),
        reason_code=reason)
