"""Analytic step-time simulator (ASTRA-sim replacement, see DESIGN.md).

Per training step we model:
  * compute — FLOPs / (peak * mfu_ceiling * gemm_shape_efficiency), where
    the shape efficiency term M/(M+c) * N/(N+c) captures MXU/tensor-core
    under-utilisation when parallelism slices matmuls thin (tiny per-device
    token counts or TP-sharded widths) — this is what actually stops
    "free" escapes like CP=64 x PP=32 at strong scaling;
  * memory — per-microbatch weight streaming (weights cannot be cached
    across microbatches) + activation traffic, against m * HBM_bw;
  * collectives — per-parallelism ring/A2A alpha-beta terms with
    PER-INVOCATION latency (layer x microbatch), fabric-dependent alpha;
    bandwidth capped by HBM/2 (paper insight 5: every relayed chunk is a
    read + write);
  * exposure — TP/EP serial, CP partially overlapped with attention,
    DP partially overlapped with backward, PP bubble (pp-1)/n_micro;
  * dynamic link reuse (Eq 1) with bank-swap OCS-switch amortisation.

Fabrics: ``nvlink`` (GPU baseline), ``ib`` (chiplet + electrical scale-out),
``oi`` (chiplet + OCS rails — RailX / ChipLight).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.hardware import HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology, allocate_links
from repro_torch.core.traffic import PARALLELISMS, Strategy, traffic_volumes, \
    reusable_pairs
from repro_torch.core.workload import Workload


@dataclass(frozen=True)
class SimResult:
    feasible: bool
    step_time: float = math.inf
    throughput: float = 0.0          # tokens / s
    mfu: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)
    bottleneck: str = "infeasible"
    logs: Dict[str, float] = field(default_factory=dict)
    reason: str = ""


def map_intra(w: Workload, s: Strategy, mcm: MCMArch
              ) -> Optional[Tuple[Dict[str, int], Dict[str, int]]]:
    """Map parallelism groups to intra-MCM HBD vs inter-MCM rails.

    TP always maps intra (Obs 1).  If the MCM is larger than TP, exactly
    one other parallelism (or a hierarchical slice of DP) fills the rest.
    """
    dies = mcm.dies_per_mcm
    if s.tp > dies or dies % s.tp != 0:
        return None
    rem = dies // s.tp
    intra = {"TP": s.tp}
    inter = {"DP": s.dp, "PP": s.pp, "CP": s.cp, "EP": s.ep}
    if rem > 1:
        for p in ("CP", "EP", "PP"):          # exact-fit groups first
            if inter[p] == rem:
                intra[p] = rem
                inter[p] = 1
                rem = 1
                break
    if rem > 1 and inter["DP"] % rem == 0:    # hierarchical DP slice
        intra["DP"] = rem
        inter["DP"] //= rem
        rem = 1
    if rem > 1:
        return None
    return intra, inter


def _gemm_eff(w: Workload, s: Strategy, hw: HW) -> float:
    """Harmonic-blended GEMM shape efficiency (token dim x width dim)."""
    m_tok = w.tokens_per_step / (s.dp * s.cp * max(s.n_micro, 1))
    em = lambda m: m / (m + hw.gemm_m_half)
    en = lambda n: n / (n + hw.gemm_n_half)
    model = w.model
    a = model.attn
    if model.moe is not None:
        moe = model.moe
        m_exp = m_tok * moe.top_k / moe.n_experts
        n_ffn = max(moe.d_ff_expert / s.tp, 1.0)
        eff_ffn = em(m_exp) * en(n_ffn)
        ffn_flops = moe.top_k * 3 * model.d_model * moe.d_ff_expert
    else:
        d_ff = model.d_ff if model.d_ff else 2 * model.d_model
        eff_ffn = em(m_tok) * en(max(d_ff / s.tp, 1.0))
        ffn_flops = 3 * model.d_model * d_ff
    if a is not None:
        other_w = max(a.n_heads * a.head_dim / s.tp, 1.0)
        other_flops = model._attn_params()
    else:
        other_w = max(2 * model.d_model / s.tp, 1.0)
        other_flops = model._ssm_params() if model.ssm else \
            2 * model.d_model * model.d_model
    eff_other = em(m_tok) * en(other_w)
    f = ffn_flops / max(ffn_flops + other_flops, 1.0)
    return 1.0 / (f / max(eff_ffn, 1e-3)
                  + (1 - f) / max(eff_other, 1e-3))


def _bank_swap_reuse_ok(gap: float, n_micro: int, hw: HW) -> bool:
    if gap <= 0:
        return False
    return math.ceil(hw.ocs_switch_latency_s / gap) <= max(n_micro, 1)


def simulate(w: Workload, s: Strategy, mcm: MCMArch, fabric: str = "oi",
             topo: Optional[OITopology] = None, reuse: bool = True,
             hw: Optional[HW] = None) -> SimResult:
    hw = hw or mcm.hw
    n_dev = mcm.n_devices
    if s.n_devices != n_dev:
        return SimResult(False, reason=f"strategy devices {s.n_devices} "
                                       f"!= cluster {n_dev}")
    mapping = map_intra(w, s, mcm)
    if mapping is None:
        return SimResult(False, reason="unmappable intra-MCM packing")
    intra, inter = mapping

    layers_stage = max(w.n_layers // s.pp, 1)
    attn_stage = max(w.n_attn_layers // s.pp, 1) if w.n_attn_layers else 0
    moe_stage = max(w.n_moe_layers // s.pp, 1) if w.n_moe_layers else 0
    n_micro = max(s.n_micro, 1)

    # ---------------- memory capacity ----------------
    local_params = (w.nonexpert_params / (s.tp * s.pp)
                    + w.expert_params / (s.tp * s.pp * s.ep))
    mem_bytes = local_params * (2 + 2) + local_params * 12 / s.dp
    tokens_micro = w.tokens_per_step / (s.dp * s.cp * n_micro)
    act_bytes = (tokens_micro * w.d_model * w.bytes_act / s.tp
                 * layers_stage * 2 * min(s.pp, n_micro))
    cap = mcm.hbm_capacity
    if mem_bytes + act_bytes > cap:
        return SimResult(False, reason=(
            f"HBM capacity: need {(mem_bytes + act_bytes) / 1e9:.1f} GB "
            f"> {cap / 1e9:.1f} GB"))

    # ---------------- compute & memory time ----------------
    flops_dev = w.step_flops() / n_dev
    eff = _gemm_eff(w, s, hw) if hw.model_gemm_eff else 1.0
    t_comp = flops_dev / (mcm.die_flops * hw.mfu_ceiling * eff)
    hbm_stream = (local_params * w.bytes_param * 2.0 * n_micro   # streaming
                  + local_params * 16.0                          # opt update
                  + 12.0 * w.tokens_per_step / (s.dp * s.cp * s.tp)
                  * w.d_model * w.bytes_act * layers_stage)
    t_mem = hbm_stream / mcm.hbm_bw

    # ---------------- collective times ----------------
    vols = traffic_volumes(w, s)
    hbm_cap_bw = mcm.hbm_bw / 2.0          # insight 5: relay = read+write
    alpha = {"nvlink": hw.lat_ib_s, "ib": hw.lat_ib_s, "oi": hw.lat_oi_s}
    # per-invocation counts and hops per invocation, per parallelism
    inv = {"TP": 8 * layers_stage * n_micro,
           "CP": 2 * attn_stage * n_micro,
           "EP": 4 * moe_stage * n_micro,
           "DP": 1,
           "PP": 2 * n_micro}
    hops = {"TP": s.tp - 1, "CP": s.cp - 1,
            "EP": max(int(math.ceil(math.log2(max(s.ep, 2)))), 1),
            "DP": 2 * (s.dp - 1), "PP": 1}

    t_coll: Dict[str, float] = {}

    def add_lat(p: str, a_s: float):
        if s.degree(p) > 1:
            t_coll[p] = t_coll.get(p, 0.0) + inv[p] * hops[p] * a_s

    inter_vols = {p: vols[p] for p in PARALLELISMS
                  if inter.get(p, 1) > 1 and vols[p] > 0}

    for p, deg in intra.items():
        if deg <= 1 or vols[p] == 0:
            continue
        bw = hw.nvlink_bw if fabric == "nvlink" else mcm.intra_ring_bw(deg)
        bw = min(bw * hw.fabric_eff_elec if fabric == "nvlink" else bw,
                 hbm_cap_bw)
        t_coll[p] = vols[p] / bw
        add_lat(p, hw.lat_intra_s)

    reuse_pair = None
    reuse_cand = None              # pre-gate candidate (why-logs below)
    reuse_gated = False            # bank-swap gate disabled the candidate
    reuse_overhead = 0.0
    if fabric in ("ib", "nvlink"):
        shared = sum(inter_vols.values())
        if shared:
            t_sh = shared / min(hw.ib_bw * hw.fabric_eff_elec, hbm_cap_bw)
            for p, v in inter_vols.items():
                t_coll[p] = t_coll.get(p, 0.0) + t_sh * v / shared
                add_lat(p, hw.lat_ib_s)
    elif fabric == "oi":
        if topo is not None:
            alloc = dict(topo.link_alloc)
            reuse_pair = topo.reuse_pair
        else:
            reuse_pair = None
            if reuse:
                pairs = [pr for pr in reusable_pairs(w, s)
                         if pr[0] in inter_vols and pr[1] in inter_vols]
                reuse_pair = pairs[0] if pairs else None
            alloc = allocate_links(inter_vols, mcm.total_links, reuse_pair)
        reuse_cand = reuse_pair
        if reuse_pair is not None:
            gap = t_comp / max(layers_stage * n_micro, 1) / 2.0
            if hw.ocs_reuse_mode == "paper":
                pass   # switching hidden per the paper's assertion
            elif not _bank_swap_reuse_ok(gap, n_micro, hw):
                reuse_pair = None
                reuse_gated = True
                alloc = allocate_links(inter_vols, mcm.total_links, None)
            else:
                reuse_overhead = 2.0 * hw.ocs_switch_latency_s / n_micro
        for p, v in inter_vols.items():
            links = max(alloc.get(p, 1), 1)
            # links are an MCM resource; the dies of the package share them
            bw = min(links * hw.oi_link_bw * hw.fabric_eff_oi
                     / mcm.dies_per_mcm, hbm_cap_bw)
            t_coll[p] = t_coll.get(p, 0.0) + v / bw
            add_lat(p, hw.lat_oi_s)
    else:
        raise ValueError(fabric)

    # ---------------- exposure / overlap ----------------
    t_attn = t_comp * 0.3
    exposed = t_coll.get("TP", 0.0)
    exposed += max(0.0, t_coll.get("CP", 0.0)
                   - t_attn * hw.cp_overlap_frac)
    exposed += t_coll.get("EP", 0.0)
    exposed += t_coll.get("PP", 0.0)
    t_dp = t_coll.get("DP", 0.0)
    dp_exposed = max(0.0, t_dp - (2.0 / 3.0) * t_comp
                     * hw.dp_overlap_frac)

    bubble = (s.pp - 1) / n_micro
    body = max(t_comp, t_mem) + exposed
    step = body * (1.0 + bubble) + dp_exposed + reuse_overhead

    thpt = w.tokens_per_step / step
    mfu = w.step_flops() / step / (mcm.die_flops * n_dev)

    terms = {"compute": t_comp, "memory": t_mem, **{
        f"coll_{p}": t for p, t in t_coll.items()}}
    bottleneck = max(terms, key=terms.get)
    # reuse-decision provenance (all floats: P_ORDER index or -1) — lets
    # the event engine / analytic model be diffed on WHY they disagree
    # about link reuse, not just by how much.
    pidx = lambda pr, j: float(PARALLELISMS.index(pr[j])) if pr else -1.0
    logs = {
        "compute_util": t_comp / step,
        "gemm_eff": eff,
        "mem_pressure": (mem_bytes + act_bytes) / cap,
        "exposed_comm": exposed + dp_exposed,
        "bubble": bubble,
        "reuse_active": float(reuse_pair is not None),
        "reuse_cand_a": pidx(reuse_cand, 0),
        "reuse_cand_b": pidx(reuse_cand, 1),
        "reuse_pair_a": pidx(reuse_pair, 0),
        "reuse_pair_b": pidx(reuse_pair, 1),
        "reuse_gated": float(reuse_gated),
        "reuse_paper_mode": float(hw.ocs_reuse_mode == "paper"),
        "nop_bound": float(any(p in intra and t_coll.get(p, 0) > t_comp
                               for p in PARALLELISMS)),
        "oi_bound": float(fabric == "oi" and exposed + dp_exposed
                          > 0.3 * step),
        "hbm_bw_bound": float(t_mem > t_comp),
    }
    return SimResult(True, step_time=step, throughput=thpt, mfu=mfu,
                     breakdown=terms, bottleneck=bottleneck, logs=logs)
