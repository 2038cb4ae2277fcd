"""Vectorized record->program compilation for batch replay.

``compile_batch`` is the SoA counterpart of ``events.dag.compile_step``:
it turns K design points — (strategies, MCM parameters, fabric, optional
per-row ``OITopology``) — into the (6, K) ``ROW_KEYS`` matrix that
``events.batch.replay_rows`` consumes, without building K ``StepProgram``
task DAGs or running K scalar ``simulate`` calls.  All unit costs are
(K,) arrays produced by the SAME vectorized pieces the batched analytic
simulator uses (``dse.batched_sim``: traffic volumes, intra/inter
mapping, GEMM efficiency, link allocation, reuse-pair selection and the
bank-swap gate, ``_terms_core`` for the embedded analytic step), and the
node spans come from the closed form of the compiled node template's
longest path.  For BOTH directions the template's task chain reduces to

    span_d = sh*U_TP + ffn_d + join_d + sh*U_EP + (0.5/nm)*U_PP

with ``sh = 0.5 / (n_micro * v)``, ``U_p`` the per-parallelism serial
cost (launch latency + bytes at the steady-state rail rate, summed over
its intra/inter segments) and ``join_d`` the attention/CP overlap join
``max(attn_d, max(attn_d - credit_d, 0) + sh*U_CP)``; the DP all-reduce
cost is ``U_DP`` at share 1.  Parity with the per-record
``compile_step(...).spans()`` walk is pinned at 1e-9 in
tests/test_events.py and watched statically by the
``compile_step~compile_batch`` pair in ``analysis.parity``.

Feasibility differs by construction: ``compile_step`` raises on an
infeasible point, the batch marks the row in ``CompiledBatch.feasible``
(rows are NaN there) and ``CompiledBatch.replay`` scatters ``inf`` step
times back.  This is what lets the event engine sit INSIDE the search
loop (``Study.run``'s ``study.event_rerank`` stage, the outer search's
per-round replay) instead of validating after it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.hardware import HW
from repro_torch.core.mcm import MCMArch
from repro_torch.core.network import OITopology
from repro_torch.core.traffic import Strategy
from repro_torch.core.workload import Workload
from repro_torch.dse.batched_sim import (MCMBatch, _ceil_log2_int, _mcm_params,
                                   _run_terms, allocate_links_batch,
                                   gemm_eff_batch, hbm_demand_batch,
                                   map_intra_batch, pick_reuse_pairs,
                                   traffic_volumes_batch)
from repro_torch.dse.space import P_IDX, StrategyBatch
from repro_torch.events.batch import replay_rows
from repro_torch.events.dag import SCHEDULES
from repro_torch.models.common import check_device
from repro_torch.obs import metrics


@dataclass(frozen=True)
class CompiledBatch:
    """K records compiled for batch replay (see module docstring).

    ``rows`` is the (6, K) ``kernels.wavefront.ROW_KEYS`` matrix (tau_f,
    tau_b, t_dp, credit, nmv, analytic step time); ``shape_keys`` the
    unique (schedule, pp, v, n_micro) wavefront keys of the FEASIBLE
    rows and ``key_rows`` the per-record index into it (-1 where
    infeasible).  ``v`` is the per-row clamped interleave depth."""

    schedule: str
    rows: np.ndarray                  # (6, K) float64, NaN if infeasible
    shape_keys: List[Tuple[str, int, int, int]]
    key_rows: np.ndarray              # (K,) int64, -1 if infeasible
    feasible: np.ndarray              # (K,) bool
    v: np.ndarray                     # (K,) int64

    def __len__(self) -> int:
        return int(self.feasible.shape[0])

    @property
    def analytic_step_time(self) -> np.ndarray:
        return self.rows[5]

    def take(self, idx) -> "CompiledBatch":
        idx = np.asarray(idx)
        return CompiledBatch(self.schedule, self.rows[:, idx],
                             self.shape_keys, self.key_rows[idx],
                             self.feasible[idx], self.v[idx])

    def replay(self, device="cuda") -> Dict[str, np.ndarray]:
        """Run the wavefront on the feasible rows, on ``device``, and
        scatter back: same result keys as ``replay_batch``, with
        ``step_time = inf`` and NaN diagnostics on infeasible rows."""
        K = len(self)
        out: Dict[str, np.ndarray] = {
            k: np.full(K, np.nan) for k in
            ("makespan_body", "bubble", "dp_exposed",
             "analytic_step_time", "err")}
        out["step_time"] = np.full(K, np.inf)
        out["scalar_fallback"] = np.zeros(K, bool)
        sel = np.nonzero(self.feasible)[0]
        if sel.size:
            res = replay_rows(self.shape_keys, self.key_rows[sel],
                              np.ascontiguousarray(self.rows[:, sel]),
                              device=device)
            for k in out:
                out[k][sel] = res[k]
        return out


def _compile_group(w: Workload, batch: StrategyBatch, mb: MCMBatch,
                   fabric: str, hw: HW, reuse: bool, schedule: str,
                   virtual_chunks: Optional[int],
                   topos: Optional[Sequence[Optional[OITopology]]],
                   device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One homogeneous (fabric, hw) group -> (rows (6, B), feasible,
    v).  Every expression mirrors ``compile_step`` (and through it
    ``simulate``) operation-for-operation; see the parity pin."""
    B = len(batch)
    tp, dp, pp, cp, ep = batch.tp, batch.dp, batch.pp, batch.cp, batch.ep
    nm = np.maximum(batch.n_micro, 1)

    ok_dev = batch.n_devices == mb.n_devices
    mappable, intra, inter = map_intra_batch(batch, mb)
    demand, local_params = hbm_demand_batch(w, batch)
    mem_ok = demand <= mb.hbm_capacity
    feasible = ok_dev & mappable & mem_ok

    layers_stage = np.maximum(w.n_layers // pp, 1)
    attn_stage = np.maximum(w.n_attn_layers // pp, 1) \
        if w.n_attn_layers else np.zeros(B, np.int64)
    moe_stage = np.maximum(w.n_moe_layers // pp, 1) \
        if w.n_moe_layers else np.zeros(B, np.int64)

    # ---- interleave depth (per-row clamp, identical to compile_step) --
    if schedule == "interleaved":
        base = virtual_chunks if virtual_chunks is not None else 2
        v = np.maximum(1, np.minimum(base, np.minimum(layers_stage, nm))
                       ).astype(np.int64)
    else:
        v = np.ones(B, np.int64)

    with np.errstate(divide="ignore", invalid="ignore"):
        # ---- unit costs (identical to simulate()) ----------------------
        flops_dev = w.step_flops() / mb.n_devices
        if hw.model_gemm_eff:
            eff = gemm_eff_batch(w, batch, hw)
            t_comp = flops_dev / (mb.die_flops * hw.mfu_ceiling * eff)
        else:
            t_comp = flops_dev / (mb.die_flops * hw.mfu_ceiling)
        t_comp = np.broadcast_to(np.asarray(t_comp, np.float64), (B,))
        hbm_stream = (local_params * w.bytes_param * 2.0 * nm
                      + local_params * 16.0
                      + 12.0 * w.tokens_per_step / (dp * cp * tp)
                      * w.d_model * w.bytes_act * layers_stage)
        t_mem = hbm_stream / mb.hbm_bw
        tile = np.maximum(t_comp, t_mem)

        vols = traffic_volumes_batch(w, batch)
        inter_mask = (inter > 1) & (vols > 0)

        # invocation counts / hops — simulate()'s latency model
        inv = np.empty((B, 5))
        inv[:, P_IDX["TP"]] = 8 * layers_stage * nm
        inv[:, P_IDX["DP"]] = 1.0
        inv[:, P_IDX["PP"]] = 2 * nm
        inv[:, P_IDX["CP"]] = 2 * attn_stage * nm
        inv[:, P_IDX["EP"]] = 4 * moe_stage * nm
        hops = np.empty((B, 5))
        hops[:, P_IDX["TP"]] = tp - 1
        hops[:, P_IDX["DP"]] = 2 * (dp - 1)
        hops[:, P_IDX["PP"]] = 1.0
        hops[:, P_IDX["CP"]] = cp - 1
        hops[:, P_IDX["EP"]] = np.maximum(
            _ceil_log2_int(np.maximum(ep, 2)), 1)

        # ---- reuse decision + link allocation --------------------------
        # replicates simulate()'s dynamic-reuse block; per-row topologies
        # override the pair/alloc exactly like compile_step's topo branch
        alloc = np.zeros((B, 5))
        reuse_overhead = np.zeros(B)
        reuse_active = np.zeros(B, bool)
        pair_a = np.full(B, -1, np.int64)
        pair_b = np.full(B, -1, np.int64)
        if fabric == "oi":
            has_topo = np.zeros(B, bool)
            topo_alloc = np.zeros((B, 5))
            if topos is not None:
                for i, t in enumerate(topos):
                    if t is None:
                        continue
                    has_topo[i] = True
                    for p, links in t.link_alloc.items():
                        topo_alloc[i, P_IDX[p]] = links
                    if t.reuse_pair is not None:
                        pair_a[i] = P_IDX[t.reuse_pair[0]]
                        pair_b[i] = P_IDX[t.reuse_pair[1]]
            if reuse:
                pa, pb = pick_reuse_pairs(vols, inter_mask)
                pair_a = np.where(has_topo, pair_a, pa)
                pair_b = np.where(has_topo, pair_b, pb)
            pre_gate = pair_a >= 0
            if hw.ocs_reuse_mode != "paper":
                # bank-swap feasibility of flipping the shared links
                gap = t_comp / np.maximum(layers_stage * nm, 1) / 2.0
                ok_swap = (gap > 0) & (np.ceil(
                    hw.ocs_switch_latency_s / np.where(gap > 0, gap, 1.0)
                ) <= nm)
                pair_a = np.where(ok_swap, pair_a, -1)
                pair_b = np.where(ok_swap, pair_b, -1)
            reuse_active = pair_a >= 0
            if hw.ocs_reuse_mode != "paper":
                reuse_overhead = np.where(
                    reuse_active, 2.0 * hw.ocs_switch_latency_s / nm, 0.0)
            # ONE allocator call covers both populations: non-topo rows
            # use their post-gate pair (equivalent to the scalar
            # pick -> alloc -> gate -> realloc order), topo rows the
            # no-pair alloc — which is exactly the fallback a GATED topo
            # row needs; un-gated topo rows keep their topology's alloc.
            alloc = allocate_links_batch(
                vols, inter_mask, mb.total_links,
                np.where(has_topo, -1, pair_a),
                np.where(has_topo, -1, pair_b))
            keep_topo = has_topo & ~(pre_gate & ~reuse_active)
            alloc = np.where(keep_topo[:, None], topo_alloc, alloc)

        # ---- per-parallelism serial comm cost U_p ----------------------
        # U_p = sum over p's segments of (inv*hops*alpha + bytes/rate)
        # at share 1; the rate is the steady-state fair share
        # min(rail_capacity / mult, hbm_relay) of StepProgram.steady_rate
        relay = np.broadcast_to(
            np.asarray(mb.hbm_bw, np.float64) / 2.0, (B,))
        intra_active = (intra > 1) & (vols > 0)
        U = np.zeros((B, 5))
        if fabric == "nvlink":
            rate_i = np.minimum(hw.nvlink_bw * hw.fabric_eff_elec,
                                relay)[:, None]
        else:
            dil = np.maximum(1.0, np.sqrt(intra.astype(np.float64)) / 2.0)
            nop = np.broadcast_to(np.asarray(mb.nop_bw, np.float64), (B,))
            rate_i = np.minimum(nop[:, None] / dil, relay[:, None])
        U += np.where(intra_active,
                      inv * hops * hw.lat_intra_s + vols / rate_i, 0.0)
        if fabric in ("ib", "nvlink"):
            rate_x = np.minimum(hw.ib_bw * hw.fabric_eff_elec,
                                relay)[:, None]
            U += np.where(inter_mask,
                          inv * hops * hw.lat_ib_s + vols / rate_x, 0.0)
        else:
            links = np.maximum(alloc, 1.0)
            # the (CP, EP) pair time-divides ONE rail whose capacity is
            # written by the last member in P_ORDER (EP) — mirror that
            is_cpep = reuse_active & (pair_a == P_IDX["CP"]) \
                & (pair_b == P_IDX["EP"])
            links[:, P_IDX["CP"]] = np.where(
                is_cpep, links[:, P_IDX["EP"]], links[:, P_IDX["CP"]])
            dies = np.broadcast_to(
                np.asarray(mb.dies_per_mcm, np.float64), (B,))
            rate_x = np.minimum(
                links * hw.oi_link_bw * hw.fabric_eff_oi / dies[:, None],
                relay[:, None])
            U += np.where(inter_mask,
                          inv * hops * hw.lat_oi_s + vols / rate_x, 0.0)

        # ---- closed-form node spans (see module docstring) -------------
        nmv = (nm * v).astype(np.float64)
        nm_f = nm.astype(np.float64)
        u_tp = U[:, P_IDX["TP"]]
        u_cp = U[:, P_IDX["CP"]]
        u_ep = U[:, P_IDX["EP"]]
        u_pp = U[:, P_IDX["PP"]]
        has_cp = (cp > 1) & (vols[:, P_IDX["CP"]] > 0)

        def node_span(dirfrac: float) -> np.ndarray:
            node_tile = tile * dirfrac / nmv
            sh = 0.5 / nmv           # fwd/bwd halves of per-layer comm
            credit = 0.3 * t_comp * hw.cp_overlap_frac * dirfrac / nmv
            attn = 0.3 * node_tile
            ffn = np.where(has_cp, 0.7, 1.0) * node_tile
            join = np.where(
                has_cp,
                np.maximum(attn,
                           np.maximum(attn - credit, 0.0) + sh * u_cp),
                0.0)
            return sh * u_tp + ffn + join + sh * u_ep \
                + (0.5 / nm_f) * u_pp

        tau_f = node_span(1.0 / 3.0)
        tau_b = node_span(2.0 / 3.0)

        has_dp = (dp > 1) & (vols[:, P_IDX["DP"]] > 0)
        t_dp = np.where(has_dp, U[:, P_IDX["DP"]], 0.0)
        dp_overlap = np.where(
            has_dp, (2.0 / 3.0) * t_comp * hw.dp_overlap_frac, 0.0)

        # ---- embedded analytic step (simulate() parity) ----------------
        a = {"vols": vols, "alloc": alloc, "inv": inv,
             "hops": hops, "intra": intra.astype(np.float64),
             "inter_mask": inter_mask, "t_comp": t_comp,
             "local_params": local_params,
             "layers_stage": layers_stage.astype(np.float64),
             "nm": nm.astype(np.float64), "tp": tp.astype(np.float64),
             "dp": dp.astype(np.float64), "pp": pp.astype(np.float64),
             "cp": cp.astype(np.float64),
             "reuse_overhead": reuse_overhead,
             "hbm_bw": np.broadcast_to(
                 np.asarray(mb.hbm_bw, np.float64), (B,)),
             "nop_bw": np.broadcast_to(
                 np.asarray(mb.nop_bw, np.float64), (B,)),
             "dies": np.broadcast_to(
                 np.asarray(mb.dies_per_mcm, np.float64), (B,)),
             "w_scalars": (float(w.bytes_param), float(w.tokens_per_step),
                           float(w.d_model), float(w.bytes_act))}
        analytic = _run_terms(a, fabric, hw, device)["step"]

    rows = np.empty((6, B))
    rows[0] = tau_f
    rows[1] = tau_b
    rows[2] = t_dp
    rows[3] = dp_overlap
    rows[4] = nmv
    rows[5] = analytic
    rows[:, ~feasible] = np.nan
    return rows, feasible, v


def compile_batch(w: Workload,
                  strategies: Union[StrategyBatch, Sequence[Strategy]],
                  mcm: Union[MCMArch, MCMBatch, Sequence[MCMArch]],
                  fabric: Union[str, Sequence[str]] = "oi", *,
                  topos: Optional[Sequence[Optional[OITopology]]] = None,
                  reuse: bool = True, hw: Optional[HW] = None,
                  schedule: str = "1f1b",
                  virtual_chunks: Optional[int] = None,
                  device="cuda") -> CompiledBatch:
    """Compile K design points into replay rows under ONE schedule.

    ``strategies`` is a ``StrategyBatch`` or a ``Strategy`` sequence;
    ``mcm`` an ``MCMArch`` (homogeneous batch), an ``MCMBatch`` (an
    explicit ``hw`` is then required) or a per-row ``MCMArch`` sequence;
    ``fabric`` a string or a per-row sequence; ``topos`` an optional
    per-row sequence of derived ``OITopology`` (None entries = derive
    the allocation, like ``compile_step``).  Rows are grouped by
    (fabric, hw) internally — at most a handful of vectorized passes.
    The embedded analytic step's cost terms run on ``device``."""
    device = check_device(device)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"known: {list(SCHEDULES)}")
    batch = strategies if isinstance(strategies, StrategyBatch) \
        else StrategyBatch.from_strategies(list(strategies))
    K = len(batch)
    if topos is not None and len(topos) != K:
        raise ValueError(f"topos has {len(topos)} entries for {K} records")

    if isinstance(mcm, MCMBatch):
        if hw is None:
            raise ValueError("pass hw= explicitly with an MCMBatch")
        mcm_mode = "batch"
        hw_row: List[HW] = [hw] * K
    elif isinstance(mcm, MCMArch):
        mcm_mode = "single"
        hw_row = [hw or mcm.hw] * K
    else:
        mcm = list(mcm)
        if len(mcm) != K:
            raise ValueError(f"mcm has {len(mcm)} entries for {K} records")
        mcm_mode = "list"
        hw_row = [hw or m.hw for m in mcm]

    if isinstance(fabric, str):
        fab_row = [fabric] * K
    else:
        fab_row = list(fabric)
        if len(fab_row) != K:
            raise ValueError(
                f"fabric has {len(fab_row)} entries for {K} records")

    metrics.inc("compile_batch.records", K)
    rows = np.full((6, K), np.nan)
    feasible = np.zeros(K, bool)
    v_arr = np.ones(K, np.int64)
    # group key by identity: HW is frozen/hashable but hashing one per
    # row is measurable at bench sizes; equal-but-distinct HW objects
    # just split into equivalent groups
    groups: Dict[Tuple, List[int]] = {}
    for i in range(K):
        groups.setdefault((fab_row[i], id(hw_row[i])), []).append(i)
    for (fab, _hid), members in groups.items():
        ghw = hw_row[members[0]]
        idx = np.asarray(members, np.int64)
        gb = batch.take(idx)
        if mcm_mode == "batch":
            mb = mcm.take(idx)
        elif mcm_mode == "single":
            mb = _mcm_params(mcm)
        else:
            mb = MCMBatch.from_mcms(mcm, idx)
        gtopos = [topos[i] for i in idx] if topos is not None else None
        grows, gfeas, gv = _compile_group(
            w, gb, mb, fab, ghw, reuse, schedule, virtual_chunks, gtopos,
            device)
        rows[:, idx] = grows
        feasible[idx] = gfeas
        v_arr[idx] = gv

    key_of: Dict[Tuple, int] = {}
    key_rows = np.full(K, -1, np.int64)
    nmc = np.maximum(batch.n_micro, 1)
    for i in np.nonzero(feasible)[0]:
        key = (schedule, int(batch.pp[i]), int(v_arr[i]), int(nmc[i]))
        key_rows[i] = key_of.setdefault(key, len(key_of))
    return CompiledBatch(schedule=schedule, rows=rows,
                         shape_keys=list(key_of), key_rows=key_rows,
                         feasible=feasible, v=v_arr)
