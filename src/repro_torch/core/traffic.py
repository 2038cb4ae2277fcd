"""Per-parallelism training-traffic model (paper §III, Fig 3/4).

Volumes are BYTES PER DEVICE PER TRAINING STEP under ring collectives,
matching the paper's ASTRA-sim profiling setup (ring algorithm, hybrid
TP/DP/PP/CP/EP).  The spatial matrix (Fig 4) and the temporal phase tags
(§III-B, link-reuse feasibility) derive from the same projection — the
traffic projection is *independent of the underlying network*, which is
what enables the paper's parallel-centric inner search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.workload import Workload

PARALLELISMS = ("TP", "DP", "PP", "CP", "EP")

# temporal phase in which each parallelism communicates (§III-B):
#   CP traffic happens inside attention, EP inside the FFN/expert block,
#   TP throughout the layer, DP at step boundary (bwd), PP at stage edges.
PHASE = {"TP": "layer", "CP": "attention", "EP": "ffn", "DP": "step",
         "PP": "stage"}


@dataclass(frozen=True)
class Strategy:
    tp: int = 1
    dp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    n_micro: int = 8

    @property
    def n_devices(self) -> int:
        return self.tp * self.dp * self.pp * self.cp * self.ep

    def degree(self, p: str) -> int:
        return {"TP": self.tp, "DP": self.dp, "PP": self.pp,
                "CP": self.cp, "EP": self.ep}[p]

    def asdict(self):
        return {"TP": self.tp, "DP": self.dp, "PP": self.pp,
                "CP": self.cp, "EP": self.ep}


def traffic_volumes(w: Workload, s: Strategy) -> Dict[str, float]:
    """Bytes per device per step for each parallelism (ring collectives)."""
    v = {p: 0.0 for p in PARALLELISMS}
    layers_per_stage = max(w.n_layers // s.pp, 1)
    attn_per_stage = max(w.n_attn_layers // s.pp, 1) \
        if w.n_attn_layers else 0
    moe_per_stage = max(w.n_moe_layers // s.pp, 1) if w.n_moe_layers else 0
    # tokens a device's stage processes per step
    t_stage = w.tokens_per_step / (s.dp * s.cp)
    act = t_stage * w.d_model * w.bytes_act

    # --- TP: Megatron w/ sequence-parallel: 4 AG + 4 RS per layer (f+b);
    # ring AG/RS of a tensor of ``act`` bytes moves act*(t-1)/t per device.
    if s.tp > 1:
        v["TP"] = 8.0 * layers_per_stage * act * (s.tp - 1) / s.tp

    # --- CP: ring attention; K and V shards circulate (c-1) hops (f),
    # gradient ring mirrors it in bwd (x2).  KV heads shard at most
    # n_kv_heads ways under TP (GQA: beyond that KV is replicated), so the
    # per-device share divides by min(tp, n_kv_heads).
    if s.cp > 1 and attn_per_stage:
        kv_shard = min(s.tp, w.model.attn.n_kv_heads) if w.model.attn \
            else s.tp
        kv = t_stage * w.kv_bytes_per_token / kv_shard
        v["CP"] = 2.0 * attn_per_stage * (s.cp - 1) * kv

    # --- EP: A2A dispatch+combine (x2), fwd+bwd (x2); activations enter
    # the MoE block sequence-parallel over TP (1/tp share per device).
    if s.ep > 1 and moe_per_stage:
        topk = w.model.moe.top_k
        v["EP"] = (4.0 * moe_per_stage * (t_stage / s.tp) * topk
                   * w.d_model * w.bytes_act * (s.ep - 1) / s.ep)

    # --- DP: ring all-reduce of local gradients = 2*(d-1)/d * local params.
    if s.dp > 1:
        local = (w.nonexpert_params / (s.tp * s.pp)
                 + w.expert_params / (s.tp * s.pp * s.ep))
        v["DP"] = 2.0 * local * w.bytes_grad * (s.dp - 1) / s.dp

    # --- PP: activations fwd + grads bwd across each stage boundary
    # (sequence-parallel shards under TP).
    if s.pp > 1:
        v["PP"] = 2.0 * (t_stage / s.tp) * w.d_model * w.bytes_act

    return v


# ---------------------------------------------------------------------------
# Spatial distribution (Fig 4)
# ---------------------------------------------------------------------------
def device_coords(s: Strategy, order=("TP", "CP", "EP", "PP", "DP")):
    """Device id <-> parallel-group coordinates, TP fastest by default."""
    dims = [s.degree(p) for p in order]
    return order, dims


def coords_matrix(s: Strategy, order=("TP", "CP", "EP", "PP", "DP")):
    """(order, dims, strides, (n, len(order)) coordinate matrix) — the
    device-id <-> group-coordinate bijection, fully vectorized."""
    order, dims = device_coords(s, order)
    n = s.n_devices
    strides = np.cumprod([1] + dims[:-1]).astype(np.int64)
    ids = np.arange(n, dtype=np.int64)
    coords = (ids[:, None] // strides[None, :]) % np.asarray(dims, np.int64)
    return order, dims, strides, coords


def traffic_matrix(w: Workload, s: Strategy,
                   order=("TP", "CP", "EP", "PP", "DP"),
                   ep_fc: bool = False) -> np.ndarray:
    """(n, n) bytes sent src->dst per step; ring neighbours only (Fig 4).

    ep_fc: model EP A2A as fully-connected (uniform to all peers) instead
    of a ring — the paper's FC option for EP.

    Fully vectorized: destination ids come from index arithmetic on the
    coordinate matrix (``dst = src + (next - cur) * stride``), one
    ``np.add.at`` scatter per parallelism — no per-device Python.  The
    original nested-loop construction is kept as
    ``_traffic_matrix_loop`` (parity-tested reference).
    """
    n = s.n_devices
    vols = traffic_volumes(w, s)
    mat = np.zeros((n, n))
    order, dims, strides, coords = coords_matrix(s, order)
    src = np.arange(n, dtype=np.int64)

    for pi, p in enumerate(order):
        deg = dims[pi]
        if deg <= 1 or vols[p] == 0.0:
            continue
        cur = coords[:, pi]
        if p == "EP" and ep_fc:
            # uniform A2A: each device sends v/(deg-1) to each peer —
            # dst ids for ALL (src, peer) pairs in one (n, deg) array
            peers = np.arange(deg, dtype=np.int64)
            dst = src[:, None] + (peers[None, :] - cur[:, None]) \
                * strides[pi]
            keep = peers[None, :] != cur[:, None]
            np.add.at(mat, (np.broadcast_to(src[:, None], dst.shape)[keep],
                            dst[keep]), vols[p] / (deg - 1))
            continue
        # ring: all traffic to the next neighbour in the group
        dst = src + (((cur + 1) % deg) - cur) * strides[pi]
        np.add.at(mat, (src, dst), vols[p])
    return mat


def _traffic_matrix_loop(w: Workload, s: Strategy,
                         order=("TP", "CP", "EP", "PP", "DP"),
                         ep_fc: bool = False) -> np.ndarray:
    """Reference nested-loop construction of ``traffic_matrix`` (the
    pre-vectorization implementation) — kept for parity tests only."""
    n = s.n_devices
    vols = traffic_volumes(w, s)
    mat = np.zeros((n, n))
    order, dims = device_coords(s, order)
    strides = np.cumprod([1] + dims[:-1])
    coords = np.zeros((n, len(dims)), dtype=np.int64)
    rem = np.arange(n)
    for i, (d, st) in enumerate(zip(dims, strides)):
        coords[:, i] = (rem // st) % d

    for pi, p in enumerate(order):
        deg = dims[pi]
        if deg <= 1 or vols[p] == 0.0:
            continue
        if p == "EP" and ep_fc:
            per_peer = vols[p] / (deg - 1)
            for src in range(n):
                base = coords[src].copy()
                for t in range(deg):
                    if t == coords[src, pi]:
                        continue
                    dst_c = base.copy()
                    dst_c[pi] = t
                    dst = int(np.dot(dst_c, strides))
                    mat[src, dst] += per_peer
            continue
        for src in range(n):
            dst_c = coords[src].copy()
            dst_c[pi] = (dst_c[pi] + 1) % deg
            dst = int(np.dot(dst_c, strides))
            mat[src, dst] += vols[p]
    return mat


# ---------------------------------------------------------------------------
# Temporal phases (§III-B) — who can share links with whom
# ---------------------------------------------------------------------------
def reusable_pairs(w: Workload, s: Strategy):
    """Parallelism pairs whose traffic is temporally disjoint.

    The paper's primary pair is (CP, EP): CP communicates during attention,
    EP during the expert FFN, separated by output-proj / layernorm compute.
    Reuse also exists among CP/DP/PP (paper notes it but deems CP-EP most
    beneficial).  Pairs are returned most-beneficial-first.
    """
    vols = traffic_volumes(w, s)
    cand = []
    for a, b in (("CP", "EP"), ("CP", "DP"), ("EP", "DP"), ("PP", "DP")):
        if vols[a] > 0 and vols[b] > 0 and PHASE[a] != PHASE[b]:
            cand.append(((a, b), min(vols[a], vols[b])))
    cand.sort(key=lambda kv: -kv[1])
    return [p for p, _ in cand]
