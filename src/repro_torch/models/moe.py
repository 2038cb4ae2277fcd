"""Mixture-of-Experts layer: top-k router + capacity-padded dispatch
(counterpart of ``repro/models/moe.py``).

Tokens are scattered into (E, capacity) buckets by their rank within
their expert, as in the reference.  The buckets, flattened to
(E * capacity, D), are the grouped-matmul kernel's own layout: every run
of ``block_t`` rows belongs to one expert, so the expert FFN is three
``ops.moe_gmm`` calls where the reference writes three batched einsums.
Training also takes the router's Switch load-balance loss
(``aux_loss``); serving does not compute it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import BLOCK_TS


class MoE(torch.nn.Module):
    """router: (E, D) like every port linear; w1, w3: (E, D, F) and w2:
    (E, F, D), the reference's and the kernel's (E, K, N) layout."""

    def __init__(self, d_model, m: MoEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        e, f = m.n_experts, m.d_ff_expert
        self.router = torch.nn.Linear(d_model, e, bias=False, **kw)
        self.w1 = torch.nn.Parameter(torch.empty(e, d_model, f, **kw))
        self.w3 = torch.nn.Parameter(torch.empty(e, d_model, f, **kw))
        self.w2 = torch.nn.Parameter(torch.empty(e, f, d_model, **kw))


def capacity(n_tokens: int, m: MoEConfig) -> int:
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-cap // 8) * 8)   # round up to multiple of 8


def block_t_for(cap: int) -> int:
    """The largest kernel row tile that divides ``cap`` (a multiple of 8)."""
    return next(bt for bt in BLOCK_TS if cap % bt == 0)


def router_topk(logits, m: MoEConfig):
    """logits: (T, E) fp32 -> (weights (T, k), ids (T, k), probs (T, E))."""
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids, probs


def aux_loss(probs, ids):
    """The Switch load-balance loss of one router: E x the sum over
    experts of the mean router probability times the fraction of tokens
    whose first choice it is; its gradient flows through ``probs``."""
    e = probs.shape[-1]
    routed = F.one_hot(ids[:, 0], e).to(probs.dtype)
    return e * torch.sum(probs.mean(0) * routed.mean(0))


def route(x, moe: MoE, m: MoEConfig):
    """x: (T, D) -> (weights (T, k) fp32, ids (T, k), flat (T*k,) row of
    each (token, choice) in the (E * cap + 1, D) buckets, keep (T*k,),
    cap, probs (T, E)).  Dropped choices point at the last row, which
    stays zeros."""
    t = x.shape[0]
    logits = moe.router(x).float()
    weights, ids, probs = router_topk(logits, m)
    cap = capacity(t, m)
    e = m.n_experts
    flat_e = ids.reshape(-1)
    # rank of each (token, choice) within its expert, in token order: a
    # stable sort, or ties between choices of one expert reorder
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device, dtype=sorted_e.dtype))
    rank_sorted = torch.arange(t * m.top_k, device=x.device) \
        - group_start[sorted_e]
    ranks = torch.empty_like(rank_sorted)
    ranks[sort_idx] = rank_sorted
    keep = ranks < cap
    flat = torch.where(keep, flat_e * cap + ranks, e * cap)
    return weights, ids, flat, keep, cap, probs


def moe_apply(moe: MoE, x, m: MoEConfig, *, with_aux: bool = False):
    """x: (B, S, D) -> (y (B, S, D), the router's aux loss with
    ``with_aux``, else 0.0: serving does not compute it)."""
    b, s, d = x.shape
    t, e = b * s, m.n_experts
    xf = x.reshape(t, d)
    weights, ids, flat, keep, cap, probs = route(xf, moe, m)
    tok_of = torch.arange(t, device=x.device).repeat_interleave(m.top_k)

    # dispatch: every kept (expert, slot) is written once; the dropped
    # choices all land in the one row past the buckets, which is sliced
    # off, so their gradient is zero
    buckets = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buckets[flat] = xf[tok_of]
    xb = buckets[:e * cap]

    bt = block_t_for(cap)
    gids = torch.arange(e, dtype=torch.int32, device=x.device) \
        .repeat_interleave(cap // bt)
    h = (F.silu(ops.moe_gmm(xb, moe.w1, gids, block_t=bt))
         * ops.moe_gmm(xb, moe.w3, gids, block_t=bt))
    out_b = ops.moe_gmm(h, moe.w2, gids, block_t=bt)

    # combine: the zero row past the buckets serves the dropped choices
    out_b = torch.cat([out_b, out_b.new_zeros(1, d)])
    gathered = out_b[flat] * (weights.reshape(-1, 1)
                              * keep[:, None]).to(out_b.dtype)
    y = gathered.reshape(t, m.top_k, d).sum(1)
    return y.reshape(b, s, d), aux_loss(probs, ids) if with_aux else 0.0
