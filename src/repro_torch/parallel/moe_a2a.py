"""Explicit all-to-all MoE dispatch over the ``model`` axis (counterpart
of ``repro/parallel/moe_a2a.py``, the reference's shard_map path).

Each rank's tile of tokens -> per-destination send buffers ->
``all_to_all_single`` over the model axis's process group (whose ranks
own the experts, ``E / model`` each) -> local expert buckets -> the
expert FFN on the grouped-matmul kernel (``ops.moe_gmm``) -> the inverse
path.  The algorithm is the reference's step for step: the stable rank
within destination, ``cap_send`` and ``cap_exp``, the same drops, the
aux loss averaged over model and then over the data axes.

The caller holds its data shard ``(B_l, S, D)`` whole on every model rank
(``launch/train.py`` gathers the dense blocks and computes them on each
model rank alike).  The reference's tile is ``P(data, model)``: so each
model rank takes its sequence slice on the way in and the outputs are
gathered over model on the way out, each the other's transpose, so the
gradient reaching the caller is whole on every model rank again.  The
router, replicated, sees one slice on each model rank: its gradient is
summed over model.  Differentiable throughout: the all-to-all's backward
is the reverse all-to-all.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops
from repro_torch.models.moe import aux_loss, block_t_for, router_topk
from repro_torch.parallel.sharding import axis_sizes


class _AllToAll(torch.autograd.Function):
    """(n, ...) -> (n, ...): row block j goes to rank j of ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


class _SliceOver(torch.autograd.Function):
    """Forward: this rank's block of ``dim``; backward: the blocks
    gathered over ``group``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _GatherOver(torch.autograd.Function):
    """Forward: the blocks of ``dim`` gathered over ``group``; backward:
    this rank's block (the gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _SumGradOver(torch.autograd.Function):
    """Forward: the tensor itself; backward: its gradient summed over
    ``group`` (a replicated weight that each rank applies to its own
    slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOver(torch.autograd.Function):
    """Forward: the mean over ``group``.  Backward: the gradient times
    ``scale`` — 1/n over model, whose ranks hold copies of one loss; 1
    over a data axis, whose ranks hold their own losses (their
    gradients are averaged when they reach the parameters)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def _rank_within(groups, n_groups: int):
    """Rank of each element among equal values of ``groups`` (stable)."""
    sorted_g, order = torch.sort(groups, stable=True)
    start = torch.searchsorted(
        sorted_g, torch.arange(n_groups, device=groups.device,
                               dtype=sorted_g.dtype))
    rank_sorted = torch.arange(groups.shape[0], device=groups.device) \
        - start[sorted_g]
    ranks = torch.empty_like(rank_sorted)
    ranks[order] = rank_sorted
    return ranks


def moe_apply_a2a(moe, x, m: MoEConfig, ex, mesh):
    """x: (B_l, S, D), this rank's data shard (the same on every model
    rank) -> (y (B_l, S, D), aux).  ``moe.w1``, ``w3``, ``w2`` are this
    model rank's ``E / model`` experts; ``moe.router`` is whole.
    Requires n_experts % model == 0 and S % model == 0."""
    sizes = axis_sizes(mesh)
    model_size = sizes["model"]
    if m.n_experts % model_size or x.shape[1] % model_size:
        raise ValueError(f"the all-to-all needs n_experts ({m.n_experts}) "
                         f"and the sequence ({x.shape[1]}) divisible by "
                         f"the model axis ({model_size})")
    e_local = m.n_experts // model_size
    group = mesh.get_group("model")
    k = m.top_k

    xl = _SliceOver.apply(x, group, 1)              # (B_l, S_l, D) tile
    bl, sl, d = xl.shape
    t_l = bl * sl
    h = xl.reshape(t_l, d)
    router = _SumGradOver.apply(moe.router.weight, group)
    logits = F.linear(h, router).float()
    weights, ids, probs = router_topk(logits, m)
    aux = aux_loss(probs, ids)

    flat_ids = ids.reshape(-1)                      # (t_l*k,)
    tok_of = torch.arange(t_l, device=x.device).repeat_interleave(k)
    dest = flat_ids // e_local                      # model-rank owner
    cap_send = max(8, -(-int(t_l * k * m.capacity_factor
                             / model_size) // 8) * 8)
    rank_d = _rank_within(dest, model_size)
    keep = rank_d < cap_send
    slot = torch.where(keep, rank_d, cap_send)
    # (destination, slot) rows with one drop slot each, sliced off
    row = dest * (cap_send + 1) + slot

    send = torch.zeros((model_size * (cap_send + 1), d), dtype=x.dtype,
                       device=x.device)
    send[row] = h[tok_of]
    send = send.view(model_size, cap_send + 1, d)[:, :cap_send]
    send_e = torch.full((model_size * (cap_send + 1),), e_local,
                        dtype=torch.int32, device=x.device)
    send_e[row] = (flat_ids % e_local).to(torch.int32)
    send_e = send_e.view(model_size, cap_send + 1)[:, :cap_send]

    recv = _AllToAll.apply(send.contiguous(), group)
    recv_e = torch.empty_like(send_e)
    dist.all_to_all_single(recv_e, send_e.contiguous(), group=group)

    rows = recv.reshape(model_size * cap_send, d)
    e_flat = recv_e.reshape(-1).long()              # in [0, e_local]
    cap_exp = max(8, -(-model_size * cap_send // e_local // 8) * 8)
    rank_e = _rank_within(e_flat, e_local + 1)
    keep_e = (e_flat < e_local) & (rank_e < cap_exp)
    # kept rows go to their (expert, slot) of the (e_local * cap_exp, D)
    # buckets, the grouped matmul's layout; the rest to one row past them
    flat_e = torch.where(keep_e, e_flat * cap_exp + rank_e,
                         e_local * cap_exp)
    buckets = torch.zeros((e_local * cap_exp + 1, d), dtype=x.dtype,
                          device=x.device)
    buckets[flat_e] = rows
    xb = buckets[:e_local * cap_exp]

    bt = block_t_for(cap_exp)
    gids = torch.arange(e_local, dtype=torch.int32, device=x.device) \
        .repeat_interleave(cap_exp // bt)
    hh = (F.silu(ops.moe_gmm(xb, moe.w1, gids, block_t=bt))
          * ops.moe_gmm(xb, moe.w3, gids, block_t=bt))
    out_b = ops.moe_gmm(hh, moe.w2, gids, block_t=bt)

    out_b = torch.cat([out_b, out_b.new_zeros(1, d)])
    back_rows = out_b[flat_e] * keep_e[:, None].to(out_b.dtype)
    back = back_rows.view(model_size, cap_send, d)
    ret = _AllToAll.apply(back, group)

    ret = torch.cat([ret, ret.new_zeros(model_size, 1, d)], 1)
    gathered = ret.reshape(-1, d)[row] * keep[:, None].to(ret.dtype)
    gathered = gathered * weights.reshape(-1, 1).to(gathered.dtype)
    y = gathered.view(t_l, k, d).sum(1).view(bl, sl, d)
    y = _GatherOver.apply(y, group, 1)
    aux = _MeanOver.apply(aux, group, 1.0 / model_size)
    for a in sizes:
        if a != "model":
            aux = _MeanOver.apply(aux, mesh.get_group(a), 1.0)
    return y, aux
