"""AdamW, the cosine schedule and global-norm clipping over dicts of
tensors keyed by parameter name (counterpart of
``repro/optim/adamw.py``).  Moments and the update run in float32; each
new parameter is cast back to its own dtype."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int          # updates taken
    m: dict            # name -> float32 first moment
    v: dict            # name -> float32 second moment


def adamw_init(params: dict) -> AdamWState:
    return AdamWState(
        step=0,
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()})


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> lr: linear warm-up to ``base_lr`` over ``warmup`` steps,
    then a cosine to 0 at ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * frac))
    return lr


def _global_norm_scale(grads: dict, max_norm: float, *, replicas=None,
                       group=None):
    """-> (the global L2 norm of ``grads``, a float32 0-d tensor; the
    factor that clips it to at most ``max_norm``).  Sharded: ``grads``
    are this rank's shards, ``replicas`` {name: ranks holding each of its
    elements}, and the squares are summed over ``group``'s ranks."""
    sq = [torch.sum(g.float() ** 2) for g in grads.values()]
    if replicas is not None:
        sq = [s / replicas[n] if replicas[n] > 1 else s
              for s, n in zip(sq, grads)]
    total = torch.stack(sq).sum()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(total, group=group)
    gnorm = total.sqrt()
    return gnorm, torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                              max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled to a global L2 norm of at most ``max_norm``, each
    in its own dtype; the norm before clipping, a float32 0-d tensor)."""
    gnorm, scale = _global_norm_scale(grads, max_norm)
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, gnorm


def adamw_update_(params: dict, grads: dict, state: AdamWState, lr_fn, *,
                  b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                  max_grad_norm=1.0, replicas=None, group=None):
    """One AdamW update in place: every parameter and its m and v are
    overwritten -> (the state one step on, holding the same m and v
    tensors; {"lr", "grad_norm"}).  It clips each gradient as it reaches
    it and holds one parameter's temporaries at a time, where a copy of
    the whole state would double its memory (a 3 B-parameter state is
    ~50 GB in float32).  The arithmetic is ``adamw_update``'s, operation
    for operation.  Weight decay applies to every parameter, as in the
    reference.  On local shards of a sharded state, ``replicas`` and
    ``group`` make the clipping norm the global one
    (``_global_norm_scale``); the update itself is elementwise."""
    gnorm, scale = _global_norm_scale(grads, max_grad_norm,
                                      replicas=replicas, group=group)
    step = state.step + 1
    lr = lr_fn(step)
    b1t = 1.0 - b1 ** step
    b2t = 1.0 - b2 ** step
    for n, p in params.items():
        g32 = (grads[n] * scale).to(grads[n].dtype).float()
        m, v = state.m[n], state.v[n]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
        del g32
        p32 = p.float()
        # (m / b1t) / (sqrt(v / b2t) + eps) + weight_decay * p32
        upd = torch.div(m, b1t).div_(torch.div(v, b2t).sqrt_().add_(eps))
        upd.add_(weight_decay * p32)
        p.copy_(p32.sub_(upd.mul_(lr)))
    return AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}


def adamw_update(params: dict, grads: dict, state: AdamWState, lr_fn,
                 **kw):
    """-> (new params, new state, {"lr", "grad_norm"}): ``adamw_update_``
    on copies, leaving ``params`` and ``state`` as they are."""
    new_p = {n: p.detach().clone() for n, p in params.items()}
    new = AdamWState(step=state.step,
                     m={n: t.clone() for n, t in state.m.items()},
                     v={n: t.clone() for n, t in state.v.items()})
    new, info = adamw_update_(new_p, grads, new, lr_fn, **kw)
    return new_p, new, info
