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


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled to a global L2 norm of at most ``max_norm``, each
    in its own dtype; the norm before clipping, a float32 0-d tensor)."""
    gnorm = torch.stack([torch.sum(g.float() ** 2)
                         for g in grads.values()]).sum().sqrt()
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, gnorm


def adamw_update(params: dict, grads: dict, state: AdamWState, lr_fn, *,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 max_grad_norm=1.0):
    """-> (new params, new state, {"lr", "grad_norm"}).  Weight decay
    applies to every parameter, as in the reference."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    lr = lr_fn(step)
    b1t = 1.0 - b1 ** step
    b2t = 1.0 - b2 ** step
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        g32 = grads[n].float()
        m = b1 * state.m[n] + (1 - b1) * g32
        v = b2 * state.v[n] + (1 - b2) * g32 * g32
        p32 = p.float()
        upd = (m / b1t) / (torch.sqrt(v / b2t) + eps) + weight_decay * p32
        new_p[n] = (p32 - lr * upd).to(p.dtype)
        new_m[n], new_v[n] = m, v
    return new_p, AdamWState(step=step, m=new_m, v=new_v), \
        {"lr": lr, "grad_norm": gnorm}
