"""Train, prefill and serve steps (counterpart of
``repro/launch/steps.py``; training on one device, every family)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig
from repro_torch.optim import (AdamWState, adamw_init, adamw_update_,
                               cosine_schedule)


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``functional_call`` can swap the model's parameters for one call."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _cast_params(model: torch.nn.Module, ex: ExecConfig):
    """The model's parameters for ``functional_call``, the floating ones
    in ``ex.compute_dtype``, or None where the module itself serves:
    they already are, or it is sharded (``parallel/fsdp.py`` casts each
    parameter where it gathers it)."""
    params = dict(model.named_parameters())
    if all(p.dtype == ex.compute_dtype or isinstance(p, DTensor)
           for p in params.values() if p.is_floating_point()):
        return None
    return {f"model.{n}": p.to(ex.compute_dtype) if p.is_floating_point()
            else p for n, p in params.items()}


def _call_with(fn, model: torch.nn.Module, params, *args):
    """``fn(model, *args)`` with ``params`` (``_cast_params``') in place
    of the model's parameters for this call only, or on the module itself
    where ``params`` is None."""
    if params is None:
        return fn(model, *args)
    return functional_call(_Bound(model, fn), params, args)


def _call_cast(fn, model: torch.nn.Module, ex: ExecConfig, *args):
    """``fn(model, *args)`` with the model's floating parameters in
    ``ex.compute_dtype``: the module itself when they already are, else
    its parameters cast for this call only.  The caller's module keeps
    its ``param_dtype``, as the reference's parameters do (it casts them
    inside every call).  A sharded module (``parallel/fsdp.py``) casts
    each parameter where it gathers it, so it is called as it is."""
    return _call_with(fn, model, _cast_params(model, ex), *args)


def _local(t):
    """A DTensor's local shard (a view: written in place, it writes the
    DTensor), any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


class TrainState(NamedTuple):
    model: torch.nn.Module   # the parameters, in param_dtype
    opt: AdamWState


def init_train_state(cfg: ModelConfig, ex: ExecConfig, seed: int = 0
                     ) -> TrainState:
    model = build_model(cfg).init(seed, ex)
    return TrainState(model=model,
                      opt=adamw_init(dict(model.named_parameters())))


def _microbatches(batch: dict, accum: int):
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum={accum}")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def make_grad_step(cfg: ModelConfig, ex: ExecConfig, *, accum: int = 1):
    """grad_step(model, batch) -> (loss, metrics): the loss in
    ``ex.compute_dtype`` on ``_cast_params``' copies (the parameters stay in
    ``param_dtype``, float32 master weights, and take the gradients
    through the cast) and its backward into each parameter's ``.grad``,
    which it clears first.  The backward runs inside the same call, so
    that a layer that ``ex.remat`` recomputes there reads the same cast
    parameters as its forward.  ``accum`` > 1 splits the batch's leading
    dim into microbatches run in turn; their gradients sum in ``.grad``
    (float32 with float32 master weights, as the reference's float32 sum)
    and the loss is their mean.  metrics: ce, aux."""
    model_fns = build_model(cfg)
    record = torch.profiler.record_function

    def forward_backward(model, batch):
        with record("train.forward"):
            loss, metrics = model_fns.loss(model, batch, ex)
        with record("train.backward"):
            loss.backward()
        return loss.detach(), metrics

    def micro(model, batch):
        with record("train.forward"):
            cast = _cast_params(model, ex)
        return _call_with(forward_backward, model, cast, batch)

    def grad_step(model, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum == 1:
            loss, metrics = micro(model, batch)
        else:
            loss = 0.0
            for mb in _microbatches(batch, accum):
                loss = loss + micro(model, mb)[0]
            loss = loss / accum
            metrics = {"ce": loss, "aux": 0.0}
        missing = [n for n, p in params.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        return loss, metrics

    return grad_step


def make_train_step(cfg: ModelConfig, ex: ExecConfig, *, base_lr=3e-4,
                    warmup=100, total=10000, accum: int = 1, group=None):
    """train_step(state, batch) -> (state, metrics): ``make_grad_step``'s
    gradients, divided by ``accum``, then one AdamW update of the
    parameters in place.  Each parameter's ``.grad`` keeps the step's
    summed gradient until the next step; the state's m and v are updated
    in place (``adamw_update_``).  metrics: loss, ce, aux, lr, grad_norm
    (tensors where computed on the device, so that a step does not wait
    for them).

    A sharded state (``launch/train.py::build_sharded_train``: the
    parameters, m and v DTensors) is updated through its local shards;
    ``group``, the process group it spans past one rank, sums the
    clipping norm over every shard (each element counted once) and
    averages the metrics over its ranks."""
    grad_step = make_grad_step(cfg, ex, accum=accum)
    lr_fn = cosine_schedule(base_lr, warmup, total)

    def train_step(state: TrainState, batch):
        loss, metrics = grad_step(state.model, batch)
        params = dict(state.model.named_parameters())
        with torch.profiler.record_function("train.optimizer"), \
                torch.no_grad():
            grads = {n: _local(p.grad) if accum == 1
                     else _local(p.grad) / accum for n, p in params.items()}
            opt = state.opt
            shards = AdamWState(step=opt.step,
                                m={n: _local(t) for n, t in opt.m.items()},
                                v={n: _local(t) for n, t in opt.v.items()})
            replicas = None
            if group is not None:
                from repro_torch.parallel.fsdp import replication
                replicas = {n: replication(p) for n, p in params.items()}
            new, om = adamw_update_(
                {n: _local(p) for n, p in params.items()}, grads, shards,
                lr_fn, replicas=replicas, group=group)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in dict(metrics, loss=loss, **om).items()}
        if group is not None:
            import torch.distributed as dist
            world = dist.get_world_size(group)
            for k, v in metrics.items():
                if torch.is_tensor(v):
                    v = v.clone()
                    dist.all_reduce(v, group=group)
                    metrics[k] = v / world
        return TrainState(model=state.model, opt=AdamWState(
            step=new.step, m=opt.m, v=opt.v)), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, ex: ExecConfig):
    """prefill_step(model, batch, cache=None) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def prefill_step(model, batch, cache=None):
        return _call_cast(model_fns.prefill, model, ex, batch, ex, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ex: ExecConfig):
    """One decode step: (model, cache, tokens, pos) -> (logits, cache)."""
    model_fns = build_model(cfg)

    def serve_step(model, cache, tokens, pos):
        return _call_cast(model_fns.decode_step, model, ex, cache, tokens,
                          pos, ex)

    return serve_step
