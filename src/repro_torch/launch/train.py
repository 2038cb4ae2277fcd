"""The trainer: ``python -m repro_torch.launch.train --arch <id> ...``
(counterpart of ``repro/launch/train.py``).

Composes: config -> model -> the sharded train step
(``build_sharded_train``: the state placed on a ``(world, 1)``
``("data", "model")`` mesh by ``parallel.sharding.param_specs``) -> the
deterministic data pipeline (``repro_torch.data``) -> the fault-tolerant
loop (``repro_torch.runtime``) with async checkpoints
(``repro_torch.checkpoint``, every ``--ckpt-every`` steps into
``--ckpt-dir``, the full tensors written by rank 0; ``--resume`` restores
every rank's shards from the latest committed one and goes on from its
step; SIGTERM/SIGINT finish the step, write a checkpoint and stop).

Under ``torchrun --nproc-per-node N -m repro_torch.launch.train ...`` it
reads ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, takes the card of its
local rank and joins the group (NCCL on the card, gloo on the CPU);
without torchrun it makes a one-rank group and runs the same path.
``--batch`` is the global batch; each rank takes its shard.

``--arch tinyllama-1.1b`` trains on the GPU with float32 master weights
and bfloat16 compute (the kernels in the forward); ``--device cpu``
trains on the CPU in float32 (the plain versions), ``--reduced`` the
config's tiny version.  Every family trains: dense (``tinyllama-1.1b``),
moe (``mixtral-8x7b``, with the router's aux loss; past one rank its
experts run over the all-to-all), vlm (``llava-next-34b``, the loss
masked over the prefix), hybrid (``zamba2-7b``), ssm (``mamba2-780m``)
and encdec (``whisper-medium``: ``--seq`` is the decoder's length; the
encoder takes the config's ``encoder_len`` frames).  The full configs
past one card's memory train only at a cut depth, which
``chip_smoke.py`` sets.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 4 --ckpt-every 2 --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataPipeline
from repro_torch.launch.mesh import fsdp_axes, make_mesh_from_plan
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models.common import ExecConfig, check_device
from repro_torch.optim import AdamWState
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import (axis_sizes, batch_specs,
                                           local_slice, param_specs,
                                           placements)
from repro_torch.runtime import FaultTolerantLoop


def train_exec_config(cfg, device, remat: str = "none") -> ExecConfig:
    """float32 parameters; bfloat16 compute on the card, float32 on the
    CPU; the config's SSD chunk; ``remat``, ``ExecConfig.remat`` (the
    reference's trainer has no flag for it: the CLI trains under
    "none")."""
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    return ExecConfig(param_dtype=torch.float32, compute_dtype=compute,
                      ssd_chunk=cfg.ssm.chunk if cfg.ssm else 128,
                      device=str(device), remat=remat)


def build_sharded_train(cfg, ex, mesh, shape, accum=1, base_lr=3e-4,
                        warmup=100, total=10000):
    """-> (train_step, place): ``steps.make_train_step`` on a state
    sharded over ``mesh`` (a ``DeviceMesh`` over the default process
    group).

    ``place(state)`` takes a ``TrainState`` whole and equal on every rank
    (``init_train_state``) and shards it in place: every parameter, and
    AdamW's m and v, becomes a DTensor with the placements of its
    ``param_specs`` entry (``parallel/fsdp.py``).
    ``train_step(state, batch)`` takes the GLOBAL batch, keeps this
    rank's shard by ``batch_specs``, and runs ``make_train_step`` inside
    ``fsdp.gathered_forward``: each parameter is gathered where it is
    read, its gradient returns averaged over the data axes into its
    placements, AdamW updates the local shards, clipped by the norm over
    all shards, and the metrics are averaged over the ranks.
    ``ex.moe_impl == "a2a"`` runs the experts over the all-to-all with
    each model rank's experts never gathered; the dense dispatch is
    refused past one data rank."""
    data_ranks = 1
    for a in fsdp_axes(mesh):
        data_ranks *= axis_sizes(mesh)[a]
    if cfg.moe is not None and ex.moe_impl != "a2a" and data_ranks > 1:
        raise ValueError(
            f"{cfg.name}: the dense MoE dispatch would route each of the "
            f"{data_ranks} data ranks' shards on its own (its own capacity "
            f"and aux loss), not the whole batch; train a MoE over more "
            f"than one data rank with moe_impl='a2a'")
    ex = dataclasses.replace(ex, mesh=mesh)
    spec_for = batch_specs(cfg, shape, mesh, kind="train")
    coords = {a: mesh.get_local_rank(a) for a in axis_sizes(mesh)}
    step = make_train_step(
        cfg, ex, base_lr=base_lr, warmup=warmup, total=total, accum=accum,
        group=dist.group.WORLD if dist.get_world_size() > 1 else None)

    def place(state: TrainState) -> TrainState:
        from torch.distributed.tensor import distribute_tensor
        model = state.model
        specs = param_specs(cfg, model, mesh)
        experts = [n for n in specs if ex.moe_impl == "a2a"
                   and n.endswith((".moe.w1", ".moe.w2", ".moe.w3"))]
        fsdp.shard_module(model, specs, mesh, compute_dtype=ex.compute_dtype,
                          model_sharded=experts)

        def dist_(t, name):
            return distribute_tensor(t, mesh, placements(specs[name], mesh),
                                     src_data_rank=None)
        opt = state.opt
        return TrainState(model=model, opt=AdamWState(
            step=opt.step, m={n: dist_(t, n) for n, t in opt.m.items()},
            v={n: dist_(t, n) for n, t in opt.v.items()}))

    def train_step(state: TrainState, batch):
        batch = {k: local_slice(v, spec_for(k), mesh, coords)
                 for k, v in batch.items()}
        with fsdp.gathered_forward():
            return step(state, batch)

    return train_step, place


def init_process_group(device: torch.device, store_path: str) -> None:
    """Join the default process group: torchrun's (``WORLD_SIZE``,
    ``RANK``, its rendezvous in the environment), else a one-rank group
    on a file store at ``store_path``.  NCCL on the card, gloo on the
    CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, rank=0, world_size=1,
                                store=dist.FileStore(store_path, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="any arch of every family: tinyllama-1.1b, "
                    "mixtral-8x7b, llava-next-34b, zamba2-7b, mamba2-780m, "
                    "whisper-medium, ...")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10,
                    help="total steps (a resumed run goes on to it)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024,
                    help="tokens a sequence (encdec: the decoder's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest committed checkpoint in "
                    "--ckpt-dir and go on from its step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (bfloat16 compute, the kernels) or cpu "
                    "(float32, the plain versions)")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         device.index or 0)))
        torch.cuda.set_device(device)
    if dist.is_initialized():           # the caller's group
        return _train(args, device)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(device, os.path.join(tmp, "store"))
        try:
            return _train(args, device)
        finally:
            dist.destroy_process_group()


def _train(args, device):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world, rank = dist.get_world_size(), dist.get_rank()
    # a MoE past one rank trains over the all-to-all (build_sharded_train
    # refuses the dense dispatch there)
    ex = dataclasses.replace(train_exec_config(cfg, device),
                             moe_impl="a2a" if world > 1 else "dense")
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    mesh = make_mesh_from_plan(tp=1, dp=world, device=device)
    step_fn, place = build_sharded_train(cfg, ex, mesh, shape,
                                         accum=args.accum, base_lr=args.lr)
    state = place(init_train_state(cfg, ex, args.seed))
    pipeline = DataPipeline(cfg, shape, seed=args.seed, ex=ex)
    ckpt = CheckpointManager(args.ckpt_dir)
    loop = FaultTolerantLoop(step_fn, ckpt, pipeline,
                             checkpoint_every=args.ckpt_every)
    start = 0
    if args.resume:
        state, start = loop.resume_or_init(state)
        if rank == 0:
            print(f"resumed from step {start}")
    history = []

    def on_metrics(step, m, dt):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms = dt * 1e3
        history.append({"step": step - 1, "loss": loss, "grad_norm": gnorm,
                        "lr": m["lr"], "ms": ms})
        if rank == 0:
            print(f"step {step - 1}: loss {loss:.4f} grad_norm "
                  f"{gnorm:.4f} lr {m['lr']:.3g} {ms:.1f} ms "
                  f"({args.batch * args.seq / ms * 1e3:.0f} tok/s)")

    state, last = loop.run(state, args.steps, start_step=start,
                           on_metrics=on_metrics)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if rank == 0:
        print(f"{cfg.name}: steps {start}-{last} of {args.batch} x "
              f"{args.seq} on {world} x {where}; latest checkpoint "
              f"{ckpt.latest_step()} in {args.ckpt_dir}; stragglers "
              f"{loop.straggler_steps}")
    return history


if __name__ == "__main__":
    main()
