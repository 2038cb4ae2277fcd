"""Training driver on one device: ``python -m repro_torch.launch.train
--arch <id> ...`` (counterpart of ``repro/launch/train.py``).

Composes: config -> model -> ``make_train_step`` -> the deterministic
data pipeline (``repro_torch.data``) -> the fault-tolerant loop
(``repro_torch.runtime``) with async checkpoints
(``repro_torch.checkpoint``, every ``--ckpt-every`` steps into
``--ckpt-dir``; ``--resume`` restores the latest committed one and goes
on from its step; SIGTERM/SIGINT finish the step, write a checkpoint and
stop).

``--arch tinyllama-1.1b`` trains on the GPU with float32 master weights
and bfloat16 compute (the kernels in the forward); ``--device cpu``
trains on the CPU in float32 (the plain versions), ``--reduced`` the
config's tiny version.  Every family trains: dense (``tinyllama-1.1b``),
moe (``mixtral-8x7b``, with the router's aux loss), vlm
(``llava-next-34b``, the loss masked over the prefix), hybrid
(``zamba2-7b``), ssm (``mamba2-780m``) and encdec (``whisper-medium``:
``--seq`` is the decoder's length; the encoder takes the config's
``encoder_len`` frames).  The full configs past one card's memory train
only at a cut depth, which ``chip_smoke.py`` sets.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 4 --ckpt-every 2 --resume
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataPipeline
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.common import ExecConfig, check_device
from repro_torch.runtime import FaultTolerantLoop


def train_exec_config(cfg, device) -> ExecConfig:
    """float32 parameters; bfloat16 compute on the card, float32 on the
    CPU; the config's SSD chunk."""
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    return ExecConfig(param_dtype=torch.float32, compute_dtype=compute,
                      ssd_chunk=cfg.ssm.chunk if cfg.ssm else 128,
                      device=str(device))


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
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ex = train_exec_config(cfg, device)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    state = init_train_state(cfg, ex, args.seed)
    step_fn = make_train_step(cfg, ex, base_lr=args.lr, accum=args.accum)
    pipeline = DataPipeline(cfg, shape, seed=args.seed, ex=ex)
    ckpt = CheckpointManager(args.ckpt_dir)
    loop = FaultTolerantLoop(step_fn, ckpt, pipeline,
                             checkpoint_every=args.ckpt_every)
    start = 0
    if args.resume:
        state, start = loop.resume_or_init(state)
        print(f"resumed from step {start}")
    history = []

    def on_metrics(step, m, dt):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms = dt * 1e3
        history.append({"step": step - 1, "loss": loss, "grad_norm": gnorm,
                        "lr": m["lr"], "ms": ms})
        print(f"step {step - 1}: loss {loss:.4f} grad_norm {gnorm:.4f} lr "
              f"{m['lr']:.3g} {ms:.1f} ms "
              f"({args.batch * args.seq / ms * 1e3:.0f} tok/s)")

    state, last = loop.run(state, args.steps, start_step=start,
                           on_metrics=on_metrics)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{cfg.name}: steps {start}-{last} of {args.batch} x {args.seq} "
          f"on {where}; latest checkpoint {ckpt.latest_step()} in "
          f"{args.ckpt_dir}; stragglers {loop.straggler_steps}")
    return history


if __name__ == "__main__":
    main()
