"""Training on one device: seeded synthetic batches through
``make_train_step`` (counterpart of ``repro/launch/train.py``'s step loop).

``python -m repro_torch.launch.train --arch tinyllama-1.1b`` trains on the
GPU with float32 master weights and bfloat16 compute (the kernels in the
forward); ``--device cpu`` trains on the CPU in float32 (the plain
versions), ``--reduced`` the config's tiny version.  Every family trains:
dense (``tinyllama-1.1b``), moe (``mixtral-8x7b``, with the router's aux
loss), vlm (``llava-next-34b``, the loss masked over the prefix), hybrid
(``zamba2-7b``), ssm (``mamba2-780m``) and encdec (``whisper-medium``:
``--seq`` is the decoder's length; the encoder takes the config's
``encoder_len`` frames).  The full configs past one card's memory train
only at a cut depth, which ``chip_smoke.py`` sets.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig, check_device


def train_exec_config(cfg, device) -> ExecConfig:
    """float32 parameters; bfloat16 compute on the card, float32 on the
    CPU; the config's SSD chunk."""
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    return ExecConfig(param_dtype=torch.float32, compute_dtype=compute,
                      ssd_chunk=cfg.ssm.chunk if cfg.ssm else 128,
                      device=str(device))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The data pipeline, checkpoints, resume and the "
        "fault-tolerant loop are not ported yet (ROADMAP A8): every step "
        "draws a fresh synthetic batch from --seed + step.")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="any arch of every family: tinyllama-1.1b, "
                    "mixtral-8x7b, llava-next-34b, zamba2-7b, mamba2-780m, "
                    "whisper-medium, ...")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024,
                    help="tokens a sequence (encdec: the decoder's)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (bfloat16 compute, the kernels) or cpu "
                    "(float32, the plain versions)")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ex = train_exec_config(cfg, device)
    fns = build_model(cfg)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    state = init_train_state(cfg, ex, args.seed)
    step = make_train_step(cfg, ex, base_lr=args.lr, accum=args.accum)
    history = []
    for i in range(args.steps):
        batch = fns.make_batch(args.seed + i, shape, ex, kind="train")
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])   # waits
        ms = (time.perf_counter() - t0) * 1e3
        history.append({"step": i, "loss": loss, "grad_norm": gnorm,
                        "lr": m["lr"], "ms": ms})
        print(f"step {i}: loss {loss:.4f} grad_norm {gnorm:.4f} lr "
              f"{m['lr']:.3g} {ms:.1f} ms "
              f"({args.batch * args.seq / ms * 1e3:.0f} tok/s)")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{cfg.name}: {args.steps} steps of {args.batch} x {args.seq} on "
          f"{where}")
    return history


if __name__ == "__main__":
    main()
