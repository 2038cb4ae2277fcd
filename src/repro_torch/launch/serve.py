"""Serving driver: batched prefill + greedy decode loop (counterpart of
``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch tinyllama-1.1b`` (or
``--arch zamba2-7b``, ``--arch mamba2-780m``, ``--arch llava-next-34b``,
``--arch whisper-medium``, ``--arch mixtral-8x7b``, ``--arch
qwen3-moe-235b-a22b``) serves on the GPU in bfloat16; ``--device cpu``
runs on the CPU in float32 (plain PyTorch in place of the kernels).
Mamba2-780M carries each layer's final SSD state from prefill into
decode; LLaVA-NeXT-34B's prompt starts with its ``n_prefix_tokens`` (576)
image-patch embeddings, seeded random normals standing in for the vision
tower, so its ``--prompt-len`` is at least 576 (8 with ``--reduced``).
Whisper-medium's encoder runs once a batch over ``encoder_len`` (1500;
16 with ``--reduced``) seeded random frame embeddings standing in for the
audio frontend, and its decoder reads them through cross-attention
(Whisper's decoder context is 448 tokens, prompt and new tokens, which
nothing here enforces).  LLaVA-NeXT-34B's 60 layers are 68.8 GB of
bfloat16 weights before the KV cache, most of one 80 GB card; the MoE
archs at full depth exceed one card (Mixtral-8x7B is 93 GB in bfloat16,
Qwen3-MoE 470 GB).  ``--reduced`` serves their tiny versions (8 prefix
embeddings for LLaVA).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig, check_device


@dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen_len) greedy tokens
    prefill_logits: torch.Tensor  # (B, V) logits of the last prompt position
    prefill_s: float              # wall time of the prefill
    decode_s: float               # wall time of the gen_len - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, ex, prompt_len=32, gen_len=32, batch=2, seed=0, *,
             model=None) -> Generation:
    """Greedy generation from a seeded random prompt.

    ``model``: the module to serve; None builds one with seeded random
    weights.  The reference prefills into a cache of the prompt's length
    and copies it into one with headroom; here the cache is allocated once
    for prompt + gen and prefill writes its K/V into it in place.
    """
    device = check_device(ex.device)
    model_fns = build_model(cfg)
    if model is None:
        model = model_fns.init(seed, ex)
    shape = ShapeConfig("serve", "prefill", prompt_len, batch)
    batch_in = model_fns.make_batch(seed + 1, shape, ex)
    prefill = make_prefill_step(cfg, ex)
    decode = make_serve_step(cfg, ex)
    cache = model_fns.init_cache(batch, prompt_len + gen_len, ex)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, batch_in, cache)
    tok = torch.argmax(logits, -1)
    _sync(device)
    t1 = time.perf_counter()
    first_logits = logits
    out = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(model, cache, tok, prompt_len + i)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    tokens = torch.stack(out, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    return Generation(tokens=tokens, prefill_logits=first_logits,
                      prefill_s=t1 - t0, decode_s=t2 - t1)


def exec_config(cfg, dtype, device) -> ExecConfig:
    """Serving settings for ``cfg``: params and compute in ``dtype``, and
    the config's SSD chunk (8 when reduced), as the reference CLI."""
    return ExecConfig(param_dtype=dtype, compute_dtype=dtype, attn_block=32,
                      ssd_chunk=cfg.ssm.chunk if cfg.ssm else 128,
                      device=str(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="a dense (tinyllama-1.1b, gemma2-2b, ...), hybrid "
                    "(zamba2-7b), SSM (mamba2-780m), VLM (llava-next-34b, "
                    "a prompt of at least its 576 prefix embeddings), "
                    "encoder-decoder (whisper-medium, 1500 encoder frames) "
                    "or MoE (mixtral-8x7b, qwen3-moe-235b-a22b) arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (bfloat16, the kernels) or cpu (float32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = check_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ex = exec_config(cfg, dtype, device)
    t0 = time.perf_counter()
    gen = generate(cfg, ex, args.prompt_len, args.gen_len, args.batch,
                   args.seed)
    dt = time.perf_counter() - t0
    n = gen.tokens.numel()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"generated {tuple(gen.tokens.shape)} tokens in {dt:.1f}s "
          f"({n / dt:.1f} tok/s, first call, on {name}); prefill "
          f"{gen.prefill_s * 1e3:.1f} ms, decode "
          f"{gen.decode_s * 1e3 / max(args.gen_len - 1, 1):.2f} ms/step")
    print(gen.tokens[:, :12].cpu())
    return gen


if __name__ == "__main__":
    main()
