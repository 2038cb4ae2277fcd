"""Time variants of the grouped matmul's kernels against each other on one
card.  The wgmma kernel (prefill): the order in which the persistent
blocks walk the tiles, the consumers reading each tile's expert id one
tile ahead, and 128-column tiles at block_t 128.  With ``--decode``, the
decode kernel (block_t 8-32): 128- and 512-column tiles against 256, two
blocks a SM (each with half the ring) against one, and two blocks a SM
without the proxy fence before a stage is given back.

Each variant is ``csrc/moe_gmm.cu`` with one piece of text replaced, built
by its own ``nvcc`` (all at once) into ``build/kernels/variants/``.  At each
prefill (or decode) shape of ``chip_smoke.py`` the variants are timed call
by call in turns, forward then back, by CUDA events around each call, so
that a drift of the card's clock under sustained load falls on all of them
alike; each reports the median and the 10th and 90th percentiles of its
calls.  Every variant's output must equal the unchanged kernel's bit for
bit, but for the ones in ``MAY_RACE``, whose differences are counted.
``--repeat N`` calls each variant N times more at each shape and counts
the calls whose output differs from its first call's: the kernels are
deterministic, so a count above 0 is a race.  Run from the repo root on a
machine with a card and the CUDA toolkit:

    PYTHONPATH=src python -m repro_torch.launch.gmm_variants
    PYTHONPATH=src python -m repro_torch.launch.gmm_variants --decode
        [--repeat N] [--against OTHER/moe_gmm.cu [--serve]]

``--against`` builds another source of the file as it stands (say an
earlier commit's, unpacked with ``git archive``) as one more variant,
called with the same kernel code, and held to the decode kernel's output
within one bf16 rounding (2e-2) instead of bit for bit.  ``--serve`` then
serves Qwen3-MoE-235B-A22B (8 of 94 layers, batch 8, prompt 1024, 64 new
tokens, bf16) once with each of the two libraries in the gmm's wrapper,
in turns (other, this, this, other): decode ms a step, and the gmm's
device ms and share of 8 profiled decode steps.

Prints one JSON line per shape (and per served run) and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import moe_gmm as mg

NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
ORDER_LINE = "const int tile_group = col_tiles > 8 ? 16 : 1;"
BN_LINE = "  constexpr int BN = 256;\n"
ID_AT_TILE = """\
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      int rb, nt;
      gmm_tile(i, g, rb, nt);
      const int e = gids[rb];
"""
ID_AHEAD = """\
    int rb = 0, nt = 0, e = 0, rb_next = 0, nt_next = 0, e_next = 0;
    if (blockIdx.x < n_tiles) {
      gmm_tile(blockIdx.x, g, rb, nt);
      e = gids[rb];
    }
    for (int i = blockIdx.x; i < n_tiles;
         i += gridDim.x, rb = rb_next, nt = nt_next, e = e_next) {
      if (i + gridDim.x < n_tiles) {
        gmm_tile(i + gridDim.x, g, rb_next, nt_next);
        e_next = gids[rb_next];
      }
"""
# name: the (text, replacement) pairs that make it; "base" is the source
# as it stands (tile group 1 up to 8 column tiles, else 16)
VARIANTS = {
    "base": [],
    **{f"group{g}": [(ORDER_LINE, f"const int tile_group = {g};")]
       for g in (1, 4, 16, 32)},
    "id_ahead": [(ID_AT_TILE, ID_AHEAD)],
    "bn128": [(BN_LINE, "  constexpr int BN = BT == 128 ? 128 : 256;\n")],
}
DECODE_BN_LINE = "constexpr int kDecodeBN = 256;"
DECODE_SM_LINE = "constexpr int kDecodeBlocksPerSm = 1;"
DECODE_FENCE = "      repro::fence_proxy_async();\n      repro::mbar_arrive(empty"
TWO_PER_SM = (DECODE_SM_LINE, "constexpr int kDecodeBlocksPerSm = 2;")
DECODE_VARIANTS = {
    "decode_base": [],
    "decode_bn128": [(DECODE_BN_LINE, "constexpr int kDecodeBN = 128;")],
    "decode_bn512": [(DECODE_BN_LINE, "constexpr int kDecodeBN = 512;")],
    "decode_two_per_sm": [TWO_PER_SM],
    "decode_two_per_sm_unfenced": [
        TWO_PER_SM, (DECODE_FENCE, "      repro::mbar_arrive(empty")],
}
# variants whose output may differ from the base's (a race they show)
MAY_RACE = {"decode_two_per_sm_unfenced"}
# chip_smoke.py's prefill cases: name, experts, rows per expert, K, N,
# block_t
CASES = [
    ("qwen3_prefill", 128, 640, 4096, 1536, 128),
    ("qwen3_prefill_w2", 128, 640, 1536, 4096, 128),
    ("mixtral_prefill", 8, 2560, 4096, 14336, 128),
    ("bt64", 32, 192, 2048, 1024, 64),
]
# chip_smoke.py's decode cases, likewise
DECODE_CASES = [
    ("qwen3_decode", 128, 8, 4096, 1536, 8),
    ("qwen3_decode_w2", 128, 8, 1536, 4096, 8),
    ("qwen3_decode_bt16", 128, 16, 4096, 1536, 16),
    ("qwen3_decode_bt32", 128, 32, 4096, 1536, 32),
]
ROUNDS = 40   # each a pass forward and a pass back: 80 calls a variant
AGAINST_TOL = 2e-2   # one bf16 rounding of the output, as chip_smoke's
SERVE_ARCH, SERVE_LAYERS = "qwen3-moe-235b-a22b", 8
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, PROFILE_STEPS = 8, 1024, 64, 8


def variant_source(patches) -> str:
    src = (_build.CSRC / "moe_gmm.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"csrc/moe_gmm.cu holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_variants(variants: dict, against=None) -> dict:
    """Compile every variant (and ``against``, a path, as the variant
    "against") in parallel; their moe_gmm_fwd entries."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(patches)
               for name, patches in variants.items()}
    includes = {name: [] for name in sources}
    if against is not None:
        sources["against"] = against.read_text()
        includes["against"] = ["-I", str(against.resolve().parent)]
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"moe_gmm_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *includes[name], "-I",
             str(_build.CSRC), "-o", str(out_dir / f"lib{name}.so"),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and NO_SPILL not in ln]
        if proc.returncode != 0 or spills:
            why = f"nvcc failed:\n{log}" if proc.returncode else \
                f"spills: {spills}"
            if i == 0:   # the source as it stands
                raise RuntimeError(f"variant {name}: {why}")
            print(f"[build] variant {name} left out: {why[-2000:]}",
                  flush=True)
            continue
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).moe_gmm_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, x, w, ids, out, block_t: int) -> None:
    (t, k), (e, _, n) = x.shape, w.shape
    err = fn(x.data_ptr(), w.data_ptr(), ids.data_ptr(), out.data_ptr(), t,
             k, n, e, block_t,
             mg.KERNEL_CODES[mg.kernel_for(x.dtype, block_t)],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe_gmm variant launch failed: CUDA error {err}")


def time_in_turns(calls: dict, rounds: int) -> dict:
    """Device ms of each call of each variant, the variants called in
    turns, forward then back, ``rounds`` times."""
    names = list(calls)
    events = {v: [] for v in names}
    for _ in range(rounds):
        for v in names + names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[v]()
            end.record()
            events[v].append((start, end))
    torch.cuda.synchronize()
    return {v: [s.elapsed_time(e) for s, e in ev] for v, ev in events.items()}


def quantile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def time_cases(fns: dict, cases, repeat: int = 0) -> None:
    """Every variant at every case, in turns; one JSON line a case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(fns)
    base = names[0]
    for case, e, rows, k, n, bt in cases:
        ids = torch.arange(e, dtype=torch.int32, device="cuda") \
            .repeat_interleave(rows // bt)
        x = torch.randn(ids.numel() * bt, k, device="cuda",
                        generator=gen).to(torch.bfloat16)
        w = (torch.randn(e, k, n, device="cuda", generator=gen)
             * k ** -0.5).to(torch.bfloat16)
        mg.check_args(x, w, ids, bt)
        outs = {v: torch.empty(x.shape[0], n, dtype=x.dtype, device="cuda")
                for v in names}
        for v in names:
            call(fns[v], x, w, ids, outs[v], bt)
        torch.cuda.synchronize()
        same = {}
        for v in names:
            same[v] = (torch.allclose(outs[v].float(), outs[base].float(),
                                      rtol=AGAINST_TOL, atol=AGAINST_TOL)
                       if v == "against"
                       else torch.equal(outs[v], outs[base]))
            if not same[v] and v not in MAY_RACE:
                raise RuntimeError(f"{case}: variant {v} differs from {base}")
        differ = {}
        for v in names:
            first, again = outs[v].clone(), torch.empty_like(outs[v])
            differ[v] = 0
            for _ in range(repeat):
                call(fns[v], x, w, ids, again, bt)
                differ[v] += int(not torch.equal(again, first))
        calls = {v: (lambda v=v: call(fns[v], x, w, ids, outs[v], bt))
                 for v in names}
        time_in_turns(calls, 2)   # warm-up
        ms = time_in_turns(calls, ROUNDS)
        print(json.dumps({
            "case": case, "shape": [x.shape[0], k, n], "block_t": bt,
            "kernel": mg.kernel_for(x.dtype, bt), "calls": len(ms[base]),
            "matches_base": same, "repeats": repeat,
            "repeats_differing_from_first": differ,
            "median_ms": {v: quantile(r, 0.5) for v, r in ms.items()},
            "p10_ms": {v: quantile(r, 0.1) for v, r in ms.items()},
            "p90_ms": {v: quantile(r, 0.9) for v, r in ms.items()}}),
            flush=True)
        del x, w, outs
        torch.cuda.empty_cache()


def serve_in_turns(fns: dict) -> None:
    """Qwen3-MoE served with each library in the gmm's wrapper, in turns
    (other, this, this, other): decode ms a step, then 8 decode steps
    under torch.profiler, the gmm's device ms and share of busy."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import exec_config, generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    ex = exec_config(cfg, torch.bfloat16, "cuda")
    model_fns = build_model(cfg)
    model = model_fns.init(0, ex)
    batch = model_fns.make_batch(1, ShapeConfig(
        "serve", "prefill", SERVE_PROMPT, SERVE_BATCH), ex)
    tok = batch["tokens"][:, -1]
    decode = make_serve_step(cfg, ex)
    kept = mg._fn
    try:
        for v in ("against", "decode_base", "decode_base", "against"):
            mg._fn = lambda v=v: fns[v]
            generate(cfg, ex, SERVE_PROMPT, 4, SERVE_BATCH, 0, model=model)
            g = generate(cfg, ex, SERVE_PROMPT, SERVE_GEN, SERVE_BATCH, 0,
                         model=model)
            cache = model_fns.init_cache(SERVE_BATCH,
                                         SERVE_PROMPT + PROFILE_STEPS, ex)
            decode(model, cache, tok, SERVE_PROMPT)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(PROFILE_STEPS):
                    decode(model, cache, tok, SERVE_PROMPT + i)
                torch.cuda.synchronize()
            by_key = [(e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            busy = sum(ms for _, ms in by_key)
            gmm = sum(ms for key, ms in by_key if "gmm_" in key)
            print(json.dumps({
                "serve": cfg.name, "layers": cfg.n_layers, "variant": v,
                "decode_ms_per_step": g.decode_s * 1e3 / (SERVE_GEN - 1),
                "prefill_ms": g.prefill_s * 1e3,
                "profiled_decode_steps": PROFILE_STEPS,
                "device_busy_ms": busy, "gmm_device_ms": gmm,
                "gmm_share_of_busy": gmm / busy if busy else None,
                "gmm_kernels": sorted({key[:60] for key, _ in by_key
                                       if "gmm_" in key})}), flush=True)
    finally:
        mg._fn = kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", action="store_true",
                    help="the decode kernel's variants at the decode shapes")
    ap.add_argument("--against", type=pathlib.Path,
                    help="another moe_gmm.cu, built as the variant 'against'")
    ap.add_argument("--serve", action="store_true",
                    help="serve Qwen3-MoE with 'against' and this kernel")
    ap.add_argument("--repeat", type=int, default=0,
                    help="calls more of each variant a shape, each held to "
                         "its first call's output bit for bit")
    args = ap.parse_args(argv)
    if args.serve and (args.against is None or not args.decode):
        ap.error("--serve needs --decode and --against")
    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    fns = build_variants(DECODE_VARIANTS if args.decode else VARIANTS,
                         args.against)
    print(f"[build] {len(fns)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    time_cases(fns, DECODE_CASES if args.decode else CASES, args.repeat)
    if args.serve:
        serve_in_turns(fns)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f"[done] in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
