"""Time variants of the grouped matmul's wgmma kernel against each other on
one card: the order in which the persistent blocks walk the tiles, the
consumers reading each tile's expert id one tile ahead, and 128-column
tiles at block_t 128.

Each variant is ``csrc/moe_gmm.cu`` with one piece of text replaced, built
by its own ``nvcc`` (all at once) into ``build/kernels/variants/``.  At each
prefill shape of ``chip_smoke.py`` the variants are timed call by call in
turns, forward then back, by CUDA events around each call, so that a drift
of the card's clock under sustained load falls on all of them alike; each
reports the median and the 10th and 90th percentiles of its calls.  Every
variant's output must equal the unchanged kernel's bit for bit.
Run from the repo root on a machine with a card and the CUDA toolkit:

    PYTHONPATH=src python -m repro_torch.launch.gmm_variants

Prints one JSON line per shape and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
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
# chip_smoke.py's prefill cases: name, experts, rows per expert, K, N,
# block_t
CASES = [
    ("qwen3_prefill", 128, 640, 4096, 1536, 128),
    ("qwen3_prefill_w2", 128, 640, 1536, 4096, 128),
    ("mixtral_prefill", 8, 2560, 4096, 14336, 128),
    ("bt64", 32, 192, 2048, 1024, 64),
]
ROUNDS = 40   # each a pass forward and a pass back: 80 calls a variant


def variant_source(patches) -> str:
    src = (_build.CSRC / "moe_gmm.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"csrc/moe_gmm.cu holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant in parallel; their moe_gmm_fwd entries."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        src = out_dir / f"moe_gmm_{name}.cu"
        src.write_text(variant_source(patches))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and NO_SPILL not in ln]
        if spills:
            raise RuntimeError(f"variant {name} spills: {spills}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).moe_gmm_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, x, w, ids, out, block_t: int) -> None:
    (t, k), (e, _, n) = x.shape, w.shape
    err = fn(x.data_ptr(), w.data_ptr(), ids.data_ptr(), out.data_ptr(), t,
             k, n, e, block_t, mg.KERNEL_CODES["wgmma"],
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


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    fns = build_variants()
    print(f"[build] {len(fns)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = list(fns)
    for case, e, rows, k, n, bt in CASES:
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
        for v in names:
            if not torch.equal(outs[v], outs["base"]):
                raise RuntimeError(f"{case}: variant {v} differs from base")
        calls = {v: (lambda v=v: call(fns[v], x, w, ids, outs[v], bt))
                 for v in names}
        time_in_turns(calls, 2)   # warm-up
        ms = time_in_turns(calls, ROUNDS)
        print(json.dumps({
            "case": case, "shape": [x.shape[0], k, n], "block_t": bt,
            "col_tiles": -(-n // 256), "calls": len(ms["base"]),
            "median_ms": {v: quantile(r, 0.5) for v, r in ms.items()},
            "p10_ms": {v: quantile(r, 0.1) for v, r in ms.items()},
            "p90_ms": {v: quantile(r, 0.9) for v, r in ms.items()}}),
            flush=True)
        del x, w, outs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f"[done] in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
