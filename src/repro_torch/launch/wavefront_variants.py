"""Time variants of the event wavefront kernel against each other on one
card: a record's packed level codes staged in shared memory beside its
history, against codes loaded into registers a chunk of levels at a time
(32 levels a chunk, or 16).

Each variant is ``csrc/wavefront.cu`` with one piece of text replaced, built
by its own ``nvcc`` (all at once) into ``build/kernels/variants/``, and
called through ``kernels/wavefront.py::wavefront`` with its library in
place of the built one.  At each of ``chip_smoke.py``'s wavefront shapes
the variants are timed call by call in turns, forward then back, by CUDA
events around each call (the wrapper's host work included), and by the
device time of their kernels under torch.profiler.  Every variant's output
must equal the unchanged kernel's bit for bit.  Run from the repo root on
a machine with a card and the CUDA toolkit:

    PYTHONPATH=src python -m repro_torch.launch.wavefront_variants

Prints one JSON line per shape and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.events.batch import _key_tables
from repro_torch.kernels import _build
from repro_torch.kernels import wavefront as wf
from repro_torch.launch.gmm_variants import NO_SPILL, quantile, time_in_turns

STAGE_LINE = "constexpr bool kStageCodes = true;"
CHUNK_LINE = "constexpr int kChunk = 32;"
VARIANTS = {
    "base": [],
    "codes_in_registers": [(STAGE_LINE, "constexpr bool kStageCodes = false;")],
    "chunk16": [(CHUNK_LINE, "constexpr int kChunk = 16;")],
}
# chip_smoke.py's wavefront cases: name, shape keys (schedule, pp, v,
# n_micro), records
CASES = [
    ("gpipe", [("gpipe", 16, 1, 64)], 32),
    ("interleaved", [("interleaved", 16, 4, 64)], 32),
    ("mixed", [("gpipe", 16, 1, 64), ("1f1b", 8, 1, 32),
               ("interleaved", 16, 4, 64), ("interleaved", 2, 2, 8)], 32),
    ("device_memory_history", [("gpipe", 64, 1, 512)], 8),
]
ROUNDS = 40


def variant_source(patches) -> str:
    src = (_build.CSRC / "wavefront.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"csrc/wavefront.cu holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant in parallel -> its loaded library."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        src = out_dir / f"wavefront_{name}.cu"
        src.write_text(variant_source(patches))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"libwavefront_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and NO_SPILL not in ln]
        if spills:
            raise RuntimeError(f"variant {name} spills: {spills}")
        libs[name] = ctypes.CDLL(str(out_dir / f"libwavefront_{name}.so"))
    return libs


def use(lib) -> None:
    """Route ``wf.wavefront`` through ``lib``."""
    fn = lib.wavefront_fwd
    fn.argtypes = wf._fn().argtypes
    fn.restype = ctypes.c_int
    size = lib.wavefront_shared_bytes
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    size.restype = ctypes.c_longlong
    wf._fn = lambda: fn
    wf.shared_bytes = lambda S, L: int(size(S, L))


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call's kernels under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kept = wf._fn, wf.shared_bytes
    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for case, keys, k in CASES:
            tabs = [torch.tensor(t).cuda() for t in _key_tables(tuple(keys))]
            key_rows = torch.tensor(rng.randint(0, len(keys), k),
                                    dtype=torch.int32, device="cuda")
            rows = torch.rand(6, k, dtype=torch.float64, device="cuda",
                              generator=gen) * 1e-2 + 1e-3
            args = (*tabs, key_rows, rows)
            outs, dev = {}, {}
            for v, lib in libs.items():
                use(lib)
                outs[v] = wf.wavefront(*args)
                dev[v] = device_ms(lambda: wf.wavefront(*args))
            for v in libs:
                if not torch.equal(outs[v], outs["base"]):
                    raise RuntimeError(f"{case}: variant {v} differs")
            calls = {}
            for v, lib in libs.items():
                def call(lib=lib):
                    use(lib)
                    wf.wavefront(*args)
                calls[v] = call
            time_in_turns(calls, 2)
            ms = time_in_turns(calls, ROUNDS)
            print(json.dumps({
                "case": case, "shape": [len(keys), k, *tabs[0].shape[1:]],
                "device_ms": dev,
                "median_ms": {v: quantile(r, 0.5) for v, r in ms.items()},
                "p10_ms": {v: quantile(r, 0.1) for v, r in ms.items()},
                "p90_ms": {v: quantile(r, 0.9) for v, r in ms.items()}}),
                flush=True)
    finally:
        wf._fn, wf.shared_bytes = kept
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f"[done] in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
