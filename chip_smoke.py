#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build  - compile every CUDA kernel (the serving paths' four and the
   study's wavefront) from ``src/repro_torch/csrc`` (one nvcc per source,
   all in parallel), and report each kernel instantiation's registers,
   spills and tensor-core instructions; the gmm's wgmma kernels must not
   spill and must hold HGMMA, its decode kernels and the SSD's bf16
   kernels must not spill and must hold HMMA;
2. kernels - hold each kernel against its plain PyTorch version on the
   card at the serving paths' shapes (the wavefront at the study's: gpipe,
   1f1b, interleaved, mixed keys up to S 16 x L 542, and a key too large
   for shared memory), and time the kernel, the plain version and the one
   PyTorch call that computes the same function (flash also at Sq != Sk:
   Whisper's cross-attention, 384 queries over 1500 encoder frames, its
   encoder, and a causal mask and window at the offset position; the gmm
   also with ids outside [0, E), the wavefront with key indices outside
   [0, U); the SSD's final state of every case against the plain
   version's, with its launches and workspace);
2b. lint - ``repro_torch.analysis.run_lint`` over the tree, as ``python -m
   repro_torch.cli lint`` runs it: baseline-exact against
   ``chiplint_torch_baseline.json``, the findings by rule printed; then
   the torch-hygiene rule's verdicts against the card: each registered
   entry point is linted alone, and the ones with a finding on the card's
   path (the gmm's backward: its dw's ``.tolist()``) must raise under
   ``torch.cuda.set_sync_debug_mode("error")``, every other must run
   under it (warmed up first, inputs already on the card): the cost terms
   ``_terms_core`` on the scan's staged batch, the wavefront,
   ``decode_attention``, and the forward and backward of rmsnorm, the
   SSD, the gmm (forward, at block_t 128 and on the decode kernel at 8)
   and flash at small shapes;
3. six serving paths, each with seeded random weights at full width,
   bf16: TinyLlama-1.1B (22 layers; flash + rmsnorm), Zamba2-7B (81 Mamba2
   layers + 13 applications of the shared attention block; ssd_scan +
   flash at head_dim 112 + rmsnorm), Qwen3-MoE-235B-A22B cut to 8 of
   its 94 layers, which one 80 GB card holds (128 experts, top-8; moe_gmm
   + flash at head_dim 128 + rmsnorm with qk-norm), Mamba2-780M (48
   layers; ssd_scan with its final state, handed to decode, + rmsnorm),
   LLaVA-NeXT-34B cut to 12 of its 60 layers (576 prefix embeddings
   in the prompt; flash with 56 query heads over 8 KV heads + rmsnorm)
   and Whisper-medium (24 encoder layers over 1500 frames, 24 decoder
   layers with cross-attention; flash non-causal, causal and at Sq != Sk,
   + rmsnorm).  For each:
   serve   - ``repro_torch.launch.serve.generate`` with batch 8, a
             1024-token prompt (Whisper 384) and 64 new tokens, counting
             kernel launches (every count set to 0 just before, read just
             after);
   profile - one prefill (for Whisper also its encoder alone) and 8
             decode steps under torch.profiler (device time by kernel,
             device idle share);
   check   - the same port at full width and cut depth (TinyLlama 2
             layers, Zamba2 7 = one period + one leftover layer, Qwen3-MoE
             1, Mamba2 2, LLaVA 1 with a 640-token prompt, Whisper 2 + 2
             over 1500 frames with a 384-token prompt) in float32, on
             the card and on the CPU (plain versions) from the same
             weights, prefix embeddings and encoder frames: prefill
             logits and the first 8 greedy tokens must agree.
4. study  - ``repro_torch``'s ``Study.run()`` on the card for every
   committed scenario (the batched drivers' and the outer MCM search's
   ``paper_qwen3_outer``), ``paper_qwen3`` under the ``railx`` driver,
   two with the schedule as a search dimension (validate_top 8) and the
   outer search with its event replay (``event_replay`` 2, every schedule
   a candidate), counting every kernel's launches (set to 0 just before,
   read just after: the wavefront's must equal the studies' replay calls,
   the serving kernels' 0), each held against the CPU path (identical
   records, metrics within 1e-12; the outer search's trace round by
   round), with the study.* and outer.round spans' times;
5. scan   - ``batched_simulate`` on the BENCH_dse.json TinyLlama cell
   (3,072 design points) tiled to 30,720, 307,200 and 3,072,000 rows, on
   the card and through the CPU path, the whole call and the cost terms
   alone, card and CPU equal bit for bit; prints the crossover;
6. calibrate - ``python -m repro_torch.cli calibrate`` on the card over
   the full grid, writing ``build/calib_h100.json``: every count set to 0
   just before, read just after; flash (forward, and forward + torch-op
   backward), ``moe_gmm``, ``ssd_scan`` and ``rmsnorm`` must each launch
   warm-up + reps times per grid point, every row of theirs must name its
   hand kernel (read from the launch counts), no measured rate nor
   fitted peak may pass the card's float32 or HBM peak, and no fit's half
   may sit at the top of its search (a rate that never bent); then
   ``paper_qwen3`` on the fitted constants, on the card and on the CPU
   path, with identical records;
7. grad   - rmsnorm, the SSD (with and without its state), the gmm and
   flash through ``ops`` at the train and serving shapes of every family,
   bf16 and fp32 (flash also non-causal and at Sq != Sk: Whisper's
   cross-attention and encoder; the gmm at Mixtral's w1 and w2): the
   output has a grad_fn on the card, each input's gradient matches
   autograd through the plain version on the same tensors, and forward +
   backward is timed with its bound, the plain version and the library;
8. train  - one path a family at full width, random weights from seed 0,
   float32 master weights and bf16 compute, batch 8 x 1024 through
   ``launch.steps.make_train_step``: TinyLlama-1.1B and Mamba2-780M at
   full depth, Mixtral-8x7B at 2 of 32 layers (the router's aux loss; the
   gmm's dx on the kernel), LLaVA-NeXT-34B at 2 of 60 (the loss masked
   over the 576 prefix positions), Zamba2-7B at 15 of 81 (the shared
   block applied twice) and Whisper-medium at 24 + 24 (8 x 384 decoder
   tokens over 1500 frames).  Each: 3 warm-up and 10 timed steps (5 for
   Mamba2 and Zamba2; step ms, tokens/s, model FLOP/s, peak memory
   beside the reckoned 18 B a parameter of state), the launches of one
   step (the forward's, and the gmm's dx in the backward), one profiled
   step (forward, backward by node, optimiser, kernel classes, idle
   share), remat (``ExecConfig.remat``): from that state and one batch a
   ``make_grad_step`` under "none" and one under "full" (TinyLlama also
   "dots", its gradients element by element against "none"'s), the loss
   and every gradient norm within 1e-3 (bit for bit logged), the bytes
   held at the forward's end below "none"'s and each peak not above it
   (TinyLlama's peaks none > dots > full), "full"'s launches counted
   (each wrapped layer's forward kernels again), TinyLlama's 3 steps
   timed under "full"; 10
   steps on one fixed batch whose loss must fall, and a cut depth at full
   width, batch 2
   (TinyLlama, Mamba2 2 layers x 256; Mixtral 1 x 256; LLaVA 1 x 640;
   Zamba2 7 x 256; Whisper 2 + 2 x 256 over 1500 frames): one step on
   the card against the CPU in float32 (loss, every gradient, m, v; a
   parameter past the tolerance has its gradient held against the CPU
   in float64, within twice the CPU's float32 error + the tolerance; the
   update against the CPU's AdamW on the card's gradients), and each
   gradient's bf16 error against its device's float32 one, the card's
   (the kernels) within twice the CPU's (the plain versions) + 1e-3.
9. validate - ``python -m repro_torch.cli validate`` over the nine
   committed scenarios (top 4; gpipe, 1f1b, interleaved) on the CPU and
   on the card: identical rows and no violation; each scenario's 8
   pipelined records compiled by ``compile_batch`` and replayed on the
   card's wavefront, each held against the scalar engine's replay
   (gpipe and 1f1b within 5%, interleaved printed); ``timeline`` and a
   study with ``--trace`` on the card, each trace checked by
   ``validate_chrome_trace`` (the study's holds the ``study.*`` stage
   spans), with the device tracks' busy and idle; the wavefront's
   launches counted (every count set to 0 just before the card's runs).
10. resume - TinyLlama-1.1B at full width, 4 of 22 layers, batch 8 x
   1024, float32 master weights and bf16 compute, through
   ``launch.train``'s pieces (``DataPipeline``, ``CheckpointManager``,
   ``FaultTolerantLoop``): 8 steps straight with a checkpoint every 4
   (the launches counted); step 8's COMMITTED marker removed, as by a
   crash mid-write; a fresh state from another seed resumed at step 4
   must equal the saved state bit for bit (parameters, m, v, step, the
   pipeline's seed and step) and run to 8 with the straight run's
   losses; then SIGTERM at step 2 of a third run must end it at step 2
   with a committed checkpoint.  Prints the step ms with and without a
   write in flight, each write's seconds and GB/s and the straggler
   steps; ``build/ckpt_smoke`` is deleted at the end.
11. shard - the sharded trainer (``launch.train.build_sharded_train``)
   on a one-rank NCCL group (a file store, no port) and its (1, 1)
   ("data", "model") mesh: TinyLlama-1.1B at full width and depth, batch
   8 x 1024, bf16 compute, 3 steps through it and 3 through
   ``make_train_step`` from the same init and batches (losses and every
   parameter bit for bit, else the largest difference; the sharded
   steps' launches counted), then 2 steps each under remat "full", bit
   for bit; Mixtral-8x7B at full width, 1 of 32 layers,
   ``moe_impl="a2a"``: a warm-up step and a counted one (the gmm's 6
   launches), the first step again under remat "full" (its loss and
   gradient norms within 1e-3 of the plain one's; the gmm's forward and
   the all-to-alls run again in the backward); then its MoE layer at 8 x
   1024 tokens, where ``cap_exp``
   equals ``capacity()`` (2560 rows an expert, block_t 128 on the wgmma
   kernel): the a2a against the dense ``moe_apply`` (y, aux, every
   gradient) and the a2a's gmm against its plain version.  Prints step
   ms, peak memory, launches and the world size.
12. dryrun - ``python -m repro_torch.launch.dryrun`` in three
   subprocesses, started together before the train phase, whose steps
   keep the card busy, and read after ``shard``, each cell under the
   dry run's remat "full": TinyLlama-1.1B ``train_4k`` on the single-pod
   (16, 16) mesh of a 256-rank fake group, over fake CUDA tensors and
   over fake CPU tensors (120 s each from their start): the all-gather
   and reduce-scatter wire bytes must equal the sums ``param_specs``
   gives (to 1e-9 relative), 44 flash and 89 rmsnorm fake calls, FLOPs
   above and peak below the cell without remat, the two records must
   agree in every FLOP, byte and count; Qwen3-MoE-235B-A22B ``train_4k``
   on the two-pod (2, 16, 16) mesh of a 512-rank group over fake CUDA
   tensors (600 s): its reduce-scatter the spec sum, its all-reduce
   within twice the single pod's.  None may launch a kernel.  Prints
   each cell's record and wall time.

A failing check prints ``[fail] <phase>: <message>`` and exits 1.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

    torchrun --standalone --nproc-per-node 4 chip_smoke.py --ranks

runs the sharded trainer alone across the cards of one host (NCCL, a
card a rank; ``--device cpu --reduced`` on gloo over the reduced
configs): TinyLlama-1.1B at full depth on a (world, 1) mesh against one
card's ``make_train_step``; Mixtral-8x7B at full width, 1 layer, over
the all-to-all on (world, 1) against one card's ``make_train_step`` with
accum = world (each microbatch routed on its own, as each data rank's
tile is), then 2 layers on (world / 2, 2), the all-to-all between the
cards: losses and step 1's gradients against the one card's, each
rank's step ms, peak memory, state and launches.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 FMA pipes, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
WHISPER_PROMPT = 384     # + SERVE_GEN = Whisper's 448-token decoder context
CHECK_BATCH, CHECK_TOKENS = 2, 8
SEED = 0


def log(phase: str, msg) -> None:
    if not isinstance(msg, str):
        msg = json.dumps(msg)
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of one call, by
    CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Mean device time of one call, by kernel: the kernels' own time under
    torch.profiler over ``iters`` calls, without the host's gaps between
    them (a small kernel's back-to-back calls wait on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+_kernel)(<[^>]*>)?", e.key)
            name = m.group(0) if m else e.key[:60]
            names[name] = (names.get(name, 0.0)
                           + e.self_device_time_total / 1e3 / iters)
    return names


def device_ms(fn, iters: int) -> float:
    return sum(device_ms_by_kernel(fn, iters).values())


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    sources = ["rmsnorm", "flash_attention", "ssd_scan", "moe_gmm",
               "wavefront"]
    _build.build_all(sources)
    log("build", f"{len(sources)} sources in {time.perf_counter() - t0:.2f}s "
        f"into {_build.BUILD_DIR}")
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    reports = {name: build_report(_build.BUILD_LOG[name]["log"],
                                  _build.BUILD_DIR / f"lib{name}.so")
               for name in sources}
    log("build", reports)
    # the gmm's wgmma kernels: on the tensor cores' wgmma path, no spill;
    # its decode kernels on mma.sync, no spill
    gmm = reports["moe_gmm"]
    counts = gmm["sass"].get("tensor_core_instructions", {})
    for prefix, n_inst, op in (("gmm_wgmma_kernel", 2, "HGMMA"),
                               ("gmm_decode_kernel", 3, "HMMA")):
        insts = sorted(k for k in gmm["ptxas"] if k.startswith(prefix))
        check(len(insts) == n_inst,
              f"moe_gmm: {n_inst} {prefix} instantiations, got {insts}")
        for name in insts:
            check(gmm["ptxas"][name].get("spills") == NO_SPILL,
                  f"{name}: no spill ({gmm['ptxas'][name]})")
            check(counts.get(name, {}).get(op, 0) > 0,
                  f"{name}: {op} in its SASS ({counts.get(name)})")
    # the SSD's bf16 kernels: on the tensor cores (mma.sync), no spill
    ssd = reports["ssd_scan"]
    counts = ssd["sass"].get("tensor_core_instructions", {})
    tc = sorted(k for k in ssd["ptxas"] if k.startswith(
        ("chunk_state_kernel", "chunk_scan_kernel")))
    check(len(tc) == 8, f"ssd_scan: 4 chunk-state and 4 chunk-scan "
          f"instantiations, got {tc}")
    for name in tc:
        check(ssd["ptxas"][name].get("spills") == NO_SPILL,
              f"{name}: no spill ({ssd['ptxas'][name]})")
        check(counts.get(name, {}).get("HMMA", 0) > 0,
              f"{name}: HMMA in its SASS ({counts.get(name)})")


def _kernel_name(mangled: str) -> str:
    """``fa_wgmma_kernel<128, 112>`` from its mangled name."""
    m = re.search(r"\d+([a-z_]+?_kernel)(?:I(.*?)EE)?", mangled)
    if not m:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    names = {"13__nv_bfloat16": "bf16", "f": "float", "Lb0": "false",
             "Lb1": "true"}
    args = [names.get(t, t[2:]) for t in re.findall(
        r"13__nv_bfloat16|Lb[01]|Li\d+|f", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def build_report(ptxas_log: str, lib: pathlib.Path) -> dict:
    """Registers, static shared memory and spills of each kernel
    instantiation (from ``-Xptxas -v``; dynamic shared memory is set at
    launch), the compiler's warnings, and the tensor-core instructions in
    the SASS (``cuobjdump``, where the toolkit has it)."""
    per_kernel, name = {}, None
    warnings = [line.strip() for line in ptxas_log.splitlines()
                if "warning" in line.lower()]
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
            per_kernel[name] = {}
        elif name and "spill stores" in line:
            per_kernel[name]["spills"] = line.split(":", 1)[-1].strip()
        elif name and "Used" in line and "registers" in line:
            per_kernel[name]["usage"] = line.split(":", 1)[-1].strip()
    sass = {"cuobjdump": None}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if pathlib.Path(cuobjdump).exists():
        out = subprocess.run([cuobjdump, "-sass", str(lib)],
                             capture_output=True, text=True, timeout=300).stdout
        counts, fn = {}, None
        for line in out.splitlines():
            if "Function :" in line:
                fn = _kernel_name(line.split("Function :", 1)[1].strip())
                counts[fn] = {"HMMA": 0, "HGMMA": 0}
            elif fn:
                for op in ("HGMMA", "HMMA"):
                    if f" {op}." in line:
                        counts[fn][op] += 1
                        break
        sass = {"cuobjdump": cuobjdump, "tensor_core_instructions": counts}
    return {"ptxas": per_kernel, "warnings": warnings, "sass": sass}


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def _attn_mask(sq: int, sk: int, window, causal: bool) -> torch.Tensor:
    """The (Sq, Sk) boolean mask of the kernel (True: attend), query i at
    position i + Sk - Sq, on the card."""
    r = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    c = torch.arange(sk, device="cuda")[None, :]
    keep = (r - c) < (window or sk + 1)
    return keep & (c <= r) if causal else keep


BF16, FP32, FP64 = torch.bfloat16, torch.float32, torch.float64
FLASH_CASES = [
    # name, b, hq, hkv, sq, sk, d, window, softcap, causal, dtype
    ("main", 8, 32, 4, 1024, 1024, 64, None, 0.0, True, BF16),
    ("ragged", 2, 32, 4, 1000, 1000, 64, None, 0.0, True, BF16),
    ("window_softcap", 2, 8, 4, 1024, 1024, 64, 256, 50.0, True, BF16),
    ("noncausal", 2, 32, 4, 1000, 1000, 64, None, 0.0, False, BF16),
    ("fp32", 2, 32, 4, 512, 512, 64, None, 0.0, True, FP32),
    ("d128", 1, 16, 8, 300, 300, 128, 100, 0.0, True, BF16),
    ("d32", 1, 8, 2, 130, 130, 32, None, 30.0, False, FP32),
    # head_dim 16: the reduced configs (``--reduced``) on the card
    ("d16", 2, 4, 2, 77, 77, 16, 16, 0.0, True, BF16),
    # head_dim 112: Zamba2-7B's shared block, at its prefill shape
    ("d112_zamba2", 8, 32, 32, 1024, 1024, 112, None, 0.0, True, BF16),
    ("d112_fp32_ragged", 1, 4, 4, 200, 200, 112, None, 0.0, True, FP32),
    # head_dim 256: gemma2-2b, window 256 (masks at S=1024), softcap 50
    ("d256_gemma2", 2, 8, 4, 1024, 1024, 256, 256, 50.0, True, BF16),
    ("d256_fp32", 1, 2, 1, 130, 130, 256, None, 0.0, False, FP32),
    # head_dim 128: Qwen3-MoE's prefill shape (64 query heads, 4 kv heads)
    ("d128_qwen3", 8, 64, 4, 1024, 1024, 128, None, 0.0, True, BF16),
    # LLaVA-NeXT-34B's prefill shape: 56 query heads over 8 KV heads, a
    # GQA group of 7 (not a power of two)
    ("d128_llava", 8, 56, 8, 1024, 1024, 128, None, 0.0, True, BF16),
    # float32 and bfloat16 run different kernels (FMA pipes, tensor
    # cores): each fp32-only shape above has a bf16 twin
    ("d32_bf16", 1, 8, 2, 130, 130, 32, None, 30.0, False, BF16),
    ("d112_bf16_ragged", 1, 4, 4, 200, 200, 112, None, 0.0, True, BF16),
    ("d256_bf16", 1, 2, 1, 130, 130, 256, None, 0.0, False, BF16),
    # a window and an S that are multiples of no tile
    ("window_ragged", 2, 32, 4, 1000, 1000, 64, 100, 0.0, True, BF16),
    # head_dims below the width they are stored at, through every bf16
    # instantiation (64; 128; 128 at N=112; 256), with a softcap, windows
    # and a non-causal window
    ("d8_bf16", 1, 4, 2, 200, 200, 8, None, 0.0, True, BF16),
    ("d24_bf16_window", 1, 4, 2, 200, 200, 24, 50, 0.0, True, BF16),
    ("d40_bf16_noncausal", 1, 4, 1, 200, 200, 40, None, 0.0, False, BF16),
    ("d72_bf16_softcap", 1, 4, 2, 200, 200, 72, None, 20.0, True, BF16),
    ("d104_bf16", 1, 4, 4, 333, 333, 104, None, 0.0, True, BF16),
    ("d120_bf16_window", 1, 4, 2, 200, 200, 120, 64, 0.0, True, BF16),
    ("d136_bf16", 1, 2, 1, 200, 200, 136, None, 0.0, True, BF16),
    ("d248_bf16_noncausal_window", 1, 2, 2, 300, 300, 248, 100, 0.0, False,
     BF16),
]
# Cross-attention (Sq != Sk, q at the last Sq of the Sk positions) and
# Whisper-medium's shapes: batch 8, 16 heads of 64, 1500 encoder frames, a
# 384-token prompt.  They draw from a generator of their own, so every
# case above and every later phase keeps the inputs it had without them.
FLASH_CROSS_CASES = [
    # the decoder's cross-attention at prefill, the encoder, and the
    # decoder's causal self-attention over the prompt
    ("whisper_cross", 8, 16, 16, 384, 1500, 64, None, 0.0, False, BF16),
    ("whisper_encoder", 8, 16, 16, 1500, 1500, 64, None, 0.0, False, BF16),
    ("whisper_decoder_self", 8, 16, 16, 384, 384, 64, None, 0.0, True, BF16),
    # a causal mask and a window measured from the offset position, Sq < Sk
    # (both kernels), and more queries than keys without a mask
    ("offset_causal_window", 2, 8, 4, 300, 1000, 64, 200, 0.0, True, BF16),
    ("offset_causal_window_fp32", 2, 8, 4, 300, 1000, 64, 200, 0.0, True,
     FP32),
    ("cross_sq_over_sk_fp32", 1, 8, 2, 500, 130, 64, None, 0.0, False, FP32),
    ("cross_sq_over_sk_bf16", 1, 8, 2, 500, 130, 64, 64, 30.0, False, BF16),
]
# cases timed as well as checked; "main" is TinyLlama's prefill shape
FLASH_TIMED = ("main", "d112_zamba2", "d256_gemma2", "d128_qwen3",
               "d128_llava", "whisper_cross", "whisper_encoder",
               "whisper_decoder_self", "offset_causal_window")
# tolerances: bf16 outputs differ by one bf16 rounding (2e-2 as in the
# reference's kernel sweeps); fp32 by the order of sums and exp2/log.
FLASH_TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


def phase_flash(gen):
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    timed = {}
    cross_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [(c, gen) for c in FLASH_CASES] + [
        (c, cross_gen) for c in FLASH_CROSS_CASES]
    for (name, b, hq, hkv, sq, sk, d, win, cap, causal, dt), g in cases:
        q = torch.randn(b, hq, sq, d, device="cuda", generator=g).to(dt)
        k = torch.randn(b, hkv, sk, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, hkv, sk, d, device="cuda", generator=g).to(dt)
        kw = {"causal": causal, "softcap": cap}
        o, lse = fa.flash_attention_fwd(q, k, v, win, **kw)
        o_p, lse_p = fa.flash_attention_plain(q, k, v, win, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        lse_err = (lse - lse_p).abs().max().item()
        o_tol, lse_tol = FLASH_TOL[dt]
        rec = {"case": name, "shape": [b, hq, hkv, sq, sk, d],
               "dtype": str(dt),
               "window": win, "softcap": cap, "causal": causal,
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tol": o_tol, "lse_tol": lse_tol}
        check(bool(torch.isfinite(o.float()).all()), f"flash {name}: finite")
        check(err <= o_tol and lse_err <= lse_tol,
              f"flash {name}: kernel vs plain {err} (tol {o_tol}), lse "
              f"{lse_err} (tol {lse_tol})")
        if name in FLASH_TIMED:
            # K and V over the keys some query needs (all of them at
            # Sq == Sk; the last Sq + window - 1 under an offset window)
            flops, nbytes = cost.flash_fwd_cost(b, hq, hkv, sq, sk, d, win,
                                                causal, q.element_size())
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, dt)
            rec["ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v, win,
                                                               **kw), 20)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["plain_ms"] = time_ms(
                lambda: fa.flash_attention_plain(q, k, v, win, **kw), 5)
            # no single PyTorch call takes a softcap; SDPA's is_causal is
            # aligned top-left at Sq != Sk, so a window or an offset causal
            # mask goes in as an explicit boolean mask, built outside the
            # timed call and held against the plain version once
            if cap:
                library = None
            elif win is None and (sq == sk or not causal):
                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True)
            else:
                mask = _attn_mask(sq, sk, win, causal)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
                lib_err = (library().float() - o_p.float()).abs().max().item()
                rec["library_max_abs_err"] = lib_err
                check(lib_err <= o_tol, f"flash {name}: SDPA with the mask "
                      f"vs plain {lib_err} (tol {o_tol})")
            rec["library_ms"] = time_ms(library, 20) if library else None
            timed[name] = rec
        log("kernel", {"name": "flash_attention_fwd", **rec})
    return {**timed["main"], "shapes": [timed[n] for n in FLASH_TIMED[1:]]}


RMSNORM_CASES = [
    # name, shape, dtype, weight_offset
    ("prefill", (SERVE_BATCH * SERVE_PROMPT, 2048), torch.bfloat16, 0.0),
    ("decode", (SERVE_BATCH, 1, 2048), torch.bfloat16, 0.0),
    ("fp32", (SERVE_BATCH * SERVE_PROMPT, 2048), torch.float32, 0.0),
    ("offset_scalar_path", (1000, 2050), torch.bfloat16, 1.0),
    # Qwen3-MoE's prefill: q_norm over 64 heads of 128, ln1/ln2 at 4096
    ("qwen3_q_norm", (SERVE_BATCH, SERVE_PROMPT, 64, 128), torch.bfloat16,
     0.0),
    ("qwen3_ln", (SERVE_BATCH * SERVE_PROMPT, 4096), torch.bfloat16, 0.0),
    ("qwen3_k_norm", (SERVE_BATCH, SERVE_PROMPT, 4, 128), torch.bfloat16,
     0.0),
    # Zamba2-7B's d_model (14 vectors a lane) and its gate norm over
    # d_inner = 7168 (28 vectors a lane), in prefill and in a decode step
    ("zamba2_ln", (SERVE_BATCH * SERVE_PROMPT, 3584), torch.bfloat16, 0.0),
    ("zamba2_gate_norm", (SERVE_BATCH * SERVE_PROMPT, 7168), torch.bfloat16,
     0.0),
    ("zamba2_gate_norm_decode", (SERVE_BATCH, 1, 7168), torch.bfloat16, 0.0),
    # Mamba2-780M's d_model (ln) and its gate norm over d_inner = 3072;
    # LLaVA-NeXT-34B's d_model (ln1, ln2, the final norm), the width of
    # Zamba2's gate norm
    ("mamba2_ln", (SERVE_BATCH * SERVE_PROMPT, 1536), torch.bfloat16, 0.0),
    ("mamba2_gate_norm", (SERVE_BATCH * SERVE_PROMPT, 3072), torch.bfloat16,
     0.0),
    ("llava_ln", (SERVE_BATCH * SERVE_PROMPT, 7168), torch.bfloat16, 0.0),
    # the kernel's other widths: a row of 8 vectors in the 16-lane kernel
    # (the reduced configs' widths; lanes past the row masked), 32 vectors
    # a lane in fp32 at 4096, and a row too wide for registers (two passes)
    ("narrow_d64", (4096, 64), torch.bfloat16, 1.0),
    ("fp32_4096", (1024, 4096), torch.float32, 0.0),
    ("two_pass_d40960", (64, 40960), torch.bfloat16, 0.0),
]
# Whisper-medium's d_model 1024: the encoder over 8 x 1500 frames, the
# decoder's prefill over the 384-token prompt and a decode step.  They draw
# from a generator of their own, so every case above and every later phase
# keeps the inputs it had without them.
RMSNORM_WHISPER_CASES = [
    ("whisper_ln", (SERVE_BATCH * 1500, 1024), torch.bfloat16, 0.0),
    ("whisper_decoder_ln", (SERVE_BATCH * WHISPER_PROMPT, 1024),
     torch.bfloat16, 0.0),
    ("whisper_decode", (SERVE_BATCH, 1, 1024), torch.bfloat16, 0.0),
]
# one bf16 rounding of the output (2^-7 relative); fp32: order of sums
RMSNORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def phase_rmsnorm(gen):
    from repro_torch.kernels import cost
    from repro_torch.kernels import rmsnorm as rn
    records = {}
    whisper_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [(c, gen) for c in RMSNORM_CASES] + [
        (c, whisper_gen) for c in RMSNORM_WHISPER_CASES]
    for (name, shape, dt, off), g in cases:
        x = torch.randn(shape, device="cuda", generator=g).to(dt)
        w = (1.0 + 0.1 * torch.randn(shape[-1], device="cuda",
                                     generator=g)).to(dt)
        kw = {"eps": 1e-6, "weight_offset": off}
        y = rn.rmsnorm(x, w, **kw)
        y_p = rn.rmsnorm_plain(x, w, **kw)
        torch.cuda.synchronize()
        err = (y.float() - y_p.float()).abs().max().item()
        tol = RMSNORM_TOL[dt]
        check(torch.allclose(y.float(), y_p.float(), rtol=tol, atol=tol),
              f"rmsnorm {name}: kernel vs plain {err} (rtol=atol={tol})")
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "weight_offset": off, "max_abs_err": err, "tol": tol}
        rec["bound_ms"], rec["bound_by"] = bound_ms(*cost.rmsnorm_cost(
            x.numel() // shape[-1], shape[-1], x.element_size()), dt)
        rec["ms"] = time_ms(lambda: rn.rmsnorm(x, w, **kw), 50)
        rec["plain_ms"] = time_ms(lambda: rn.rmsnorm_plain(x, w, **kw), 20)
        library = (lambda: F.rms_norm(x, (shape[-1],), w, eps=1e-6)) \
            if off == 0.0 else None
        rec["library_ms"] = time_ms(library, 50) if library else None
        rec["device_ms"] = device_ms(lambda: rn.rmsnorm(x, w, **kw), 20)
        rec["library_device_ms"] = device_ms(library, 20) if library \
            else None
        records[name] = rec
        log("kernel", {"name": "rmsnorm", **rec})
    return {**records["prefill"],
            "shapes": [r for n, r in records.items() if n != "prefill"]}


SSD_CASES = [
    # name, bb, s, h, p, g, n, chunk, dtype
    # Zamba2-7B's prefill shape (batch 8, prompt 1024)
    ("zamba2", 8, 1024, 112, 64, 1, 64, 128, torch.bfloat16),
    # Mamba2 widths (mamba2-780m: 48 heads of 64, d_state 128), batch 1
    ("mamba2_widths", 1, 1024, 48, 64, 1, 128, 128, torch.float32),
    ("n_groups4", 2, 512, 16, 64, 4, 64, 128, torch.bfloat16),
    ("chunk64", 2, 512, 16, 64, 1, 64, 64, torch.bfloat16),
    ("s_eq_chunk", 2, 128, 16, 64, 1, 64, 128, torch.float32),
    # the reduced configs (``--reduced``, chunk 8) on the card
    ("reduced", 2, 32, 16, 8, 1, 16, 8, torch.float32),
    # bf16 (tensor cores): Mamba2's widths at batch 1, one chunk (no state
    # kernels), the reduced configs (chunk 8 padded to 16 rows, N 16), a
    # chunk of 100 (padded to 112), N 48 (padded to 64) with P 32, and P
    # 128 (two 64-column blocks of y)
    ("mamba2_bf16", 1, 1024, 48, 64, 1, 128, 128, torch.bfloat16),
    ("s_eq_chunk_bf16", 2, 128, 16, 64, 1, 64, 128, torch.bfloat16),
    ("reduced_bf16", 2, 32, 16, 8, 1, 16, 8, torch.bfloat16),
    ("chunk100_bf16", 1, 300, 8, 64, 2, 64, 100, torch.bfloat16),
    ("n48_p32_bf16", 1, 512, 8, 32, 1, 48, 128, torch.bfloat16),
    ("p128_bf16", 1, 256, 4, 128, 1, 64, 64, torch.bfloat16),
    # 17 chunks: the state passed over more chunks than any served shape
    ("chunks17_bf16", 1, 1088, 8, 64, 1, 64, 64, torch.bfloat16),
    # Mamba2-780M's prefill shape (batch 8, prompt 1024), timed with and
    # without the final state
    ("mamba2_serve", 8, 1024, 48, 64, 1, 128, 128, torch.bfloat16),
    # the FMA kernel with two B/C groups
    ("groups2_fp32", 1, 512, 16, 64, 2, 64, 128, torch.float32),
]
SSD_TIMED = ("zamba2", "mamba2_widths", "mamba2_bf16", "mamba2_serve")
# bf16: one bf16 rounding of the output (2^-8 relative); fp32: the cumsum
# of dt*A runs in another order (a warp scan), and at |L| ~ 1e3 its fp32
# rounding moves exp(L_i - L_j) by ~1e-4 relative
SSD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
# The final state is an fp32 sum over the chunks on both paths (no bf16
# rounding of the output; the bf16 path feeds x o w to the tensor cores as
# hi + lo parts, 16 bits of mantissa): held relative to its largest
# element, max |state - plain| <= 1e-3 * max |plain|, which leaves room
# for the cumsum order's ~1e-4 relative move of exp(L_Q - L_j).
SSD_STATE_RTOL = 1e-3


def _ssd_workspace_expected(bb, s, h, p, n, chunk, dt, state: bool) -> int:
    """Bytes the bf16 kernels write in their workspace: fp32 S_c of all
    chunks but the last (256-byte aligned), then fp32 exp(L_Q) of those
    chunks, or of all of them with the final state; fp32 takes none."""
    nc = s // chunk
    if dt != torch.bfloat16 or (nc < 2 and not state):
        return 0
    slots = -(-bb * h * (nc - 1) * p * n * 4 // 256) * 256
    return slots + bb * h * (nc - 1 + state) * 4


def phase_ssd(gen):
    from repro_torch.kernels import cost
    from repro_torch.kernels import ssd_scan as sk
    timed = {}
    for name, bb, s, h, p, g, n, chunk, dt in SSD_CASES:
        x = torch.randn(bb, s, h, p, device="cuda", generator=gen).to(dt)
        dtv = F.softplus(torch.randn(bb, s, h, device="cuda", generator=gen))
        a = -torch.exp(0.5 * torch.randn(h, device="cuda", generator=gen))
        bm = (0.3 * torch.randn(bb, s, g, n, device="cuda",
                                generator=gen)).to(dt)
        cm = (0.3 * torch.randn(bb, s, g, n, device="cuda",
                                generator=gen)).to(dt)
        n0 = sk.launches
        y = sk.ssd_scan(x, dtv, a, bm, cm, chunk=chunk)
        n1 = sk.launches
        y_s, st = sk.ssd_scan(x, dtv, a, bm, cm, chunk=chunk,
                              return_state=True)
        n2 = sk.launches
        y_p, st_p = sk.ssd_plain(x, dtv, a, bm, cm, chunk=chunk,
                                 return_state=True)
        torch.cuda.synchronize()
        err = (y.float() - y_p.float()).abs().max().item()
        tol = SSD_TOL[dt]
        check(bool(torch.isfinite(y.float()).all()), f"ssd {name}: finite")
        check(torch.allclose(y.float(), y_p.float(), rtol=tol, atol=tol),
              f"ssd {name}: kernel vs plain {err} (rtol=atol={tol})")
        # the final state: the same y bit for bit, the state within its
        # relative tolerance, three launches in bf16 whatever the chunks
        check(torch.equal(y, y_s), f"ssd {name}: y with the state is y")
        check(tuple(st.shape) == (bb, h, p, n) and st.dtype == torch.float32
              and bool(torch.isfinite(st).all()),
              f"ssd {name}: a finite (Bb, H, P, N) float32 state")
        st_scale = st_p.abs().max().item()
        st_err = (st - st_p).abs().max().item()
        check(st_err <= SSD_STATE_RTOL * st_scale,
              f"ssd {name}: final state vs plain {st_err} (max |state| "
              f"{st_scale}, rtol {SSD_STATE_RTOL})")
        bf16 = dt == torch.bfloat16
        launched = (n1 - n0, n2 - n1)
        check(launched == ((3 if s // chunk > 1 else 1) if bf16 else 1,
                           3 if bf16 else 1),
              f"ssd {name}: launches without / with the state {launched}")
        ws = (sk.workspace_bytes(x, bm, chunk=chunk),
              sk.workspace_bytes(x, bm, chunk=chunk, return_state=True))
        check(ws == tuple(_ssd_workspace_expected(bb, s, h, p, n, chunk, dt,
                                                  state)
                          for state in (False, True)),
              f"ssd {name}: workspace bytes {ws} are what the kernels "
              f"write")
        rec = {"case": name, "shape": [bb, s, h, p, g, n], "chunk": chunk,
               "dtype": str(dt), "max_abs_err": err, "tol": tol,
               "max_abs_y": y_p.float().abs().max().item(),
               "state_max_abs_err": st_err, "max_abs_state": st_scale,
               "state_rtol": SSD_STATE_RTOL, "launches": launched,
               "workspace_bytes": ws}
        if name in SSD_TIMED:
            flops, nbytes = cost.ssd_cost(bb, s, h, p, g, n, chunk,
                                          x.element_size())
            rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, dt)
            # with the state: its fp32 (Bb, H, P, N) written once more
            rec["state_bound_ms"], rec["state_bound_by"] = bound_ms(
                flops, nbytes + st.numel() * 4, dt)
            # the bf16 kernels' workspace is written and read twice (S_c,
            # then the carried states over them): the kernels' bytes, not
            # the function's
            rec["bound_with_workspace_ms"] = bound_ms(
                flops, nbytes + 4 * ws[0], dt)[0]
            rec["ms"] = time_ms(lambda: sk.ssd_scan(x, dtv, a, bm, cm,
                                                    chunk=chunk), 10)
            rec["state_ms"] = time_ms(lambda: sk.ssd_scan(
                x, dtv, a, bm, cm, chunk=chunk, return_state=True), 10)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["device_ms_by_kernel"] = device_ms_by_kernel(
                lambda: sk.ssd_scan(x, dtv, a, bm, cm, chunk=chunk), 10)
            rec["state_device_ms_by_kernel"] = device_ms_by_kernel(
                lambda: sk.ssd_scan(x, dtv, a, bm, cm, chunk=chunk,
                                    return_state=True), 10)
            rec["plain_ms"] = time_ms(lambda: sk.ssd_plain(x, dtv, a, bm, cm,
                                                           chunk=chunk), 3)
            rec["library_ms"] = None   # no single PyTorch call computes SSD
            # blocks of the (last) kernel: one per (b, h) in fp32, one per
            # (b, h, chunk) in bf16
            rec["blocks"] = bb * h * (s // chunk if dt == torch.bfloat16
                                      else 1)
            timed[name] = rec
        log("kernel", {"name": "ssd_scan", **rec})
    return {**timed["zamba2"], "shapes": [timed[n] for n in SSD_TIMED[1:]]}


GMM_CASES = [
    # name, experts, rows per expert (or the block ids), K, N, block_t,
    # dtype, iterations timed.  Qwen3-MoE at batch 8 x prompt 1024: the
    # capacity is 640 rows of 128 experts; w1 and w3 are 4096 -> 1536, w2
    # 1536 -> 4096.  Decode at batch 8: 8 rows (one block) per expert.
    # bf16 at block_t 64 and 128 runs the wgmma kernel, at 8-32 the decode
    # kernel (TMA + mma.sync).
    ("qwen3_prefill", 128, 640, 4096, 1536, 128, torch.bfloat16, 10),
    ("qwen3_prefill_w2", 128, 640, 1536, 4096, 128, torch.bfloat16, 10),
    ("qwen3_decode", 128, 8, 4096, 1536, 8, torch.bfloat16, 20),
    # decode's w2 (1536 -> 4096), and the decode kernel's other row tiles
    # at w1: 16 and 32 rows of each expert in one block
    ("qwen3_decode_w2", 128, 8, 1536, 4096, 8, torch.bfloat16, 20),
    ("qwen3_decode_bt16", 128, 16, 4096, 1536, 16, torch.bfloat16, 20),
    ("qwen3_decode_bt32", 128, 32, 4096, 1536, 32, torch.bfloat16, 20),
    # Mixtral-8x7B at batch 8 x prompt 1024: 2560 rows of 8 experts
    ("mixtral_prefill", 8, 2560, 4096, 14336, 128, torch.bfloat16, 3),
    # block_t 64: a capacity that is a multiple of 64 and not of 128
    ("bt64", 32, 192, 2048, 1024, 64, torch.bfloat16, 20),
    # ragged: experts 1, 2, 4 and 6 own no block; K and N past a tile
    ("ragged", 8, [0, 0, 3, 5, 5, 5, 7], 200, 328, 32, torch.bfloat16, 20),
    # the same edges on the wgmma kernel (K 200 = 3 x 64 + 8, N 328 = 256
    # + 72), and expert 5 owning eight consecutive blocks
    ("ragged_bt128", 8, [0, 0, 3] + [5] * 8 + [7], 200, 328, 128,
     torch.bfloat16, 20),
    ("ragged_bt64", 8, [0, 0, 3] + [5] * 8 + [7], 200, 328, 64,
     torch.bfloat16, 20),
    ("ragged_fp32", 8, [0, 0, 3, 5, 5, 5, 7], 200, 328, 32, torch.float32,
     20),
    ("qwen3_decode_fp32", 128, 8, 4096, 1536, 8, torch.float32, 10),
]
# bf16: one rounding of the bf16 output (the reference's gmm sweep);
# fp32 at a small K: the order of sums
GMM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
GMM_FP32_K_SCALED = 1024   # from this K on, the fp32 tolerance scales with K


def phase_gmm(gen):
    from repro_torch.kernels import cost
    from repro_torch.kernels import moe_gmm as mg
    records = {}
    for name, e, rows, k, n, bt, dt, iters in GMM_CASES:
        if isinstance(rows, list):
            ids = torch.tensor(rows, dtype=torch.int32, device="cuda")
            uniform = None
        else:
            ids = torch.arange(e, dtype=torch.int32, device="cuda") \
                .repeat_interleave(rows // bt)
            uniform = rows
        t = ids.numel() * bt
        x = torch.randn(t, k, device="cuda", generator=gen).to(dt)
        w = (torch.randn(e, k, n, device="cuda", generator=gen)
             * k ** -0.5).to(dt)
        o = mg.moe_gmm(x, w, ids, block_t=bt)
        o_p = mg.moe_gmm_plain(x, w, ids, bt)
        torch.cuda.synchronize()
        diff = (o.float() - o_p.float()).abs()
        err = diff.max().item()
        check(bool(torch.isfinite(o.float()).all()), f"gmm {name}: finite")
        rec = {"case": name, "shape": [t, k, n], "experts": e,
               "block_t": bt, "dtype": str(dt),
               "kernel": mg.kernel_for(dt, bt), "max_abs_err": err,
               "max_abs_out": o_p.float().abs().max().item()}
        if dt == torch.float32 and k >= GMM_FP32_K_SCALED:
            # Both sides sum K products in float32, in other orders: each
            # is within K * 2^-24 * sum_k |x||w| of the exact sum
            # (Higham's bound), so they differ by at most twice that.
            tol = 2.0 * k * 2.0 ** -24
            bound = tol * mg.moe_gmm_plain(x.abs(), w.abs(), ids, bt)
            rec["tol"] = f"{tol:.3e} * (|x| @ |w|)"
            rec["max_err_over_tol"] = (
                diff / bound.clamp_min(1e-30)).max().item()
            check(bool((diff <= bound).all()),
                  f"gmm {name}: kernel vs plain within K-scaled bound")
        else:
            tol = GMM_TOL[dt]
            rec["tol"] = tol
            check(torch.allclose(o.float(), o_p.float(), rtol=tol, atol=tol),
                  f"gmm {name}: kernel vs plain {err} (rtol=atol={tol})")
        # bytes: x, the weights of every expert that owns a block, out
        used = int(torch.unique(ids).numel())
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            *cost.gmm_cost(t, k, n, used, x.element_size()), dt)
        rec["ms"] = time_ms(lambda: mg.moe_gmm(x, w, ids, block_t=bt), iters)
        rec["plain_ms"] = time_ms(lambda: mg.moe_gmm_plain(x, w, ids, bt),
                                  max(1, iters // 5), warmup=1)
        # torch.bmm over the (E, rows, K) view computes the same function
        # when every expert owns the same rows: the model's layout
        rec["library_ms"] = (time_ms(lambda: torch.bmm(
            x.view(e, uniform, k), w), iters) if uniform else None)
        rec["tflops"] = 2.0 * t * k * n / rec["ms"] / 1e9
        records[name] = rec
        log("kernel", {"name": "moe_gmm", **rec})
        del x, w, o, o_p, diff
        torch.cuda.empty_cache()
    gmm_bad_ids(gen)
    return {**records["qwen3_prefill"],
            "shapes": [r for n, r in records.items() if n != "qwen3_prefill"]}


def gmm_bad_ids(gen):
    """An id outside [0, E) gives NaN rows on every kernel; the other rows
    of the same call match the plain version."""
    from repro_torch.kernels import moe_gmm as mg
    e, k, n = 8, 200, 328
    ids = torch.tensor([0, -1, 3, 8, 3, 100, 7], dtype=torch.int32,
                       device="cuda")
    bad = (ids < 0) | (ids >= e)
    for bt, dt in ((128, torch.bfloat16), (64, torch.bfloat16),
                   (32, torch.bfloat16), (16, torch.bfloat16),
                   (8, torch.bfloat16), (8, torch.float32)):
        x = torch.randn(ids.numel() * bt, k, device="cuda",
                        generator=gen).to(dt)
        w = (torch.randn(e, k, n, device="cuda", generator=gen)
             * k ** -0.5).to(dt)
        o = mg.moe_gmm(x, w, ids, block_t=bt).view(-1, bt, n)
        o_p = mg.moe_gmm_plain(x.view(-1, bt, k)[~bad].reshape(-1, k), w,
                               ids[~bad], bt).view(-1, bt, n)
        torch.cuda.synchronize()
        kernel = mg.kernel_for(dt, bt)
        check(bool(torch.isnan(o[bad].float()).all()),
              f"gmm {kernel} block_t {bt}: NaN rows for ids outside [0, E)")
        tol = GMM_TOL[dt]
        check(torch.allclose(o[~bad].float(), o_p.float(), rtol=tol,
                             atol=tol),
              f"gmm {kernel} block_t {bt}: the valid blocks of a call with "
              f"bad ids match the plain version")
    log("kernel", f"moe_gmm: ids {ids.tolist()} of E={e} give NaN rows at "
        "block_t 128, 64 (wgmma), 32, 16, 8 (decode) and 8 (FMA, fp32); "
        "the valid blocks match the plain version")


# ---------------------------------------------------------------------------
# 3. serve at full width
# ---------------------------------------------------------------------------
def _kernel_modules():
    from repro_torch.kernels import (flash_attention, moe_gmm, rmsnorm,
                                     ssd_scan, wavefront)
    return {"flash_attention_fwd": flash_attention, "rmsnorm": rmsnorm,
            "ssd_scan": ssd_scan, "moe_gmm": moe_gmm, "wavefront": wavefront}


def expected_launches(cfg, prompt: int = SERVE_PROMPT) -> dict:
    """Kernel launches of one ``generate`` call of SERVE_GEN tokens: flash
    and the SSD's kernels in prefill once, rmsnorm and moe_gmm in prefill
    and every decode step."""
    if cfg.family == "encdec":
        # the encoder once (flash; ln1, ln2 a layer and its final norm),
        # the decoder's self- and cross-attention in prefill, its ln1, ln_x
        # and ln2 a layer and its final norm in prefill and every decode
        # step (decode's attention is torch ops)
        return {"flash_attention_fwd": cfg.encoder_layers + 2 * cfg.n_layers,
                "rmsnorm": 2 * cfg.encoder_layers + 1
                + (3 * cfg.n_layers + 1) * SERVE_GEN,
                "ssd_scan": 0, "moe_gmm": 0, "wavefront": 0}
    if cfg.family == "ssm":
        # per layer its norm + the gate norm, one final norm; the SSD with
        # the final state runs three kernels in bf16 whatever the chunks
        return {"flash_attention_fwd": 0,
                "rmsnorm": (2 * cfg.n_layers + 1) * SERVE_GEN,
                "ssd_scan": 3 * cfg.n_layers, "moe_gmm": 0, "wavefront": 0}
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.hybrid_period
        # per SSM layer: its norm + the gate norm; per application of the
        # shared block: two norms; one final norm
        n_norms = 2 * cfg.n_layers + 2 * n_apps + 1
        # the SSD runs in prefill: in bf16 three kernels (chunk state,
        # state passing, chunk scan) where the prompt has more than one
        # chunk, else the chunk scan alone
        ssd_kernels = 3 if prompt > cfg.ssm.chunk else 1
        return {"flash_attention_fwd": n_apps, "rmsnorm": n_norms * SERVE_GEN,
                "ssd_scan": ssd_kernels * cfg.n_layers, "moe_gmm": 0,
                "wavefront": 0}
    # dense, MoE and VLM: per layer ln1, ln2 and, with qk-norm, one launch
    # each for q and k
    norms = 2 + (2 if cfg.attn.qk_norm else 0)
    return {"flash_attention_fwd": cfg.n_layers,
            "rmsnorm": (norms * cfg.n_layers + 1) * SERVE_GEN, "ssd_scan": 0,
            # w1, w3, w2 of every MoE layer
            "moe_gmm": 3 * cfg.n_layers * SERVE_GEN if cfg.moe else 0,
            "wavefront": 0}


def phase_serve(arch: str, depth, prompt: int):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import exec_config, generate
    from repro_torch.models import build_model

    cfg = get_config(arch)
    full_depth, full_gb = cfg.n_layers, 2 * cfg.param_count() / 1e9
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    ex = exec_config(cfg, torch.bfloat16, "cuda")
    model = build_model(cfg).init(SEED, ex)
    n_params = sum(p.numel() for p in model.parameters())
    log("serve", f"{cfg.name}: {cfg.n_layers} of {full_depth} layers, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params in bf16 "
        f"({full_gb:.2f} GB at full depth)")
    # first call: cuBLAS and allocator warm-up, not counted
    generate(cfg, ex, prompt, 4, SERVE_BATCH, SEED, model=model)

    mods = _kernel_modules()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    g = generate(cfg, ex, prompt, SERVE_GEN, SERVE_BATCH, SEED, model=model)
    launches = {name: m.launches for name, m in mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    expected = expected_launches(cfg, prompt)
    log("serve", f"{cfg.name} main-path launches {launches}; expected "
        f"{expected}")
    check(launches == expected,
          f"{cfg.name}: every kernel of the path launched as often as the "
          f"model calls it")
    check(tuple(g.tokens.shape) == (SERVE_BATCH, SERVE_GEN), "token shape")
    check(int(g.tokens.min()) >= 0 and int(g.tokens.max()) < cfg.vocab,
          "tokens in range")
    check(tuple(g.prefill_logits.shape) == (SERVE_BATCH, cfg.vocab)
          and bool(torch.isfinite(g.prefill_logits.float()).all()),
          "finite prefill logits")
    n_decode = SERVE_GEN - 1
    total_s = g.prefill_s + g.decode_s
    log("serve", {"model": cfg.name, "batch": SERVE_BATCH,
                  "prompt": prompt,
                  "gen": SERVE_GEN, "prefill_ms": g.prefill_s * 1e3,
                  "decode_ms_per_step": g.decode_s * 1e3 / n_decode,
                  "prompt_tokens_per_s": SERVE_BATCH * prompt / g.prefill_s,
                  "decode_tokens_per_s": SERVE_BATCH * n_decode / g.decode_s,
                  "generated_tokens_per_s": SERVE_BATCH * SERVE_GEN / total_s,
                  "peak_mem_gb": peak_gb, "params_b": n_params / 1e9,
                  "layers": cfg.n_layers, "full_depth": full_depth,
                  "encoder_layers": cfg.encoder_layers,
                  "encoder_frames": cfg.encoder_len})
    return launches, (cfg, ex, model, prompt)


# ---------------------------------------------------------------------------
# 3b. where the serving time goes (torch.profiler, after the counted run)
# ---------------------------------------------------------------------------
PROFILE_DECODE_STEPS = 8


def phase_profile(cfg, ex, model, prompt):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    fns = build_model(cfg)
    batch = fns.make_batch(SEED + 1, ShapeConfig(
        "serve", "prefill", prompt, SERVE_BATCH), ex)
    cache = fns.init_cache(SERVE_BATCH, prompt + PROFILE_DECODE_STEPS, ex)
    prefill = make_prefill_step(cfg, ex)
    decode = make_serve_step(cfg, ex)
    tok = batch["tokens"][:, -1]

    def run_decode():
        for i in range(PROFILE_DECODE_STEPS):
            decode(model, cache, tok, prompt + i)

    windows = [("prefill", lambda: prefill(model, batch, cache), 1),
               ("decode", run_decode, PROFILE_DECODE_STEPS)]
    if cfg.family == "encdec":
        # the encoder alone: the rest of the prefill window is the decoder
        windows.insert(1, ("encode", lambda: model.encode(
            batch["encoder_embeds"], ex), 1))
    for name, fn, n_calls in windows:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        by_key = [(e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        by_key = sorted((k for k in by_key if k[1] > 0), key=lambda k: -k[1])
        busy_ms = sum(k[1] for k in by_key)
        check(busy_ms > 0, f"profile {name}: the trace holds device time")
        log("profile", {
            "model": cfg.name, "window": name, "calls": n_calls,
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels": [{"name": k[:90], "ms": ms, "launches": c,
                             "share_of_busy": ms / busy_ms}
                            for k, ms, c in by_key[:10]]})


# ---------------------------------------------------------------------------
# 4. the slice on the card against the same port on the CPU
# ---------------------------------------------------------------------------
CHECK_LOGIT_TOL = 1e-3   # fp32 both sides; sums run in another order


def phase_check(arch: str, n_layers: int, prompt: int):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import exec_config, generate
    from repro_torch.models import build_model

    cfg = get_config(arch)
    # an encoder-decoder keeps as many encoder layers as decoder layers
    cfg = dataclasses.replace(cfg, n_layers=n_layers, encoder_layers=(
        n_layers if cfg.encoder_layers else 0))
    ex_cpu = exec_config(cfg, torch.float32, "cpu")
    ex_gpu = exec_config(cfg, torch.float32, "cuda")
    model_cpu = build_model(cfg).init(SEED, ex_cpu)
    # the same weights on the card without a second host copy (a Qwen3-MoE
    # layer with its embedding and head is ~15 GB in float32)
    model_gpu = type(model_cpu)(cfg, device="meta", dtype=torch.float32)
    model_gpu.to_empty(device="cuda")
    model_gpu.load_state_dict(model_cpu.state_dict())
    runs = {}
    for name, ex, model in (("cuda", ex_gpu, model_gpu),
                            ("cpu", ex_cpu, model_cpu)):
        runs[name] = generate(cfg, ex, prompt, CHECK_TOKENS, CHECK_BATCH,
                              SEED, model=model)
    err = (runs["cuda"].prefill_logits.cpu()
           - runs["cpu"].prefill_logits).abs().max().item()
    same = torch.equal(runs["cuda"].tokens.cpu(), runs["cpu"].tokens)
    layers = (f"{n_layers} + {n_layers} layers, {cfg.encoder_len} frames"
              if cfg.encoder_layers else f"{n_layers} layers")
    log("check", f"{cfg.name} full width, {layers}, fp32, batch "
        f"{CHECK_BATCH}, prompt {prompt}: max prefill logit err "
        f"{err:.3e} (tol {CHECK_LOGIT_TOL}), first {CHECK_TOKENS} greedy "
        f"tokens equal: {same}")
    check(err <= CHECK_LOGIT_TOL, "card logits match the CPU run")
    check(same, "card greedy tokens match the CPU run")


# ---------------------------------------------------------------------------
# 4-5. the design-space study: the wavefront kernel, Study.run(), the scan
# ---------------------------------------------------------------------------
WAVEFRONT_TOL = 1e-12    # float64, the same operations in the same order
WAVEFRONT_K = 32         # records of the study's widest replay call
WAVEFRONT_CASES = [
    # name, shape keys (schedule, pp, v, n_micro), records
    ("gpipe", [("gpipe", 16, 1, 64)], WAVEFRONT_K),
    ("1f1b", [("1f1b", 16, 1, 64)], WAVEFRONT_K),
    ("interleaved", [("interleaved", 16, 4, 64)], WAVEFRONT_K),
    # paper_qwen3_validate's widest event re-rank call: four keys up to
    # S 16 x L 542 in one launch
    ("mixed", [("gpipe", 16, 1, 64), ("1f1b", 8, 1, 32),
               ("interleaved", 16, 4, 64), ("interleaved", 2, 2, 8)],
     WAVEFRONT_K),
    # S 64 x L 1150: 0.59 MB of history, more than a block's shared
    # memory, so it goes to device-memory scratch (a block a record)
    ("device_memory_history", [("gpipe", 64, 1, 512)], 8),
]
WAVEFRONT_TIMED = "mixed"
# The wavefront's bound is its dependent chain: L levels, each one
# shared-memory load (~30 cycles on Hopper), a float64 max and add (two
# dependent ops of ~8 cycles) and a barrier (~20 cycles), at the SM clock
# nvidia-smi reports (clocks.max.sm); blocks beyond one wave repeat it.
WAVEFRONT_CYCLES_PER_LEVEL = 30 + 2 * 8 + 20
H100_SMS = 132


def wavefront_inputs(keys, k: int, rng):
    """Stacked tables, key indices and (6, K) rows like an event re-rank
    call's: spans of 1-10 ms, a DP all-reduce on some records."""
    from repro_torch.events.batch import _key_tables
    tabs = [torch.tensor(t) for t in _key_tables(tuple(keys))]
    key_rows = torch.tensor(rng.randint(0, len(keys), k), dtype=torch.int32)
    nmv = torch.tensor([keys[i][2] * keys[i][3] for i in key_rows.tolist()],
                       dtype=torch.float64)
    t_dp = torch.tensor(rng.uniform(0.0, 0.05, k) * (rng.rand(k) < 0.7))
    rows = torch.stack([torch.tensor(rng.uniform(1e-3, 1e-2, k)),
                        torch.tensor(rng.uniform(1e-3, 2e-2, k)), t_dp,
                        torch.tensor(rng.uniform(0.0, 0.05, k)), nmv,
                        torch.tensor(rng.uniform(0.5, 2.0, k))])
    return tabs, key_rows, rows


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_wavefront():
    import numpy as np

    from repro_torch.kernels import wavefront as wf
    rng = np.random.RandomState(SEED)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    clock = sm_clock_hz()
    records = {}
    for name, keys, k in WAVEFRONT_CASES:
        tabs, key_rows, rows = wavefront_inputs(keys, k, rng)
        tabs = [t.cuda() for t in tabs]
        key_rows, rows = key_rows.cuda(), rows.cuda()
        _, S, L = tabs[0].shape
        in_shared = wf.shared_bytes(S, L) <= limit
        out = wf.wavefront(*tabs, key_rows, rows)
        plain = wf.wavefront_plain(*tabs, key_rows, rows)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        rec = {"case": name, "keys": keys, "shape": [len(keys), k, S, L],
               "dtype": "float64", "history": "shared" if in_shared
               else "device memory", "max_abs_err": err,
               "tol": WAVEFRONT_TOL}
        check(bool(torch.isfinite(out).all()), f"wavefront {name}: finite")
        check(err <= WAVEFRONT_TOL, f"wavefront {name}: kernel vs plain "
              f"{err} (tol {WAVEFRONT_TOL})")
        check(in_shared == (name != "device_memory_history"),
              f"wavefront {name}: history in {rec['history']}")
        nbytes = sum(t.numel() * 4 for t in tabs) + key_rows.numel() * 4 \
            + rows.numel() * 8 + out.numel() * 8
        threads = 32 * -(-S // 32)
        smem = wf.shared_bytes(S, L) if in_shared else S * 8
        per_sm = max(1, min(32, 2048 // threads, limit // smem))
        waves = -(-k // (H100_SMS * per_sm))
        chain_s = waves * L * WAVEFRONT_CYCLES_PER_LEVEL / clock
        t_bytes = nbytes / PEAK_BYTES_PER_S
        rec["bound_ms"] = max(chain_s, t_bytes) * 1e3
        rec["bound_by"] = "operations" if chain_s > t_bytes else "bytes"
        rec["chain"] = {"levels": L, "cycles_per_level":
                        WAVEFRONT_CYCLES_PER_LEVEL, "sm_clock_hz": clock,
                        "waves": waves}
        rec["ms"] = time_ms(lambda: wf.wavefront(*tabs, key_rows, rows), 50)
        rec["device_ms"] = device_ms(
            lambda: wf.wavefront(*tabs, key_rows, rows), 20)
        rec["plain_ms"] = time_ms(
            lambda: wf.wavefront_plain(*tabs, key_rows, rows), 2, warmup=1)
        rec["library_ms"] = None   # no PyTorch call runs this recurrence
        records[name] = rec
        log("kernel", {"name": "wavefront", **rec})
    # a key index outside [0, U) gives a NaN column, the others as before
    tabs, key_rows, rows = wavefront_inputs(WAVEFRONT_CASES[3][1], 8, rng)
    tabs = [t.cuda() for t in tabs]
    key_rows, rows = key_rows.cuda(), rows.cuda()
    good = wf.wavefront(*tabs, key_rows, rows)
    bad_rows = key_rows.clone()
    bad_rows[[2, 5]] = torch.tensor([-1, tabs[0].shape[0]], dtype=torch.int32,
                                    device="cuda")
    bad = wf.wavefront(*tabs, bad_rows, rows)
    keep = [i for i in range(8) if i not in (2, 5)]
    check(bool(torch.isnan(bad[:, [2, 5]]).all())
          and torch.equal(bad[:, keep], good[:, keep]),
          "wavefront: key indices -1 and U give NaN columns, the rest as "
          "with valid indices")
    log("kernel", "wavefront: key indices outside [0, U) give NaN columns")
    return {**records[WAVEFRONT_TIMED],
            "shapes": [r for n, r in records.items()
                       if n != WAVEFRONT_TIMED]}


# every committed scenario (the batched drivers' and the outer search's),
# paper_qwen3 under the RailX driver, two with the schedule as a search
# dimension and validation of the top 8, and the outer search with its
# fused event replay over every schedule: (label, scenario, overrides)
STUDY_CASES = [(name, name, {}) for name in (
    "gemma3_dense", "llava_vlm", "mixtral_nsga2", "paper_qwen3",
    "paper_qwen3_outer", "paper_qwen3_validate", "tinyllama_quick",
    "whisper_encdec", "zamba2_hybrid")] + [
    ("paper_qwen3+railx", "paper_qwen3", {"driver": "railx",
                                          "driver_kw": {}}),
    ("paper_qwen3_outer+event_replay", "paper_qwen3_outer", {
        "driver_kw": {"inner_budget": 48, "rounds": 8, "walkers": 8,
                      "event_replay": 2}, "schedule": "search"})] + [
    (f"{name}+search", name, {"schedule": "search", "validate_top": 8})
    for name in ("tinyllama_quick", "paper_qwen3_validate")]
STUDY_TOL = 1e-12        # card vs CPU path: the same float64 operations
STUDY_SPANS = ("study.run", "study.scan", "study.event_rerank",
               "study.refine", "study.validate_top", "outer.round")
SCAN_TILES = (1, 10, 100, 1000)   # x the BENCH_dse.json TinyLlama sweep
# The cost terms' bytes per design point: in, 25 float64 columns (vols,
# alloc, inv, hops, intra: 5 parallelism groups each), 5 bool (inter_mask)
# and 12 float64 scalars; out, 10 float64 (t_coll's 5, step, t_mem,
# exposed, dp_exposed, bubble).  Over HBM they bound the terms on the
# card; over PCIe (Gen5 x16, 64 GB/s a direction) they bound the copies.
TERMS_IN_BYTES_PER_ROW = 25 * 8 + 5 * 1 + 12 * 8
TERMS_OUT_BYTES_PER_ROW = 10 * 8
PCIE_BYTES_PER_S = 64e9


def _compare_studies(label: str, card, cpu) -> float:
    """Identical records in identical order; returns the largest relative
    metric difference (checked against STUDY_TOL)."""
    check(len(card.records) == len(cpu.records),
          f"{label}: {len(card.records)} records on the card, "
          f"{len(cpu.records)} on the CPU")
    worst = 0.0
    for i, (a, b) in enumerate(zip(card.records, cpu.records)):
        check((a.strategy, a.mcm, a.fabric, a.source)
              == (b.strategy, b.mcm, b.fabric, b.source),
              f"{label}: record {i} differs")
        check(set(a.metrics) == set(b.metrics),
              f"{label}: record {i} metric keys differ")
        for key, x in a.metrics.items():
            y = b.metrics[key]
            if isinstance(x, str):
                check(x == y, f"{label}: record {i} {key} {x} vs {y}")
            elif x != y and not (math.isnan(x) and math.isnan(y)):
                worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
    check(worst <= STUDY_TOL, f"{label}: metrics differ by {worst} "
          f"relative (tol {STUDY_TOL})")
    check(card.traces == cpu.traces,
          f"{label}: the outer search's trace differs from the CPU path's")
    return worst


def phase_study():
    from repro_torch.api import Scenario, Study
    from repro_torch.obs.trace import tracing

    scenarios = [(label,
                  Scenario.load(ROOT / "scenarios" / f"{n}.json").replace(
                      **over)) for label, n, over in STUDY_CASES]
    Study(scenarios[-1][1]).run(device="cuda")   # CUDA context, first build
    torch.cuda.synchronize()
    card = {}
    mods = _kernel_modules()
    for m in mods.values():
        m.launches = 0
    for label, sc in scenarios:
        with tracing() as tr:
            t0 = time.perf_counter()
            res = Study(sc).run(device="cuda")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = {}
        for ev in tr.events:
            if ev["name"] in STUDY_SPANS:
                spans[ev["name"]] = spans.get(ev["name"], 0.0) \
                    + ev["dur_ns"] / 1e6
        card[label] = (res, wall_ms, spans)
    launches = {name: m.launches for name, m in mods.items()}
    device_calls = sum(r.provenance["metrics"]["counters"].get(
        "batch_replay.device_calls", 0) for r, _, _ in card.values())
    log("study", f"main-path launches {launches}")
    check(launches["wavefront"] == device_calls and device_calls > 0,
          f"study: wavefront launched {launches['wavefront']} times, the "
          f"studies made {device_calls} replay calls on the card")
    check(all(n == 0 for name, n in launches.items() if name != "wavefront"),
          "study: no serving kernel launched on the study's path")
    for label, sc in scenarios:
        res, wall_ms, spans = card[label]
        t0 = time.perf_counter()
        cpu = Study(sc).run(device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        worst = _compare_studies(label, res, cpu)
        check(res.best is not None and all(
            math.isfinite(r.metrics["throughput"]) for r in res.records),
            f"{label}: a feasible best point and finite throughputs")
        counters = res.provenance["metrics"]["counters"]
        log("study", {
            "scenario": label, "records": len(res.records),
            "best_throughput": res.records[res.best].metrics["throughput"],
            "wall_ms": wall_ms, "cpu_path_wall_ms": cpu_ms,
            "spans_ms": spans,
            "scan_device_calls": counters.get("batched_sim.device_calls", 0),
            "replay_device_calls": counters.get("batch_replay.device_calls",
                                               0),
            "event_rerank": res.provenance.get("event_rerank", {}).get(
                "winners"),
            "validated": res.provenance.get("validate", {}).get(
                "n_validated"),
            "outer": {k: res.provenance[k] for k in (
                "n_rounds", "n_variants", "n_sim", "n_cache_hits",
                "n_refined", "n_event_replayed") if k in res.provenance},
            "max_rel_diff_vs_cpu": worst})
    return launches


def scan_cell():
    """The BENCH_dse.json TinyLlama cell (3,072 design points, 36 MCM
    variants, OI) -> (workload, strategy batch, each row's MCM index,
    the MCMs)."""
    import numpy as np

    from repro_torch.api import Scenario
    from repro_torch.dse.space import StrategyBatch
    sc = Scenario(model="tinyllama_1_1b", total_tflops=4e6, seq_len=4096,
                  global_batch=512, fabrics=("oi",))
    w, space = sc.build_workload(), sc.design_space()
    cells = list(space.batches())
    batch = StrategyBatch.concat([g for _, _, g in cells])
    local = np.concatenate([np.full(len(g), i, np.int64)
                            for i, (_, _, g) in enumerate(cells)])
    return w, batch, local, [m for m, _, _ in cells]


def phase_scan():
    """``batched_simulate`` on the BENCH_dse.json TinyLlama cell (3,072
    design points, 36 MCM variants, OI), its strategy batch tiled x1 to
    x1000: on the card and through the CPU path, the whole call and its
    cost terms (the ``batched_sim.terms`` span: copies, ops, copy back),
    and card vs CPU bit for bit."""
    import numpy as np

    from repro_torch.dse import batched_sim as bs
    from repro_torch.dse.space import StrategyBatch
    from repro_torch.obs.trace import tracing

    w, batch, local, mcms = scan_cell()
    sizes = []
    for tile in SCAN_TILES:
        tb = StrategyBatch.concat([batch] * tile)
        mb = bs.MCMBatch.from_mcms(mcms, np.tile(local, tile))
        rec = {"rows": len(tb)}
        outs = {}
        for device in ("cuda", "cpu"):
            runs = []
            for _ in range(1 + (5 if tile < 1000 else 2)):   # 1 warm-up
                with tracing() as tr:
                    t0 = time.perf_counter()
                    outs[device] = bs.batched_simulate(
                        w, tb, mb, fabric="oi", reuse=True, hw=mcms[0].hw,
                        device=device)
                    call_ms = (time.perf_counter() - t0) * 1e3
                terms_ms = sum(e["dur_ns"] for e in tr.events
                               if e["name"] == "batched_sim.terms") / 1e6
                runs.append((call_ms, terms_ms))
            runs = runs[1:]
            rec[f"{device}_ms"] = sorted(r[0] for r in runs)[len(runs) // 2]
            rec[f"terms_{device}_ms"] = sorted(
                r[1] for r in runs)[len(runs) // 2]
        check(all(np.array_equal(getattr(outs["cuda"], f),
                                 getattr(outs["cpu"], f))
                  for f in ("feasible", "step_time", "throughput", "mfu",
                            "power", "t_mem", "t_coll")),
              f"scan {len(tb)} rows: card and CPU path agree bit for bit")
        n_in = TERMS_IN_BYTES_PER_ROW * len(tb)
        n_out = TERMS_OUT_BYTES_PER_ROW * len(tb)
        rec["terms_bound_ms"] = (n_in + n_out) / PEAK_BYTES_PER_S * 1e3
        rec["terms_bound_by"] = "bytes"
        rec["terms_pcie_ms"] = (n_in + n_out) / PCIE_BYTES_PER_S * 1e3
        rec["card_speedup"] = rec["cpu_ms"] / rec["cuda_ms"]
        rec["terms_card_speedup"] = rec["terms_cpu_ms"] / rec["terms_cuda_ms"]
        sizes.append(rec)
        log("scan", rec)
    wins = [r["rows"] for r in sizes if r["card_speedup"] > 1.0]
    terms_wins = [r["rows"] for r in sizes if r["terms_card_speedup"] > 1.0]
    log("scan", {"card_wins_whole_call_at_rows": wins,
                 "card_wins_terms_at_rows": terms_wins})


# 6. calibration on the card: which module counts each profiled kernel's
# launches (decode_attention is plain torch: no kernel)
CALIB_MODULES = {"flash_attention_fwd": "flash_attention_fwd",
                 "flash_attention_bwd": "flash_attention_fwd",
                 "moe_gmm": "moe_gmm", "ssd": "ssd_scan",
                 "rmsnorm": "rmsnorm"}
CALIB_OUT = ROOT / "build" / "calib_h100.json"


def phase_calibrate():
    """``cli calibrate`` on the card (the full grid), its launches, rows
    and fits; then a study on the fitted constants, card vs CPU path."""
    from repro_torch import cli
    from repro_torch.api import Scenario, Study
    from repro_torch.calib import load_calibration

    mods = _kernel_modules()
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["calibrate", "--device", "cuda", "--out", str(CALIB_OUT)])
    wall_s = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}
    check(rc == 0, f"calibrate: exit code {rc}")
    load_calibration.cache_clear()
    calib = load_calibration(str(CALIB_OUT))
    rows = calib["measurements"]
    expected = {name: 0 for name in mods}
    for r in rows:
        mod = CALIB_MODULES.get(r["kernel"])
        if mod:
            # one warm-up, then reps (times repeats at the top points
            # that are timed more than once)
            expected[mod] += 1 + r["reps"] * r.get("repeats", 1)
            check(r["impl"].startswith(f"cuda:{mod}"),
                  f"calibrate {r['kernel']} x={r['x']}: ran {r['impl']}, "
                  f"not the hand kernel")
        else:
            check(r["impl"] == "torch", f"calibrate {r['kernel']}: "
                  f"{r['impl']}")
        check(r["dtype"] == "float32", f"calibrate {r['kernel']}: dtype")
    log("calibrate", f"main-path launches {launches}; expected {expected}")
    check(launches == expected, "calibrate: every kernel launched warm-up + "
          "reps (x repeats) times per grid point")
    for r in rows:
        log("calibrate", {k: r[k] for k in ("kernel", "axis", "x", "impl",
                                            "time_s", "flops_per_s",
                                            "bytes_per_s", "times_s")
                          if k in r})
    peaks = {"compute": PEAK_FLOPS[torch.float32],
             "memory": PEAK_BYTES_PER_S}
    fits = {}
    for name, f in sorted(calib["kernels"].items()):
        rate = "flops_per_s" if f["kind"] == "compute" else "bytes_per_s"
        m_rows = [r for r in rows if r["kernel"] == name and r["axis"] == "m"]
        n_rows = [r for r in rows if r["kernel"] == name and r["axis"] == "n"]
        fits[name] = {"kind": f["kind"], "peak": f["peak"],
                      "best_measured": max(r[rate] for r in rows
                                           if r["kernel"] == name),
                      "card_peak": peaks[f["kind"]],
                      "m_half": f["m_half"],
                      "peak_over_best": f["peak"] / max(
                          r[rate] for r in rows if r["kernel"] == name),
                      # the fit searches half up to 16x the largest x: a
                      # half there means the rate never bent in the grid
                      "m_half_at_edge": f["m_half"] >= 16 * max(
                          r["x"] for r in m_rows) * (1 - 1e-9),
                      "n_half": f.get("n_half"),
                      "n_half_at_edge": bool(n_rows) and f["n_half"] >=
                      16 * max(r["x"] for r in n_rows) * (1 - 1e-9),
                      "rel_rmse": f["rel_rmse"],
                      "impl": next(r["impl"] for r in rows
                                   if r["kernel"] == name)}
    log("calibrate", {"wall_s": wall_s, "rows": len(rows),
                      "provenance": calib["provenance"], "fits": fits,
                      "effective": calib["effective"]})
    # A fit over the card's peak means the timer or the count is wrong;
    # a half at the top of the fit's search means the rate never bent in
    # the grid, so the fitted peak is an extrapolation.
    for name, f in fits.items():
        check(f["peak"] < f["card_peak"], f"calibrate {name}: fitted peak "
              f"{f['peak']:.4g} over the card's {f['card_peak']:.4g}")
        check(f["best_measured"] < f["card_peak"], f"calibrate {name}: a "
              f"measured rate {f['best_measured']:.4g} over the card's "
              f"{f['card_peak']:.4g}")
        check(not f["m_half_at_edge"] and not f["n_half_at_edge"],
              f"calibrate {name}: a half at the top of the fit's search "
              f"(m_half {f['m_half']:.6g}, n_half {f['n_half']})")

    sc = Scenario.load(ROOT / "scenarios" / "paper_qwen3.json").replace(
        calibration=str(CALIB_OUT))
    t0 = time.perf_counter()
    card = Study(sc).run(device="cuda")
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = Study(sc).run(device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    worst = _compare_studies("paper_qwen3+calibrated", card, cpu)
    check(card.best is not None, "calibrated study: a feasible best point")
    best = card.records[card.best].metrics
    log("calibrate", {
        "scenario": "paper_qwen3+calibrated", "records": len(card.records),
        "best_throughput": best["throughput"], "best_mfu": best["mfu"],
        "wall_ms": card_ms, "cpu_path_wall_ms": cpu_ms,
        "calibration": card.provenance["calibration"],
        "max_rel_diff_vs_cpu": worst})
    return launches


# ---------------------------------------------------------------------------
# 7. grad: the ops' gradients on the card (ROADMAP C12)
# ---------------------------------------------------------------------------
GRAD_CASES = [
    # name, op, shape, dtype.  rmsnorm: (rows, D); ssd: (Bb, S, H, P, G,
    # N, chunk); gmm: (experts, rows per expert, K, N, block_t); flash:
    # (B, Hq, Hkv, Sq, Sk, D, causal).  TinyLlama's and Mamba2's norm
    # widths, Mamba2's SSD and TinyLlama's attention at the train shape
    # (batch 8 x 1024), Qwen3-MoE's gmm w1 at prefill and at decode.
    ("tinyllama_ln", "rmsnorm", (SERVE_BATCH * SERVE_PROMPT, 2048), BF16),
    ("tinyllama_ln_fp32", "rmsnorm", (SERVE_BATCH * SERVE_PROMPT, 2048),
     FP32),
    ("mamba2_ln", "rmsnorm", (SERVE_BATCH * SERVE_PROMPT, 1536), BF16),
    ("mamba2_gate_norm", "rmsnorm", (SERVE_BATCH * SERVE_PROMPT, 3072), BF16),
    ("mamba2_gate_norm_fp32", "rmsnorm", (SERVE_BATCH * SERVE_PROMPT, 3072),
     FP32),
    ("mamba2_ssd", "ssd", (8, 1024, 48, 64, 1, 128, 128), BF16),
    ("mamba2_ssd_state", "ssd_state", (8, 1024, 48, 64, 1, 128, 128), BF16),
    ("mamba2_ssd_fp32", "ssd", (8, 1024, 48, 64, 1, 128, 128), FP32),
    ("qwen3_w1", "gmm", (128, 640, 4096, 1536, 128), BF16),
    ("qwen3_decode", "gmm", (128, 8, 4096, 1536, 8), BF16),
    ("qwen3_decode_fp32", "gmm", (128, 8, 4096, 1536, 8), FP32),
    ("tinyllama_flash", "flash", (8, 32, 4, 1024, 1024, 64, True), BF16),
    ("flash_fp32", "flash", (2, 32, 4, 512, 512, 64, True), FP32),
    # the train paths of the moe, vlm, hybrid and encdec families (batch
    # 8 x 1024; Whisper 8 x 384 over 1500 frames): Whisper's
    # cross-attention (non-causal, Sq != Sk) and encoder, LLaVA's GQA
    # group of 7, Zamba2's shared block at D = 112, Mixtral's gmm w1 and
    # w2 (2560 rows of each of 8 experts), Zamba2's SSD (112 heads, N 64)
    ("whisper_cross_flash", "flash", (8, 16, 16, 384, 1500, 64, False),
     BF16),
    ("whisper_encoder_flash", "flash", (8, 16, 16, 1500, 1500, 64, False),
     BF16),
    ("llava_flash", "flash", (8, 56, 8, 1024, 1024, 128, True), BF16),
    ("zamba2_flash", "flash", (8, 32, 32, 1024, 1024, 112, True), BF16),
    ("mixtral_w1", "gmm", (8, 2560, 4096, 14336, 128), BF16),
    ("mixtral_w2", "gmm", (8, 2560, 14336, 4096, 128), BF16),
    ("zamba2_ssd", "ssd", (8, 1024, 112, 64, 1, 64, 128), BF16),
]
# Relative L2 of each gradient of the op (kernel forward) against autograd
# through its plain version on the same CUDA tensors.  rmsnorm and ssd:
# the backward is that same autograd, recomputed from the same inputs, so
# only float32 sums in another order (atomics) differ, which move a bf16
# gradient by an ulp at rare elements.  gmm: dx is the kernel's own
# rounding of each float32 sum to the output dtype, dw float32 sums over
# an expert's rows at once where autograd adds block by block.  flash: the
# backward reads the kernel's o and lse, each one bf16 rounding (or an
# fp32 exp2/log) from the plain version's.
GRAD_TOL = {"rmsnorm": {BF16: 1e-3, FP32: 1e-6},
            "ssd": {BF16: 1e-3, FP32: 1e-6},
            "gmm": {BF16: 1e-2, FP32: 1e-5},
            "flash": {BF16: 2e-2, FP32: 1e-4}}

# the kernel module each grad case's op launches
GRAD_KERNEL = {"rmsnorm": "rmsnorm", "ssd": "ssd_scan",
               "ssd_state": "ssd_scan", "gmm": "moe_gmm",
               "flash": "flash_attention_fwd"}


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float64, on the card (the train check's
    CPU tensors too: hundreds of millions of elements a comparison)."""
    got, want = (t.to("cuda").to(torch.float64) for t in (got, want))
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _grad_case(op, shape, dt, gen):
    """-> (the op as fn(*inputs), its plain version likewise, the
    inputs (all differentiable), the output gradients, the forward's
    operations, the one PyTorch call of the same function or None)."""
    from repro_torch.kernels import cost, ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.kernels.ref import rmsnorm_ref, ssd_chunked_ref

    def rnd(*s, scale=1.0, dtype=dt):
        return (scale * torch.randn(*s, device="cuda", generator=gen)).to(
            dtype).requires_grad_()
    if op == "rmsnorm":
        rows, d = shape
        ins = [rnd(rows, d), (1.0 + 0.1 * torch.randn(
            d, device="cuda", generator=gen)).to(dt).requires_grad_()]
        return (lambda x, w: ops.rmsnorm(x, w),
                lambda x, w: rmsnorm_ref(x, w), ins,
                [torch.randn(rows, d, device="cuda", generator=gen).to(dt)],
                4.0 * rows * d,
                lambda x, w: F.rms_norm(x, (d,), w, eps=1e-6))
    if op.startswith("ssd"):
        bb, s, h, p, g, n, chunk = shape
        state = op == "ssd_state"
        ins = [rnd(bb, s, h, p),
               F.softplus(torch.randn(bb, s, h, device="cuda",
                                      generator=gen)).requires_grad_(),
               (-torch.exp(0.5 * torch.randn(h, device="cuda", generator=gen))
                ).requires_grad_(),
               rnd(bb, s, g, n, scale=0.3), rnd(bb, s, g, n, scale=0.3)]
        douts = [torch.randn(bb, s, h, p, device="cuda", generator=gen).to(dt)]
        if state:
            douts.append(torch.randn(bb, h, p, n, device="cuda",
                                     generator=gen))

        def plain(*t):
            y, st = ssd_chunked_ref(*t, chunk=chunk)
            return (y, st) if state else y
        return (lambda *t: ops.ssd(*t, chunk=chunk, return_state=state),
                plain, ins, douts, cost.ssd_flops(bb, s, h, p, n, chunk),
                None)
    if op == "gmm":
        e, rows, k, n, bt = shape
        ids = torch.arange(e, dtype=torch.int32, device="cuda") \
            .repeat_interleave(rows // bt)
        t = e * rows
        ins = [rnd(t, k), rnd(e, k, n, scale=k ** -0.5)]
        return (lambda x, w: ops.moe_gmm(x, w, ids, block_t=bt),
                lambda x, w: moe_gmm_plain(x, w, ids, bt), ins,
                [torch.randn(t, n, device="cuda", generator=gen).to(dt)],
                2.0 * t * k * n,
                lambda x, w: torch.bmm(x.view(e, rows, k), w).view(t, n))
    b, hq, hkv, sq, sk, d, causal = shape
    ins = [rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)]
    return (lambda q, k, v: ops.flash_attention(q, k, v, causal=causal),
            lambda q, k, v: flash_attention_plain(q, k, v,
                                                  causal=causal)[0], ins,
            [torch.randn(b, hq, sq, d, device="cuda", generator=gen).to(dt)],
            4.0 * d * cost.attn_live_pairs(sq, sk, None, causal) * b
            * hq,
            # SDPA's causal mask is top-left aligned: the causal cases
            # here have Sq == Sk, where it is the kernel's
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))


def _fwd_bwd(fn, ins, douts):
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, ins, douts[:len(outs)])


def phase_grad():
    """Every differentiable kernel op on the card: the output has a
    grad_fn, and each input's gradient matches autograd through the plain
    version on the same inputs; forward + backward timed with its bound
    (bytes: every input, output gradient, output and input gradient once;
    operations: the forward's and the backward's, which is twice the
    forward's products for the SSD and the gmm and 2.5 times for flash)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    card = card_line()
    mods = _kernel_modules()
    for m in mods.values():
        m.launches = 0
    records = {}
    for name, op, shape, dt in GRAD_CASES:
        fn, plain, ins, douts, flops, library = _grad_case(op, shape, dt, gen)
        outs, grads = _fwd_bwd(fn, ins, douts)
        check(all(o.grad_fn is not None for o in outs),
              f"grad {name}: the output has a grad_fn on the card")
        outs_p, grads_p = _fwd_bwd(plain, ins, douts)
        kind = "ssd" if op.startswith("ssd") else op
        tol = GRAD_TOL[kind][dt]
        errs = [rel_l2(g, gp) for g, gp in zip(grads, grads_p)]
        check(all(math.isfinite(e) for e in errs) and max(errs) <= tol,
              f"grad {name}: gradients vs autograd through the plain "
              f"version, relative L2 {errs} (tol {tol})")
        fwd_err = max(rel_l2(o.float(), op_.float())
                      for o, op_ in zip(outs, outs_p))
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*ins, *douts, *outs, *grads))
        # every expert of a gmm case owns rows: all its weights count
        mult = 3.5 if op == "flash" else 3.0
        rec = {"case": name, "card": card, "op": op, "shape": list(shape),
               "dtype": str(dt), "grad_rel_l2": errs, "tol": tol,
               "fwd_rel_l2": fwd_err, "max_abs_err": max(errs)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(mult * flops, nbytes, dt)
        iters = 3 if op in ("ssd", "ssd_state", "flash") else 10
        rec["ms"] = time_ms(lambda: _fwd_bwd(fn, ins, douts), iters,
                            warmup=1)
        # the plain version's check call above was its warm-up
        rec["plain_ms"] = time_ms(lambda: _fwd_bwd(plain, ins, douts), 1,
                                  warmup=0, repeats=1)
        rec["library_ms"] = (time_ms(lambda: _fwd_bwd(library, ins, douts),
                                     iters, warmup=1)
                             if library else None)
        records[name] = rec
        log("grad", rec)
        del fn, plain, ins, douts, outs, grads, outs_p, grads_p
        torch.cuda.empty_cache()
    launches = {n: m.launches for n, m in mods.items()}
    log("grad", f"launches in the phase (checks and timing) {launches}")
    return launches, records


# ---------------------------------------------------------------------------
# 8. train: every family at full width, on one card
# ---------------------------------------------------------------------------
# arch, label, depth trained (None: the config's), sequence length (encdec:
# the decoder's, over the config's 1500 encoder frames), depth of the
# card-vs-CPU check, its sequence length, timed steps.  A training state
# costs ~18 B a parameter (float32 weights, gradients, m and v, and the
# bf16 copy of each call), so the configs past one 80 GB card train at a
# cut depth.  Mamba2's and Zamba2's steps are the longest (1.5-2.2 s and
# 0.9 s): they time 5 steps, the others 10.
TRAIN_PATHS = (
    ("tinyllama-1.1b", "train_tinyllama", None, 1024, 2, 256, 10),
    ("mamba2-780m", "train_mamba2", None, 1024, 2, 256, 5),
    # 2 of 32 layers, 3.165 B params (57.0 GB at 18 B); the check's one
    # layer is 1.713 B, ~6.9 GB a float32 copy on the host
    ("mixtral-8x7b", "train_mixtral", 2, 1024, 1, 256, 10),
    # 2 of 60 layers, 2.033 B params (36.6 GB); the check's prompt holds
    # the 576 prefix positions, which the loss mask leaves out
    ("llava-next-34b", "train_llava", 2, 1024, 1, 640, 10),
    # 15 of 81 layers: 2 periods of 6 and the shared block, then 3
    # leftover layers, as 81 = 13 x 6 + 3; the check runs one period and
    # one leftover layer, as its serve check
    ("zamba2-7b", "train_zamba2", 15, 1024, 7, 256, 5),
    # all 24 + 24 layers over 1500 frames, a 384-token decoder; the check
    # runs 2 + 2 layers
    ("whisper-medium", "train_whisper", None, WHISPER_PROMPT, 2, 256, 10),
)
# every train batch comes from data.DataPipeline, the generator
# launch.train trains on (a vlm's loss mask in the compute dtype)
TRAIN_BATCH = SERVE_BATCH
TRAIN_STATE_BYTES_PER_PARAM = 18
TRAIN_WARMUP = 3
# remat (ExecConfig.remat): from the timed steps' state and one batch, a
# make_grad_step under "none" and one under "full" (TinyLlama also
# "dots"); the loss and every parameter's gradient norm within this of
# "none"'s (the recompute repeats the same kernels on the same inputs:
# bit for bit is expected and logged); "dots"' gradients element by
# element, bit for bit or within BF16_SLACK relative L2 (the bf16 gate
# without its 2 e_plain term)
REMAT_RTOL = 1e-3
REMAT_DOTS_ARCH = "tinyllama-1.1b"
# TinyLlama's train steps timed under "full" (after one warm-up), beside
# the phase's "none" steps
REMAT_TIMED = 3
# the learning check: tests/test_substrate.py's schedule (warm-up 5 of
# 120) at base lr 5e-4 where it has 5e-3, one fixed batch; the mean of
# the last 3 losses must sit this far under the first 3's (the
# reference's own margin, there over means of 5 of 60 steps).  The
# first AdamW steps move every weight by ~lr, and the
# weights' scale is d_model^-0.5: at 5e-3 the loss of TinyLlama, Mamba2
# and Whisper swung back above its start within 20 steps on an H100, and
# that of LLaVA (2 layers, d_model 7168) and Zamba2 (15) climbed from ~11
# to 40 and 22; at 5e-4 LLaVA, Mixtral and Zamba2 fell below 0.06.  10
# steps: after 10 the means sat 2.47-10.25 under the first 3's on every
# path, and the script's time goes to the remat checks.
LEARN_STEPS, LEARN_LR, LEARN_MARGIN = 10, dict(base_lr=5e-4, warmup=5,
                                               total=120), 0.3

# card vs CPU: the path's check depth at full width, batch 2, float32
CHECK_TRAIN_BATCH = 2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4     # each gradient, m (linear in it) and v
# the card's parameters, m and v after one update against the CPU's AdamW
# on the card's gradients: float32 elementwise arithmetic, sqrt and
# division a rounding apart, the global norm summed in another order
TRAIN_OPT_REL_L2 = 1e-6
# bf16: each gradient's error against the float32 gradient of its own
# device, the kernel path's against twice the plain path's (the CPU's)
BF16_FACTOR, BF16_SLACK = 2.0, 1e-3
# where _train_run's outputs hold each compared quantity
TRAIN_OUT = {"grad": 1, "m": 3, "v": 4, "param": 2}
HAND_KERNELS = ("fa_wgmma_kernel", "fa_fwd_kernel", "rmsnorm_reg_kernel",
                "rmsnorm_loop_kernel", "chunk_state_kernel",
                "state_pass_kernel", "chunk_scan_kernel", "ssd_kernel",
                "gmm_wgmma_kernel", "gmm_decode_kernel", "gmm_fma_kernel")
BACKWARD_NODES = {"flash_attention_bwd_plain": "_FlashAttentionBackward",
                  "rmsnorm recompute": "_RMSNormBackward",
                  "ssd recompute": "_SSDBackward",
                  "moe_gmm dx kernel + dw loop": "_MoEGMMBackward"}


def expected_train_launches(cfg, seq: int) -> dict:
    """Kernel launches of one train step (accum 1) of ``seq`` tokens (an
    encdec's decoder's), derived from the models' code.  The forward
    launches each kernel as a prefill does (``expected_launches``' counts
    without decode); in the backward, rmsnorm and the SSD recompute
    through their plain versions and flash's backward is torch ops, which
    launch none, and the gmm's dx is the gmm kernel itself over the
    transposed experts: one more launch for each forward one."""
    counts = {"flash_attention_fwd": 0, "rmsnorm": 0, "ssd_scan": 0,
              "moe_gmm": 0, "wavefront": 0}
    if cfg.family == "encdec":
        # encoder: flash and ln1, ln2 a layer, its final norm; decoder:
        # flash for self- and cross-attention, ln1, ln_x and ln2 a layer,
        # the final norm
        counts["flash_attention_fwd"] = cfg.encoder_layers + 2 * cfg.n_layers
        counts["rmsnorm"] = 2 * cfg.encoder_layers + 1 + 3 * cfg.n_layers + 1
        return counts
    if cfg.family in ("ssm", "hybrid"):
        # per SSM layer its norm and the gate norm, one final norm; in bf16
        # the SSD runs three kernels where the sequence holds more than
        # one chunk, else the chunk scan alone
        counts["rmsnorm"] = 2 * cfg.n_layers + 1
        counts["ssd_scan"] = (3 if seq > cfg.ssm.chunk else 1) * cfg.n_layers
        if cfg.family == "hybrid":
            # every application of the shared block: flash, ln1 and ln2
            n_apps = cfg.n_layers // cfg.hybrid_period
            counts["flash_attention_fwd"] = n_apps
            counts["rmsnorm"] += 2 * n_apps
        return counts
    # dense, moe and vlm: per layer flash, ln1, ln2 and, with qk-norm, one
    # launch each for q and k; the final norm
    norms = 2 + (2 if cfg.attn.qk_norm else 0)
    counts["flash_attention_fwd"] = cfg.n_layers
    counts["rmsnorm"] = norms * cfg.n_layers + 1
    if cfg.moe is not None:
        # w1, w3 and w2 of every layer forward, and each one's dx backward
        counts["moe_gmm"] = 2 * 3 * cfg.n_layers
    return counts


def expected_remat_launches(cfg, seq: int) -> dict:
    """Kernel launches of one train step under remat "full" (or "dots"):
    ``expected_train_launches``' and, again in the backward, the forward
    kernels of every layer body that remat wraps: each layer of a dense,
    moe, vlm or ssm model and of Whisper's encoder and decoder, and of
    Zamba2 its whole periods only (the leftover layers run without
    remat).  The final norms are outside every body, and the gmm's dx is
    the backward's own."""
    counts = expected_train_launches(cfg, seq)
    if cfg.family == "encdec":
        counts["flash_attention_fwd"] += cfg.encoder_layers + 2 * cfg.n_layers
        counts["rmsnorm"] += 2 * cfg.encoder_layers + 3 * cfg.n_layers
        return counts
    if cfg.family in ("ssm", "hybrid"):
        n_apps = cfg.n_layers // cfg.hybrid_period \
            if cfg.family == "hybrid" else 0
        wrapped = n_apps * cfg.hybrid_period if n_apps else cfg.n_layers
        counts["rmsnorm"] += 2 * wrapped + 2 * n_apps
        counts["ssd_scan"] += (3 if seq > cfg.ssm.chunk else 1) * wrapped
        counts["flash_attention_fwd"] += n_apps
        return counts
    norms = 2 + (2 if cfg.attn.qk_norm else 0)
    counts["flash_attention_fwd"] += cfg.n_layers
    counts["rmsnorm"] += norms * cfg.n_layers
    if cfg.moe is not None:
        counts["moe_gmm"] += 3 * cfg.n_layers
    return counts


def _model_flops(cfg, model, seq: int) -> float:
    """Model FLOPs of one train step: 6 N a token, N the parameters in
    products (all but an untied input embedding and Whisper's pos_embed;
    of a MoE's experts the top_k / n_experts a token uses; Zamba2's shared
    block once per application; Whisper's encoder over its frames, its
    decoder over the tokens), plus attention's 12 d a (query, key) pair
    (forward and backward, no causal saving counted): L S^2 a sequence,
    Zamba2's per application, Whisper's encoder over 1500^2, its
    decoder's self-attention over S^2 and cross-attention over S x 1500."""
    named = dict(model.named_parameters())
    n = sum(p.numel() for p in named.values())
    if not cfg.tie_embeddings and cfg.family != "ssm":
        n -= model.embed.numel()
    if cfg.moe is not None:
        experts = sum(p.numel() for name, p in named.items()
                      if name.split(".")[-1] in ("w1", "w2", "w3")
                      and ".moe." in name)
        n -= experts * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    tokens = TRAIN_BATCH * seq
    a = cfg.attn
    pair = 12.0 * a.head_dim * a.n_heads * TRAIN_BATCH if a else 0.0
    if cfg.family == "encdec":
        enc = sum(p.numel() for name, p in named.items()
                  if name.startswith(("enc_layers.", "enc_norm")))
        dec = n - enc - model.pos_embed.numel()
        frames = cfg.encoder_len
        return (6.0 * enc * TRAIN_BATCH * frames + 6.0 * dec * tokens
                + pair * (cfg.encoder_layers * frames ** 2
                          + cfg.n_layers * (seq ** 2 + seq * frames)))
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.hybrid_period
        shared = sum(p.numel() for p in model.shared.parameters())
        return 6.0 * (n + (n_apps - 1) * shared) * tokens \
            + pair * n_apps * seq ** 2
    return 6.0 * n * tokens + (pair * cfg.n_layers * seq ** 2 if a else 0.0)


def _host_memory() -> dict:
    """The host's available memory (GB, /proc/meminfo) and this process's
    peak resident set so far (GB)."""
    import resource
    avail = next(int(line.split()[1]) for line in
                 open("/proc/meminfo") if line.startswith("MemAvailable"))
    return {"host_available_gb": avail * 1024 / 1e9, "peak_rss_gb":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9}


def _train_region(name: str):
    """The label of a CPU range the step's device time is split by: its
    forward and optimiser spans, each kernel op's backward node."""
    if name in ("train.forward", "train.optimizer"):
        return name[6:]
    return next((k for k, v in BACKWARD_NODES.items()
                 if name.endswith("evaluate_function: " + v)), None)


def _profile_step(step, state, batch):
    """One step under torch.profiler: wall, device busy and idle share,
    device ms of the forward, the optimiser and the rest (the backward),
    of each kernel op's backward node, and by kernel class.  It reads the
    profiler's raw events: its own event tree costs ~60 us an event to
    build, about a minute for a Mamba2 step's."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a kernel's linked correlation id names the op that launched it (a
    # CPU event with no link of its own, as the profiler's parse has it);
    # the op's thread and start place it in a region of that thread
    launcher, spans, kernels = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                launcher[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
            label = _train_region(e.name())
            if label:
                spans.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), label))
        # the record_function spans' device-side copies would count their
        # kernels twice
        elif not e.name().startswith("train."):
            kernels.append((e.name(), e.duration_ns() / 1e6,
                            e.linked_correlation_id()))
    for v in spans.values():
        v.sort()
    busy = sum(ms for _, ms, _ in kernels)
    check(busy > 0, "train profile: the trace holds device time")
    regions = {}
    for _, ms, corr in kernels:
        thread, t = launcher.get(corr, (None, 0))
        ranges = spans.get(thread, [])
        i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
        if i >= 0 and ranges[i][1] >= t:
            regions[ranges[i][2]] = regions.get(ranges[i][2], 0.0) + ms
    by_class, by_hand = {"hand kernels": 0.0, "cuBLAS products": 0.0,
                         "other (elementwise, copies, reductions)": 0.0}, {}
    for name, ms, _ in kernels:
        hand = next((h for h in HAND_KERNELS if h in name), None)
        if hand:
            by_class["hand kernels"] += ms
            by_hand[hand] = by_hand.get(hand, 0.0) + ms
        elif any(t in name.lower() for t in ("gemm", "nvjet", "xmma",
                                             "cutlass")):
            by_class["cuBLAS products"] += ms
        else:
            by_class["other (elementwise, copies, reductions)"] += ms
    top = {}
    for name, ms, _ in kernels:
        top[name[:90]] = top.get(name[:90], 0.0) + ms
    fwd, opt = regions.get("forward", 0.0), regions.get("optimizer", 0.0)
    return state, {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "forward_ms": fwd, "optimizer_ms": opt,
        "backward_ms": busy - fwd - opt,
        "backward_nodes_ms": {k: regions.get(k, 0.0)
                              for k in BACKWARD_NODES},
        "by_class_ms": by_class, "hand_kernels_ms": by_hand,
        "top_kernels": sorted(top.items(), key=lambda kv: -kv[1])[:12]}


def _train_run(cfg, ex, source, batch, update=True, **lr):
    """A copy of the module ``source`` on ``ex.device``, one train step on
    ``batch`` -> (loss, {name: gradient}, {name: parameter after the
    update}, m, v); with ``update`` False the step's gradients alone
    (``make_grad_step``) -> (loss, {name: gradient})."""
    from repro_torch.launch.steps import (TrainState, make_grad_step,
                                          make_train_step)
    from repro_torch.optim import adamw_init
    model = type(source)(cfg, device="meta", dtype=ex.param_dtype)
    model.to_empty(device=ex.device)
    model.load_state_dict(source.state_dict())
    if not update:
        loss, _ = make_grad_step(cfg, ex)(model, batch)
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}
    state = TrainState(model=model,
                       opt=adamw_init(dict(model.named_parameters())))
    state, met = make_train_step(cfg, ex, **lr)(state, batch)
    named = dict(state.model.named_parameters())
    return (met["loss"].item(), {n: p.grad for n, p in named.items()},
            {n: p.detach() for n, p in named.items()}, state.opt.m,
            state.opt.v)


def _train_check(arch: str, depth: int, seq: int):
    """``depth`` layers at full width (an encdec's encoder as deep as its
    decoder): one step in float32 on the card (the kernels) and on the CPU
    (the plain versions) from the same weights and batch; then each
    device's bf16-compute gradients against its own float32 ones.  Each
    run's results are compared and dropped as soon as they can be, so
    that a 1.7 B-parameter layer fits the host: the card's float32 step
    stays on the card, the CPU's AdamW on the card's gradients is checked
    before the CPU's own steps run, and a bf16 run (the step's gradients,
    no update) keeps its errors only."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch.train import train_exec_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=depth, encoder_layers=(
        depth if cfg.encoder_layers else 0))
    fns = build_model(cfg)
    shape = ShapeConfig("check", "train", seq, CHECK_TRAIN_BATCH)
    # one set of weights for both devices (their generators draw apart)
    t0 = time.perf_counter()
    source = fns.init(SEED, train_exec_config(cfg, torch.device("cpu")))
    weights = source.state_dict()
    n_params = sum(t.numel() for t in weights.values())
    memory = {"start": _host_memory()}
    secs = {"init on the CPU": time.perf_counter() - t0}

    def run(dev, dt):
        # a float32 or float64 step whole, a bf16 step's gradients alone
        ex = dataclasses.replace(train_exec_config(cfg, torch.device(dev)),
                                 compute_dtype=dt)
        if dt == FP64:
            ex = dataclasses.replace(ex, param_dtype=dt)
        batch = DataPipeline(cfg, shape, SEED + 7, ex=ex).batch_at(0)
        t0 = time.perf_counter()
        out = _train_run(cfg, ex, source, batch, update=dt != BF16,
                         **LEARN_LR)
        secs[f"{dev}_{str(dt)[6:]}"] = time.perf_counter() - t0
        memory[f"after {dev} {str(dt)[6:]}"] = _host_memory()
        return out

    def bf16_errors(g16, g32):
        return {n: rel_l2(g16[n], g) for n, g in g32.items()}

    card = run("cuda", FP32)
    e_kernel = bf16_errors(run("cuda", BF16)[1], card[1])
    # the card's update against the CPU's AdamW applied to the card's own
    # gradients: the optimiser's arithmetic apart from the gradients'
    # error (at the first step the update is lr g/(|g| + eps), which
    # turns a small relative error of a gradient element near eps into a
    # large one of its update: conv_b, zero at init, is all update)
    t0 = time.perf_counter()
    w32 = {n: t.float() for n, t in weights.items()}
    upd = adamw_update(w32, {n: g.cpu() for n, g in card[1].items()},
                       adamw_init(w32), cosine_schedule(**LEARN_LR))
    secs["the CPU's AdamW on the card's gradients"] = \
        time.perf_counter() - t0
    worst, errs = {}, {}

    def compare(what, got, want, tol):
        errs[what] = {n: rel_l2(got[n], t) for n, t in want.items()}
        name = max(errs[what], key=errs[what].get)
        worst[what] = {"param": name, "rel_l2": errs[what][name], "tol": tol}

    for what, got, want in (("param, card's gradients", card[2], upd[0]),
                            ("m, card's gradients", card[3], upd[1].m),
                            ("v, card's gradients", card[4], upd[1].v)):
        compare(what, got, want, TRAIN_OPT_REL_L2)
    memory["card's gradients through the CPU's AdamW"] = _host_memory()
    del upd
    cpu = run("cpu", FP32)
    t0 = time.perf_counter()
    for what, i in TRAIN_OUT.items():
        compare(what, card[i], cpu[i],
                None if what == "param" else TRAIN_GRAD_REL_L2)
    secs["compare card vs CPU"] = time.perf_counter() - t0
    # Where a parameter's gradient, m or v misses the fixed tolerance, that
    # quantity is held against the CPU's float64 step instead: the card no
    # more than the fixed tolerance further from it than the CPU's float32
    # (which meeting the fixed tolerance implies).  Deep stacks' gradients
    # that sum with heavy cancellation (an SSM's D, conv_b, dt_bias,
    # A_log) turn float32 roundings into errors near the fixed tolerance:
    # over Zamba2's 7 layers the CPU's own float32 gradients sit up to
    # 1.09e-4 from float64, so the card cannot meet 1e-4 against them
    # however exact it is.
    missed = sorted({(what, n) for what in ("grad", "m", "v")
                     for n, e in errs[what].items() if e > TRAIN_GRAD_REL_L2})
    vs64 = []
    if missed:
        exact = run("cpu", FP64)
        for what, n in missed:
            i = TRAIN_OUT[what]
            e_card = rel_l2(card[i][n], exact[i][n])
            e_cpu = rel_l2(cpu[i][n], exact[i][n])
            limit = e_cpu + TRAIN_GRAD_REL_L2
            vs64.append({"what": what, "param": n, "e_card": e_card,
                         "e_cpu": e_cpu, "limit": limit,
                         "ratio": e_card / limit})
        vs64.sort(key=lambda r: -r["ratio"])
        del exact
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    loss_card, loss_cpu, cpu_grads = card[0], cpu[0], cpu[1]
    del card, cpu
    torch.cuda.empty_cache()
    e_plain = bf16_errors(run("cpu", BF16)[1], cpu_grads)
    del cpu_grads
    layers = (f"{depth} + {depth}" if cfg.encoder_layers else f"{depth}")
    log("train", {"model": cfg.name, "card": card_line(),
                  "check": "card vs CPU, float32", "layers": layers,
                  "params_b": n_params / 1e9,
                  "batch": CHECK_TRAIN_BATCH, "seq": seq,
                  "loss_card": loss_card, "loss_cpu": loss_cpu,
                  "loss_rel_err": loss_err, "loss_tol": TRAIN_LOSS_RTOL,
                  "worst": worst, "seconds": secs, "host_memory": memory,
                  "past_the_fixed_tolerance": len(missed),
                  "those_against_float64": {
                      "check": f"e_card <= e_cpu + {TRAIN_GRAD_REL_L2}",
                      "worst_five": vs64[:5]}})
    # bf16: the kernel path's error against twice the plain path's
    rows = []
    for n, ek in e_kernel.items():
        limit = BF16_FACTOR * e_plain[n] + BF16_SLACK
        rows.append({"param": n, "e_kernel": ek, "e_plain": e_plain[n],
                     "limit": limit, "ratio": ek / limit})
    rows.sort(key=lambda r: -r["ratio"])
    log("train", {"model": cfg.name, "card": card_line(),
                  "check": "bf16 gradients, e_kernel <= "
                  f"{BF16_FACTOR} e_plain + {BF16_SLACK}",
                  "worst_five": rows[:5],
                  "largest_e_kernel": max(r["e_kernel"] for r in rows),
                  "largest_e_plain": max(r["e_plain"] for r in rows)})
    check(loss_err <= TRAIN_LOSS_RTOL, f"train {cfg.name}: card loss vs CPU "
          f"{loss_err} (tol {TRAIN_LOSS_RTOL})")
    # the update's arithmetic; each gradient, m and v past the fixed
    # tolerance is in vs64
    for what, w in worst.items():
        if what not in ("grad", "m", "v", "param"):
            check(w["rel_l2"] <= w["tol"], f"train {cfg.name}: card {what} "
                  f"vs CPU at {w['param']}: {w['rel_l2']} (tol {w['tol']})")
    bad = [r for r in vs64 if not r["e_card"] <= r["limit"]]
    check(not bad, f"train {cfg.name}: float32 gradients, m or v past the "
          f"fixed tolerance and the float64 one: {bad}")
    bad = [r for r in rows if not r["e_kernel"] <= r["limit"]]
    check(not bad, f"train {cfg.name}: bf16 gradients past the derived "
          f"tolerance: {bad}")


def _remat_grads(cfg, ex, model, batch, remat: str, mods, keep=None):
    """One ``make_grad_step`` under ``remat`` from ``model``'s weights ->
    (loss, each parameter's gradient norm and the int64 sum of its bits
    (on the host), the peak bytes allocated, the bytes allocated when the
    forward saved its last tensor for the backward (the activations it
    holds, read by a saved-tensors hook that changes nothing), the
    step's launches (every count set to 0 just before, read just after),
    and the gradients themselves on ``keep`` ("cpu" or "cuda"), else
    None: they are dropped)."""
    from repro_torch.launch.steps import make_grad_step
    grad_step = make_grad_step(cfg, dataclasses.replace(ex, remat=remat))
    params = list(model.parameters())
    for p in params:
        p.grad = None
    # the forward ends where the backward unpacks its first tensor (the
    # kernels' backwards save tensors of their own after that)
    held, forward = [0], [True]

    def pack(t):
        if forward[0]:
            held[0] = max(held[0], torch.cuda.memory_allocated())
        return t

    def unpack(t):
        forward[0] = False
        return t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        loss, _ = grad_step(model, batch)
    torch.cuda.synchronize()
    launches = {n: mod.launches for n, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        norms = torch.stack([p.grad.float().norm() for p in params]).cpu()
        bits = torch.stack([p.grad.view(torch.int32).sum(dtype=torch.int64)
                            for p in params]).cpu()
    grads = [p.grad.to(keep) for p in params] if keep else None
    for p in params:
        p.grad = None
    return loss.item(), norms, bits, peak, held[0], launches, grads


def _remat_check(arch, cfg, ex, state, batch, seq, mods, step_ms,
                 batches):
    """remat on the timed steps' state: one grad step under "none", one
    under "full" (and for TinyLlama "dots"): the loss and every gradient
    norm within REMAT_RTOL (bit for bit logged), the bytes held at the
    forward's end below "none"'s and each peak not above it (TinyLlama:
    peaks none > dots > full; where a few wide layers' float32 gradients
    set the peak, in the first layer's backward, remat cannot lower it:
    Mixtral at 2 layers peaks alike), "full"'s launches those of
    ``expected_remat_launches``; TinyLlama's "dots" gradients element by
    element against "none"'s, then REMAT_TIMED train steps under "full"
    after a warm-up.  Only the norms are kept between the runs (and
    TinyLlama's "none" gradients), so that Mixtral's state fits.  -> the
    "full" step's launches."""
    from repro_torch.launch.steps import make_train_step
    t0 = time.perf_counter()
    dots = arch == REMAT_DOTS_ARCH
    # TinyLlama's "none" gradients wait on the host, so that every run
    # starts from the same bytes on the card
    keep = {"none": "cpu", "dots": "cuda"} if dots else {}
    runs = {remat: _remat_grads(cfg, ex, state.model, batch, remat, mods,
                                keep=keep.get(remat))
            for remat in ("none", "full") + (("dots",) if dots else ())}
    loss0, norms0, bits0, peak0, held0, launches0, grads0 = runs["none"]
    rec = {"model": cfg.name, "card": card_line(), "layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": seq, "none": {
               "loss": loss0, "peak_bytes": peak0,
               "forward_end_bytes": held0, "launches": launches0}}
    for remat in ("full", "dots"):
        if remat not in runs:
            continue
        loss, norms, bits, peak, held, launches, _ = runs[remat]
        rel = ((norms - norms0).abs() / norms0.clamp_min(1e-30)).max().item()
        rec[remat] = {
            "loss": loss, "loss_rel_gap": abs(loss - loss0) / abs(loss0),
            "max_grad_norm_rel_gap": rel,
            "bit_for_bit": loss == loss0 and torch.equal(norms, norms0)
            and torch.equal(bits, bits0),
            "peak_bytes": peak, "peak_over_none": peak / peak0,
            "forward_end_bytes": held,
            "forward_end_over_none": held / held0, "launches": launches}
        check(abs(loss - loss0) <= REMAT_RTOL * abs(loss0) and
              rel <= REMAT_RTOL, f"train {cfg.name}: remat {remat} vs none: "
              f"loss {loss} vs {loss0}, gradient norms {rel} apart (tol "
              f"{REMAT_RTOL})")
        check(held < held0 and peak <= peak0, f"train {cfg.name}: remat "
              f"{remat} holds {held} B at the forward's end (none {held0}) "
              f"and peaks at {peak} (none {peak0})")
    expected = expected_remat_launches(cfg, seq)
    check(rec["full"]["launches"] == expected, f"train {cfg.name}: remat "
          f"full's launches {rec['full']['launches']}, expected {expected}")
    if dots:
        grads = runs["dots"][6]
        errs, bitwise = [], True
        for g, g0 in zip(grads, grads0):
            g0 = g0.cuda()
            errs.append(rel_l2(g, g0))
            bitwise = bitwise and torch.equal(g, g0)
        del grads, grads0, runs
        rec["dots"]["elementwise"] = {"bit_for_bit": bitwise,
                                      "max_rel_l2": max(errs),
                                      "tol": BF16_SLACK}
        check(bitwise or max(errs) <= BF16_SLACK, f"train {cfg.name}: remat "
              f"dots' gradients vs none's: {max(errs)} (tol {BF16_SLACK})")
        check(rec["none"]["peak_bytes"] > rec["dots"]["peak_bytes"]
              > rec["full"]["peak_bytes"], f"train {cfg.name}: peaks none "
              f"> dots > full: {rec['none']['peak_bytes']}, "
              f"{rec['dots']['peak_bytes']}, {rec['full']['peak_bytes']}")
        # train steps under "full" against the phase's "none" steps
        step = make_train_step(cfg, dataclasses.replace(ex, remat="full"))
        state, _ = step(state, batches[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches[1:1 + REMAT_TIMED]:
            state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        full_ms = start.elapsed_time(end) / REMAT_TIMED
        check(math.isfinite(m["loss"].item()), f"train {cfg.name}: remat "
              f"full's timed steps: finite loss")
        rec["full"].update({"step_ms": full_ms, "none_step_ms": step_ms,
                            "step_over_none": full_ms / step_ms})
    log("train", {"check": "remat", **rec,
                  "seconds": time.perf_counter() - t0})
    return rec["full"]["launches"]


def phase_train(arch: str, depth, seq: int, check_depth: int,
                check_seq: int, timed: int):
    """Train at full width (``depth`` layers, None: all): 3 warm-up and
    ``timed`` timed steps with the launch counts of one, a profiled step,
    remat against the plain step (``_remat_check``), the learning check;
    then the card-vs-CPU checks at ``check_depth``.  Returns the counted
    step's launches and the remat "full" step's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import train_exec_config

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    full_depth = cfg.n_layers
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    ex = train_exec_config(cfg, torch.device("cuda"))
    shape = ShapeConfig("train", "train", seq, TRAIN_BATCH)
    pipe = DataPipeline(cfg, shape, SEED, ex=ex)
    batches = [pipe.batch_at(i) for i in range(TRAIN_WARMUP + timed)]
    state = init_train_state(cfg, ex, SEED)
    step = make_train_step(cfg, ex)
    n_params = sum(p.numel() for p in state.model.parameters())
    state_gb = TRAIN_STATE_BYTES_PER_PARAM * n_params / 1e9
    enc = (f", {cfg.encoder_layers} encoder layers over {cfg.encoder_len} "
           f"frames" if cfg.encoder_layers else "")
    log("train", f"{cfg.name}: {cfg.n_layers} of {full_depth} layers{enc}, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"({state_gb:.1f} GB of training state at "
        f"{TRAIN_STATE_BYTES_PER_PARAM} B a param), float32 master weights, "
        f"bf16 compute, batch {TRAIN_BATCH} x {seq}")
    metrics = []
    for b in batches[:TRAIN_WARMUP]:
        state, m = step(state, b)
        metrics.append(m)
    mods = _kernel_modules()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i, b in enumerate(batches[TRAIN_WARMUP:]):
        if i == 0:
            for mod in mods.values():
                mod.launches = 0
        state, m = step(state, b)
        if i == 0:
            launches = {n: mod.launches for n, mod in mods.items()}
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    step_ms = start.elapsed_time(end) / timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    expected = expected_train_launches(cfg, seq)
    log("train", f"{cfg.name} one step's launches {launches}; expected "
        f"{expected}")
    check(launches == expected, f"train {cfg.name}: every kernel of the "
          f"step launched as often as the model calls it")
    check(all(math.isfinite(v) for v in losses + norms),
          f"train {cfg.name}: finite losses and grad norms")
    tokens = TRAIN_BATCH * seq
    flops = _model_flops(cfg, state.model, seq)
    state, prof = _profile_step(step, state, batches[-1])
    # the profiler slows the host: the idle share of the timed steps
    prof["device_idle_share_timed"] = max(
        0.0, 1.0 - prof["device_busy_ms"] / step_ms)
    log("train", {"model": cfg.name, "card": card_line(),
                  "layers": cfg.n_layers, "full_depth": full_depth,
                  "encoder_layers": cfg.encoder_layers,
                  "batch": TRAIN_BATCH, "seq": seq,
                  "step_ms": step_ms, "host_wall_ms_per_step": wall_ms,
                  "tokens_per_s": tokens / step_ms * 1e3,
                  "model_flops_per_step": flops,
                  "model_flops_per_s": flops / step_ms * 1e3,
                  "share_of_989_tflops": flops / step_ms * 1e3 / 989e12,
                  "peak_mem_gb": peak_gb, "state_gb_reckoned": state_gb,
                  "params_b": n_params / 1e9,
                  "losses": losses, "grad_norms": norms, "profile": prof})
    del step, metrics
    remat_launches = _remat_check(arch, cfg, ex, state, batches[-1], seq,
                                  mods, step_ms, batches)
    del state, batches
    torch.cuda.empty_cache()

    # the learning check: one fixed batch, the substrate test's schedule
    state = init_train_state(cfg, ex, SEED)
    step = make_train_step(cfg, ex, **LEARN_LR)
    batch = pipe.batch_at(0)
    metrics = []
    for _ in range(LEARN_STEPS):
        state, m = step(state, batch)
        metrics.append(m)
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log("train", {"model": cfg.name, "card": card_line(),
                  "check": "learns a fixed batch", **LEARN_LR,
                  "losses": losses, "grad_norms": norms,
                  "mean_first_3": first, "mean_last_3": last,
                  "margin": LEARN_MARGIN})
    check(all(math.isfinite(v) for v in losses + norms),
          f"train {cfg.name}: finite losses and grad norms on a fixed batch")
    check(last < first - LEARN_MARGIN, f"train {cfg.name}: the loss fell "
          f"by more than {LEARN_MARGIN} ({first} -> {last})")
    del state, step, metrics, batch
    torch.cuda.empty_cache()
    _train_check(arch, check_depth, check_seq)
    log("train", f"{cfg.name}: phase wall {time.perf_counter() - t_phase:.1f}"
        " s")
    return launches, remat_launches


# ---------------------------------------------------------------------------
# 9. validate: the fidelity harness, the wavefront against the scalar
# engine, timeline and --trace
# ---------------------------------------------------------------------------
VALIDATE_OUT = ROOT / "build" / "fidelity_h100.json"
VALIDATE_CPU_OUT = ROOT / "build" / "fidelity_cpu.json"
VALIDATE_SCHEDULES = ("gpipe", "1f1b", "interleaved")
# the card's wavefront against the scalar engine, gpipe and 1f1b: the
# bound of the reference's test_batch_replay_matches_scalar; interleaved
# is printed, not gated (ROADMAP C8)
WAVEFRONT_ENGINE_RTOL = 0.05
PIPELINED_TOP = 8        # records a scenario (obs/bench.pipelined_records)
TIMELINE_OUT = ROOT / "build" / "timeline_h100.json"
STUDY_TRACE_OUT = ROOT / "build" / "trace_study.json"
STUDY_STAGE_SPANS = ("study.run", "study.scan", "study.event_rerank",
                     "study.refine", "study.validate_top")


def _wavefront_vs_engine(scenarios):
    """Each scenario's pipelined records compiled by ``compile_batch`` and
    replayed on the card's wavefront, each row held against the scalar
    engine's replay of ``compile_step``'s program -> worst relative gap
    by schedule."""
    from repro_torch.api import Scenario, Study
    from repro_torch.events import compile_batch, compile_step, replay
    from repro_torch.obs.bench import pipelined_records
    worst = {sched: 0.0 for sched in VALIDATE_SCHEDULES}
    rows = 0
    for path in scenarios:
        sc = Scenario.load(path)
        res = Study(sc).run(device="cuda")
        w, hw, recs = pipelined_records(sc, res, PIPELINED_TOP)
        check(len(recs) > 0, f"validate {sc.name}: pipelined records")
        for sched in VALIDATE_SCHEDULES:
            cb = compile_batch(w, [r[0] for r in recs], [r[1] for r in recs],
                               fabric=[r[3] for r in recs],
                               topos=[r[2] for r in recs], reuse=sc.reuse,
                               hw=hw, schedule=sched, device="cuda")
            out = cb.replay(device="cuda")
            gaps = []
            for j, (s, mcm, topo, fabric) in enumerate(recs):
                if not cb.feasible[j]:
                    continue
                ev = replay(compile_step(w, s, mcm, fabric=fabric, topo=topo,
                                         reuse=sc.reuse, hw=hw,
                                         schedule=sched))
                gaps.append(abs(float(out["step_time"][j]) - ev.step_time)
                            / ev.step_time)
            check(len(gaps) > 0 and all(math.isfinite(g) for g in gaps),
                  f"validate {sc.name} {sched}: finite replays")
            rows += len(gaps)
            worst[sched] = max(worst[sched], max(gaps))
            if sched != "interleaved":
                check(max(gaps) <= WAVEFRONT_ENGINE_RTOL,
                      f"validate {sc.name} {sched}: the card's wavefront "
                      f"{max(gaps):.4f} relative from the scalar engine "
                      f"(tol {WAVEFRONT_ENGINE_RTOL})")
        log("validate", {"scenario": sc.name, "pipelined_records": [
            [r[0].pp, r[0].n_micro] for r in recs]})
    return worst, rows


def _report_rows(report) -> dict:
    return {b["scenario"]: (b["scenario_hash"], b["n_points"], b["rows"])
            for b in report["scenarios"]}


def phase_validate():
    """``cli validate`` over the committed scenarios on the CPU and on the
    card (identical rows, no violation); the card's wavefront against the
    scalar engine on each scenario's pipelined records; ``timeline`` and a
    study with ``--trace`` on the card, their traces checked.  Returns the
    launches of the card's runs (every count set to 0 just before)."""
    from repro_torch import cli
    from repro_torch.obs import track_idle, validate_chrome_trace
    t_phase = time.perf_counter()
    scenarios = sorted(str(p) for p in (ROOT / "scenarios").glob("*.json"))
    check(len(scenarios) == 9, f"validate: {len(scenarios)} committed "
          f"scenarios, expected 9")
    args = ["validate", *scenarios, "--top", "4", "--schedules",
            ",".join(VALIDATE_SCHEDULES)]
    t0 = time.perf_counter()
    rc = cli.main(args + ["--device", "cpu", "--out", str(VALIDATE_CPU_OUT)])
    cpu_s = time.perf_counter() - t0
    check(rc == 0, f"validate on the CPU exited {rc}")
    mods = _kernel_modules()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args + ["--device", "cuda", "--out", str(VALIDATE_OUT)])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(rc == 0, f"validate on the card exited {rc}")
    card = json.loads(VALIDATE_OUT.read_text())
    cpu = json.loads(VALIDATE_CPU_OUT.read_text())
    check(card["device"] == "cuda" and cpu["device"] == "cpu",
          "validate: the reports name their devices")
    check(card["n_violations"] == 0 and cpu["n_violations"] == 0,
          f"validate: {card['n_violations']} violations on the card, "
          f"{cpu['n_violations']} on the CPU")
    check(card["n_rows"] == cpu["n_rows"] > 0
          and _report_rows(card) == _report_rows(cpu),
          "validate: the card's report has the CPU's rows")
    t0 = time.perf_counter()
    worst, n_rows = _wavefront_vs_engine(scenarios)
    wavefront_s = time.perf_counter() - t0

    # timeline (the study on the card, the simulated step's trace) and a
    # study with --trace (the host trace of its stages)
    rc = cli.main(["timeline", str(ROOT / "scenarios" /
                                   "tinyllama_quick.json"), "--schedule",
                   "interleaved", "--device", "cuda", "--out",
                   str(TIMELINE_OUT)])
    check(rc == 0, f"timeline exited {rc}")
    timeline = json.loads(TIMELINE_OUT.read_text())
    tl_counts = validate_chrome_trace(timeline)
    idle = track_idle(timeline)
    busy_us = sum(v["busy_us"] for v in idle.values())
    idle_us = sum(v["idle_us"] for v in idle.values())
    check(len(idle) > 1 and busy_us > 0, "timeline: busy device tracks")
    rc = cli.main([str(ROOT / "scenarios" / "tinyllama_quick.json"),
                   "--device", "cuda", "--schedule", "search",
                   "--validate-top", "2", "--out",
                   str(ROOT / "build" / "study_traced.json"),
                   "--trace", str(STUDY_TRACE_OUT)])
    torch.cuda.synchronize()
    check(rc == 0, f"study with --trace exited {rc}")
    trace = json.loads(STUDY_TRACE_OUT.read_text())
    trace_counts = validate_chrome_trace(trace)
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    missing = [n for n in STUDY_STAGE_SPANS if n not in spans]
    check(not missing, f"study trace: no {missing} span")
    launches = {name: m.launches for name, m in mods.items()}
    check(launches["wavefront"] > 0, "validate: the wavefront launched on "
          "the card")
    check(all(n == 0 for name, n in launches.items() if name != "wavefront"),
          "validate: no serving kernel launched on the validate path")
    log("validate", {
        "card": card_line(), "scenarios": card["n_scenarios"],
        "rows": card["n_rows"], "asserted": card["n_asserted"],
        "violations": card["n_violations"],
        "max_abs_err_asserted": card["max_abs_err_asserted"],
        "card_vs_cpu_rows": "identical",
        "wall_s_card": card_s, "wall_s_cpu": cpu_s,
        "wavefront_vs_engine_worst_rel_gap": worst,
        "wavefront_vs_engine_rows": n_rows,
        "wavefront_vs_engine_wall_s": wavefront_s,
        "timeline": {"events": tl_counts, "device_tracks": len(idle),
                     "busy_ms": busy_us / 1e3, "idle_ms": idle_us / 1e3,
                     "idle_share": idle_us / (busy_us + idle_us)},
        "study_trace": {"events": trace_counts,
                        "stage_spans": sorted(n for n in spans
                                              if n.startswith("study."))},
        "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# 10. resume: the trainer's runtime on the card
# ---------------------------------------------------------------------------
RESUME_ARCH, RESUME_DEPTH, RESUME_SEQ = "tinyllama-1.1b", 4, 1024
RESUME_STEPS, RESUME_EVERY, RESUME_AT = 8, 4, 4
RESUME_LOSS_RTOL = 1e-6     # only if the card's step is not deterministic
TRAIN_SEQ_SHARD = 1024
PREEMPT_AT = 2
CKPT_DIR = ROOT / "build" / "ckpt_smoke"


def _state_tensors(state) -> dict:
    out = {f"param/{n}": p.detach() for n, p in
           state.model.named_parameters()}
    out.update({f"m/{n}": t for n, t in state.opt.m.items()})
    out.update({f"v/{n}": t for n, t in state.opt.v.items()})
    return out


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def phase_resume():
    """TinyLlama-1.1B at full width, RESUME_DEPTH of 22 layers, batch 8 x
    1024, float32 master weights and bf16 compute, through
    ``launch.train``'s pieces: 8 steps straight with a checkpoint every 4
    (keep 2); step 8's COMMITTED marker removed, as by a crash mid-write;
    a fresh state from another seed resumed at step 4 and run to 8 (the
    restored state, the pipeline's state and the losses against the
    straight run's); then SIGTERM at step 2 of a third run.  Returns the
    straight run's launches (counts set to 0 just before)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import train_exec_config
    from repro_torch.runtime import FaultTolerantLoop

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg = dataclasses.replace(get_config(RESUME_ARCH), n_layers=RESUME_DEPTH)
    ex = train_exec_config(cfg, torch.device("cuda"))
    shape = ShapeConfig("train", "train", RESUME_SEQ, TRAIN_BATCH)
    step_fn = make_train_step(cfg, ex)

    # 1. eight steps straight, a checkpoint every four
    state = init_train_state(cfg, ex, SEED)
    n_params = sum(p.numel() for p in state.model.parameters())
    mgr = CheckpointManager(CKPT_DIR, keep=2)
    current = {}

    def tracked_step(state, batch):
        state, metrics = step_fn(state, batch)
        current["state"] = state
        return state, metrics

    loop = FaultTolerantLoop(tracked_step, mgr,
                             DataPipeline(cfg, shape, SEED, ex=ex),
                             checkpoint_every=RESUME_EVERY)
    losses, in_flight, saved, writes = {}, {}, {}, []

    def on_metrics(step, metrics, dt):
        losses[step] = metrics["loss"].item()
        th = mgr._thread
        # the write of the last checkpoint outlasted this whole step
        in_flight[step] = th is not None and th.is_alive()
        if step == RESUME_AT:       # what the loop saves next
            now = current["state"]
            saved.update({k: t.clone() for k, t in
                          _state_tensors(now).items()})
            saved["step"] = now.opt.step
        elif step == RESUME_AT + 1:
            writes.append(mgr.last_save)   # step 4's; timed once written

    mods = _kernel_modules()
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    state, last = loop.run(state, RESUME_STEPS, on_metrics=on_metrics)
    launches = {name: m.launches for name, m in mods.items()}
    expected = {k: RESUME_STEPS * n for k, n in
                expected_train_launches(cfg, RESUME_SEQ).items()}
    check(last == RESUME_STEPS and mgr.all_steps() == [4, 8],
          f"resume: the straight run ended at {last} with checkpoints "
          f"{mgr.all_steps()}")
    check(launches == expected, f"resume: launches {launches}, expected "
          f"{expected}")
    check(all(math.isfinite(v) for v in losses.values()),
          "resume: finite losses")
    writes.append(mgr.last_save)
    times = dict(zip(range(1, RESUME_STEPS + 1), loop.step_times))
    # step 1 builds the allocator's pools: not counted
    quiet = [times[k] for k in range(2, RESUME_STEPS + 1) if not in_flight[k]]
    busy = [times[k] for k in range(2, RESUME_STEPS + 1) if in_flight[k]]
    straggler_steps = list(loop.straggler_steps)
    del state, loop
    torch.cuda.empty_cache()

    # 2. a crash before step 8's checkpoint committed: resume at 4
    (CKPT_DIR / "step_00000008" / "COMMITTED").unlink()
    pipe = DataPipeline(cfg, shape, SEED + 1, ex=ex)
    loop = FaultTolerantLoop(step_fn, CheckpointManager(CKPT_DIR, keep=2),
                             pipe, checkpoint_every=RESUME_EVERY)
    fresh = init_train_state(cfg, ex, SEED + 1)
    t0 = time.perf_counter()
    restored, start = loop.resume_or_init(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(start == RESUME_AT and restored.model is fresh.model,
          f"resume: resumed at {start} into the live module")
    check(pipe.checkpoint() == {"seed": SEED, "step": RESUME_AT},
          f"resume: the pipeline's state {pipe.checkpoint()}")
    check(restored.opt.step == saved["step"] == RESUME_AT,
          f"resume: AdamW step {restored.opt.step}")
    got = _state_tensors(restored)
    bad = [k for k in got if not _bitwise_equal(got[k], saved[k])]
    check(not bad, f"resume: {len(bad)} restored tensors differ from the "
          f"saved ones bit for bit, first {bad[:3]}")
    del saved
    resumed = {}
    restored, last = loop.run(
        restored, RESUME_STEPS, start_step=start,
        on_metrics=lambda step, m, dt: resumed.__setitem__(
            step, m["loss"].item()))
    check(last == RESUME_STEPS, f"resume: the resumed run ended at {last}")
    pairs = [(losses[k], resumed[k]) for k in range(RESUME_AT + 1,
                                                    RESUME_STEPS + 1)]
    bitwise = all(a == b for a, b in pairs)
    gap = max(abs(a - b) / abs(a) for a, b in pairs)
    check(bitwise or gap < RESUME_LOSS_RTOL, f"resume: the resumed losses "
          f"{[b for _, b in pairs]} vs the straight run's "
          f"{[a for a, _ in pairs]} (relative gap {gap})")
    del restored, fresh, loop
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    # 3. preemption: SIGTERM at step 2 finishes the step, checkpoints it
    mgr = CheckpointManager(CKPT_DIR / "preempt", keep=1)
    loop = FaultTolerantLoop(step_fn, mgr, DataPipeline(cfg, shape, SEED,
                                                        ex=ex),
                             checkpoint_every=RESUME_EVERY)

    def preempt(step, metrics, dt):
        if step == PREEMPT_AT:
            handler = signal.getsignal(signal.SIGTERM)
            check(handler not in (signal.SIG_DFL, signal.SIG_IGN, None),
                  "resume: the loop handles SIGTERM")
            os.kill(os.getpid(), signal.SIGTERM)

    state = init_train_state(cfg, ex, SEED)
    state, last = loop.run(state, RESUME_STEPS, on_metrics=preempt)
    committed = (CKPT_DIR / "preempt" / f"step_{PREEMPT_AT:08d}" /
                 "COMMITTED").exists()
    check(loop.preempted and last == PREEMPT_AT and committed
          and mgr.all_steps() == [PREEMPT_AT],
          f"resume: SIGTERM at step {PREEMPT_AT} ended the run at {last}, "
          f"checkpoints {mgr.all_steps()}")
    del state, loop
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log("resume", {
        "card": card_line(), "model": cfg.name, "layers": cfg.n_layers,
        "full_depth": get_config(RESUME_ARCH).n_layers,
        "params_b": n_params / 1e9, "batch": TRAIN_BATCH,
        "seq": RESUME_SEQ, "checkpoint_gb": writes[0]["bytes"] / 1e9,
        "step_ms_no_write_in_flight": [t * 1e3 for t in quiet],
        "step_ms_write_in_flight": [t * 1e3 for t in busy],
        "step_ms_mean_no_write": sum(quiet) / len(quiet) * 1e3
        if quiet else None,
        "step_ms_mean_write_in_flight": sum(busy) / len(busy) * 1e3
        if busy else None,
        "writes": [{"step": w["step"], "gb": w["bytes"] / 1e9,
                    "host_copy_s": w["copy_s"], "write_s": w["write_s"],
                    "write_gb_per_s": w["bytes"] / 1e9 / w["write_s"]}
                   for w in writes],
        "restore_s": restore_s,
        "restore_gb_per_s": writes[0]["bytes"] / 1e9 / restore_s,
        "losses": [losses[k] for k in sorted(losses)],
        "resumed_losses": [resumed[k] for k in sorted(resumed)],
        "resumed_bit_for_bit": bitwise, "resumed_max_rel_gap": gap,
        "straggler_steps": straggler_steps,
        "preempted_at": last, "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# 11. shard: the sharded trainer on a one-rank NCCL mesh
# ---------------------------------------------------------------------------
SHARD_ARCH, SHARD_STEPS = "tinyllama-1.1b", 3
# TinyLlama's steps under remat "full", sharded and not, bit for bit
SHARD_REMAT_STEPS = 2
SHARD_MOE_ARCH, SHARD_MOE_DEPTH = "mixtral-8x7b", 1
# the a2a layer against the dense one: the same function at one model
# rank, so any difference is a sum order; the gmm inside the a2a against
# its plain version at bf16's GMM_TOL
SHARD_MOE_RTOL = 1e-2


def _one_rank_mesh(store_path: str):
    """A one-rank NCCL group on a file store at ``store_path`` (no port)
    and its (1, 1) ("data", "model") mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    store = dist.FileStore(store_path, 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def _timed_steps(step, state, batches):
    """-> (state, the losses, each step's ms on the card's clock)."""
    losses, ms = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(m["loss"].item())
    return state, losses, ms


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """-> (bit for bit, max |a - b|, that over max |b|)."""
    d = (a.float() - b.float()).abs().max().item()
    return _bitwise_equal(a, b) if a.dtype == torch.float32 else \
        torch.equal(a, b), d, d / max(b.float().abs().max().item(), 1e-30)


def _shard_dense(mesh, mods, remat="none", steps=SHARD_STEPS):
    """TinyLlama at full width and depth under ``remat``: ``steps`` steps
    through ``make_train_step`` and through ``build_sharded_train`` from
    the same init and batches -> (the sharded steps' launches, the
    record).  Under remat the two must agree bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import build_sharded_train, train_exec_config

    cfg = get_config(SHARD_ARCH)
    ex = dataclasses.replace(train_exec_config(cfg, torch.device("cuda")),
                             remat=remat)
    shape = ShapeConfig("train", "train", TRAIN_SEQ_SHARD, TRAIN_BATCH)
    pipe = DataPipeline(cfg, shape, SEED, ex=ex)
    batches = [pipe.batch_at(i) for i in range(steps)]

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, ex, SEED)
    state, plain_losses, plain_ms = _timed_steps(make_train_step(cfg, ex),
                                                 state, batches)
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    plain = {n: p.detach() for n, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()

    step, place = build_sharded_train(cfg, ex, mesh, shape)
    torch.cuda.reset_peak_memory_stats()
    state = place(init_train_state(cfg, ex, SEED))
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    state, losses, ms = _timed_steps(step, state, batches)
    launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    one = (expected_train_launches if remat == "none"
           else expected_remat_launches)(cfg, TRAIN_SEQ_SHARD)
    expected = {k: steps * n for k, n in one.items()}
    check(launches == expected, f"shard {cfg.name} remat {remat}: launches "
          f"{launches}, expected {expected}")
    diffs = {n: _max_diff(p.detach().to_local(), plain[n])
             for n, p in state.model.named_parameters()}
    worst = max(diffs, key=lambda n: diffs[n][2])
    bitwise = all(d[0] for d in diffs.values()) and losses == plain_losses
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    check(all(math.isfinite(v) for v in losses), f"shard {cfg.name}: finite "
          f"losses {losses}")
    check(bitwise or (remat == "none" and loss_gap < 1e-6
                      and diffs[worst][2] < 1e-6),
          f"shard {cfg.name} remat {remat}: sharded vs make_train_step: "
          f"losses {losses} vs {plain_losses}, worst parameter {worst} "
          f"{diffs[worst]}")
    n_params = sum(p.numel() for p in plain.values())
    del state, plain
    torch.cuda.empty_cache()
    return launches, {
        "model": cfg.name, "layers": cfg.n_layers, "params_b": n_params / 1e9,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ_SHARD, "steps": steps,
        "remat": remat,
        "bit_for_bit": bitwise, "losses": losses,
        "make_train_step_losses": plain_losses, "max_loss_rel_gap": loss_gap,
        "worst_param": worst, "worst_param_max_abs_diff": diffs[worst][1],
        "worst_param_rel_diff": diffs[worst][2],
        "step_ms": ms, "make_train_step_ms": plain_ms,
        "step_ms_after_first": sum(ms[1:]) / len(ms[1:]),
        "make_train_step_ms_after_first": sum(plain_ms[1:]) / len(
            plain_ms[1:]),
        "peak_mem_gb": peak, "make_train_step_peak_mem_gb": plain_peak,
        "launches": launches}


def _grad_norms(state) -> torch.Tensor:
    """Each parameter's gradient norm (a one-rank mesh's local shard is
    the whole tensor), on the host."""
    with torch.no_grad():
        return torch.stack([p.grad.to_local().float().norm()
                            for p in state.model.parameters()]).cpu()


def _moe_layer_grads(fn, moe, h, g):
    """``fn(moe, h) -> (y, aux)``, then the gradients of sum(y g) + aux ->
    (y, aux, {name: gradient}, ms of forward + backward)."""
    h = h.detach().requires_grad_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y, aux = fn(moe, h)
    wrt = {"x": h, "router": moe.router.weight, "w1": moe.w1, "w3": moe.w3,
           "w2": moe.w2}
    grads = torch.autograd.grad((y.float() * g).sum() + aux,
                                list(wrt.values()))
    end.record()
    torch.cuda.synchronize()
    return y.detach(), aux.detach(), dict(zip(wrt, grads)), \
        start.elapsed_time(end)


def _shard_moe(mesh, mods):
    """Mixtral-8x7B at full width, SHARD_MOE_DEPTH layer, experts over the
    all-to-all: a warm-up step and a counted one through
    ``build_sharded_train``; then the MoE layer at the step's shape, the
    a2a against the dense ``moe_apply`` (y, aux, every gradient) and the
    a2a's gmm against its plain version -> (the counted step's launches,
    the record)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.launch.train import build_sharded_train, train_exec_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.moe_a2a import moe_apply_a2a

    cfg = dataclasses.replace(get_config(SHARD_MOE_ARCH),
                              n_layers=SHARD_MOE_DEPTH)
    m = cfg.moe
    ex = dataclasses.replace(train_exec_config(cfg, torch.device("cuda")),
                             moe_impl="a2a")
    shape = ShapeConfig("train", "train", TRAIN_SEQ_SHARD, TRAIN_BATCH)
    pipe = DataPipeline(cfg, shape, SEED, ex=ex)
    step, place = build_sharded_train(cfg, ex, mesh, shape)
    torch.cuda.reset_peak_memory_stats()
    state = place(init_train_state(cfg, ex, SEED))
    n_params = sum(p.numel() for p in state.model.parameters())
    state, warm_losses, warm_ms = _timed_steps(step, state,
                                               [pipe.batch_at(0)])
    warm_norms = _grad_norms(state)
    for mod in mods.values():
        mod.launches = 0
    state, losses, ms = _timed_steps(step, state, [pipe.batch_at(1)])
    launches = {name: mod.launches for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_train_launches(cfg, TRAIN_SEQ_SHARD)
    check(launches == expected, f"shard {cfg.name} a2a: launches {launches}, "
          f"expected {expected}")
    check(all(math.isfinite(v) for v in warm_losses + losses),
          f"shard {cfg.name} a2a: finite losses")
    del state, step
    torch.cuda.empty_cache()

    # the first step again under remat "full": the backward recomputes
    # the layer, the gmm's forward and the all-to-alls among it
    ex_full = dataclasses.replace(ex, remat="full")
    step, place = build_sharded_train(cfg, ex_full, mesh, shape)
    state = place(init_train_state(cfg, ex_full, SEED))
    torch.cuda.synchronize()
    for mod in mods.values():
        mod.launches = 0
    state, full_losses, full_ms = _timed_steps(step, state,
                                               [pipe.batch_at(0)])
    full_launches = {name: mod.launches for name, mod in mods.items()}
    full_norms = _grad_norms(state)
    del state, step
    torch.cuda.empty_cache()
    expected = expected_remat_launches(cfg, TRAIN_SEQ_SHARD)
    check(full_launches == expected, f"shard {cfg.name} a2a remat full: "
          f"launches {full_launches}, expected {expected}")
    loss_gap = abs(full_losses[0] - warm_losses[0]) / abs(warm_losses[0])
    norm_gap = ((full_norms - warm_norms).abs()
                / warm_norms.clamp_min(1e-30)).max().item()
    check(loss_gap <= REMAT_RTOL and norm_gap <= REMAT_RTOL,
          f"shard {cfg.name} a2a: remat full vs none: loss "
          f"{full_losses[0]} vs {warm_losses[0]}, gradient norms {norm_gap} "
          f"apart (tol {REMAT_RTOL})")
    full = {"loss": full_losses[0], "step_ms": full_ms[0],
            "loss_rel_gap": loss_gap, "max_grad_norm_rel_gap": norm_gap,
            "bit_for_bit": full_losses[0] == warm_losses[0]
            and torch.equal(full_norms, warm_norms),
            "launches": full_launches}
    for k in mods:
        launches[k] += full_launches[k]

    # the layer: one model rank holds every expert; the a2a's capacity is
    # the dense one's, and both run the bf16 wgmma kernel at block_t 128
    t = TRAIN_BATCH * TRAIN_SEQ_SHARD
    cap_send = max(8, -(-int(t * m.top_k * m.capacity_factor) // 8) * 8)
    cap_exp = max(8, -(-cap_send // m.n_experts // 8) * 8)
    cap = moe_mod.capacity(t, m)
    bt = moe_mod.block_t_for(cap)
    check(cap_exp == cap and bt == 128 and
          gmm_mod.kernel_for(torch.bfloat16, bt) == "wgmma",
          f"shard: cap_exp {cap_exp}, capacity {cap}, block_t {bt}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layer = moe_mod.MoE(cfg.d_model, m, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, p.shape[-2] ** -0.5 if p.dim() == 3
                      else p.shape[-1] ** -0.5, generator=gen)
    h = torch.randn((TRAIN_BATCH, TRAIN_SEQ_SHARD, cfg.d_model),
                    generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(h.shape, generator=gen, device="cuda")
    dense = _moe_layer_grads(
        lambda mo, x: moe_mod.moe_apply(mo, x, m, with_aux=True),
        layer, h, g)
    for mod in mods.values():
        mod.launches = 0
    a2a = _moe_layer_grads(
        lambda mo, x: moe_apply_a2a(mo, x, m, ex, mesh), layer, h, g)
    layer_gmm = mods["moe_gmm"].launches
    check(layer_gmm == 6, f"shard: the a2a layer's gmm launches {layer_gmm}"
          f" (3 forward, 3 dx)")
    cmp = {"y": _max_diff(a2a[0], dense[0]),
           "aux": _max_diff(a2a[1], dense[1]),
           **{f"d{k}": _max_diff(a2a[2][k], dense[2][k]) for k in dense[2]}}
    bad = {k: v for k, v in cmp.items() if v[2] > SHARD_MOE_RTOL}
    check(not bad, f"shard: the a2a layer vs the dense one: {bad}")
    plain_gmm = ops.moe_gmm
    try:
        ops.moe_gmm = lambda x, w, ids, *, block_t: \
            gmm_mod.moe_gmm_plain(x, w, ids, block_t)
        with torch.no_grad():
            y_plain, _ = moe_apply_a2a(layer, h, m, ex, mesh)
    finally:
        ops.moe_gmm = plain_gmm
    vs_plain = _max_diff(a2a[0], y_plain)
    check(vs_plain[2] <= GMM_TOL[torch.bfloat16], f"shard: the a2a layer's "
          f"gmm vs its plain version {vs_plain}")
    layer_ms = {"a2a_fwd_bwd_ms": a2a[3], "dense_fwd_bwd_ms": dense[3]}
    del layer, dense, a2a, y_plain
    torch.cuda.empty_cache()
    return launches, {
        "model": cfg.name, "layers": cfg.n_layers,
        "full_depth": get_config(SHARD_MOE_ARCH).n_layers,
        "params_b": n_params / 1e9, "moe_impl": "a2a", "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ_SHARD, "warmup_step_ms": warm_ms,
        "step_ms": ms[0], "losses": warm_losses + losses,
        "peak_mem_gb": peak, "launches": launches, "remat_full": full,
        "layer": {"cap_exp": cap_exp, "capacity": cap, "block_t": bt,
                  "gmm_launches": layer_gmm, **layer_ms, "vs_dense": {
                      k: {"bit_for_bit": v[0], "max_abs_diff": v[1],
                          "rel_diff": v[2]} for k, v in cmp.items()},
                  "y_vs_plain_gmm": {"max_abs_diff": vs_plain[1],
                                     "rel_diff": vs_plain[2]}}}


def phase_shard():
    """The sharded trainer (``launch.train.build_sharded_train``) on a
    one-rank NCCL (1, 1) mesh: TinyLlama-1.1B at full width and depth
    against ``make_train_step`` from the same init and batches, and
    Mixtral-8x7B at full width, one layer, experts over the all-to-all
    with the hand gmm kernel.  Returns the sharded steps' launches (every
    count set to 0 just before each, read just after)."""
    import tempfile

    import torch.distributed as dist
    t_phase = time.perf_counter()
    mods = _kernel_modules()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = _one_rank_mesh(os.path.join(tmp, "store"))
        try:
            dense_launches, dense = _shard_dense(mesh, mods)
            remat_launches, remat = _shard_dense(mesh, mods, "full",
                                                 SHARD_REMAT_STEPS)
            moe_launches, moe = _shard_moe(mesh, mods)
            world = dist.get_world_size()
        finally:
            dist.destroy_process_group()
    launches = {k: dense_launches[k] + remat_launches[k] + moe_launches[k]
                for k in mods}
    log("shard", {"card": card_line(), "world_size": world,
                  "mesh": {"data": 1, "model": 1}, "backend": "nccl",
                  "dense": dense, "dense_remat_full": remat, "moe": moe,
                  "launches": launches,
                  "phase_wall_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# 12. dryrun: the production dry run over fake tensors
# ---------------------------------------------------------------------------
DRYRUN_ARCH, DRYRUN_SHAPE, DRYRUN_MESH = "tinyllama_1_1b", "train_4k", \
    "single"
DRYRUN_TIMEOUT_S = 120
DRYRUN_RTOL = 1e-9
# the cell without remat (PR 32's records): "full" recomputes each
# layer's forward, so its FLOPs rise past these and its peak falls under
DRYRUN_NONE_FLOPS = 5.51916182437888e14
DRYRUN_NONE_PEAK = 168166088716
# Qwen3-MoE-235B-A22B train_4k on the two-pod (2, 16, 16) mesh, over the
# all-to-all, on fake CUDA tensors alone: its experts' gradients
# reduce-scatter over (pod, data) as the spec sums have it, and its
# all-reduce stays within twice the single-pod cell's (202350249.8 B
# without remat; 53423889441.9 on two pods before the flattened view)
DRYRUN_MOE_ARCH, DRYRUN_MOE_MESH = "qwen3_moe_235b_a22b", "multi"
DRYRUN_MOE_TIMEOUT_S = 600
DRYRUN_MOE_SINGLE_ALL_REDUCE = 202350249.8
# the keys of the reference's record (repro/launch/dryrun.py:274-300)
DRYRUN_KEYS = (
    "arch", "shape", "mesh", "kind", "n_chips", "seq_len", "global_batch",
    "hlo_flops_per_device", "hlo_bytes_per_device",
    "coll_wire_bytes_per_device", "raw_flops_per_device",
    "raw_bytes_per_device", "raw_wire_bytes_per_device", "depth_points",
    "coll_result_bytes_per_device", "coll_breakdown", "coll_counts",
    "mem_argument_bytes", "mem_output_bytes", "mem_temp_bytes",
    "mem_generated_code_bytes", "model_flops_step", "params",
    "active_params", "lower_s", "compile_s")
# what the record on fake CUDA tensors must share with the one on fake
# CPU tensors: every FLOP, byte and count
DRYRUN_SAME = (
    "n_chips", "mesh_shape", "hlo_flops_per_device", "hlo_bytes_per_device",
    "coll_wire_bytes_per_device", "coll_result_bytes_per_device",
    "coll_breakdown", "coll_counts", "spec_wire_bytes",
    "torch_flops_per_device", "kernel_flops_per_device",
    "kernel_bytes_per_device", "kernel_calls", "launches", "moe_impl",
    "remat", "mem_argument_bytes", "mem_output_bytes", "mem_temp_bytes",
    "mem_peak_bytes", "mem_peak_by_op", "mem_peak_top", "model_flops_step",
    "params", "active_params")


class DryRuns:
    """The dry run's cells, each a subprocess, all started at once
    (``start``) while the train phase keeps the card busy (they need the
    host only), collected by ``phase_dryrun`` and stopped, whatever
    happens, by ``stop``: TinyLlama's on fake CUDA and on fake CPU
    tensors, Qwen3-MoE's two-pod cell on fake CUDA tensors."""

    # name: (arch, mesh, fake tensors' device, seconds from the start,
    # niceness: the two-pod cell has ten minutes and yields the host's
    # cores to the train phase's CPU checks)
    CELLS = {"cuda": (DRYRUN_ARCH, DRYRUN_MESH, "cuda", DRYRUN_TIMEOUT_S, 0),
             "cpu": (DRYRUN_ARCH, DRYRUN_MESH, "cpu", DRYRUN_TIMEOUT_S, 0),
             "moe_multi": (DRYRUN_MOE_ARCH, DRYRUN_MOE_MESH, "cuda",
                           DRYRUN_MOE_TIMEOUT_S, 19)}

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.procs, self.t0 = {}, None

    def start(self) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
        self.t0 = time.perf_counter()
        for name, (arch, mesh, dev, _, nice) in self.CELLS.items():
            with open(os.path.join(self.dir, f"{name}.out"), "w") as out:
                self.procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", DRYRUN_SHAPE,
                     "--mesh", mesh, "--device", dev, "--force",
                     "--out", os.path.join(self.dir, name)],
                    stdout=out, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                    preexec_fn=(lambda n=nice: os.nice(n)) if nice else None)

    def wait(self) -> dict:
        """-> {cell: (exit code, output, its record's path)}: each
        subprocess may run its CELLS timeout from its start."""
        done = {}
        for name, p in self.procs.items():
            arch, mesh, _, timeout, _ = self.CELLS[name]
            left = timeout - (time.perf_counter() - self.t0)
            try:
                p.wait(timeout=max(left, 0.01))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"dryrun {name}: no exit within "
                                   f"{timeout} s of its start")
            out = pathlib.Path(self.dir, f"{name}.out").read_text()
            done[name] = (p.returncode, out, pathlib.Path(
                self.dir, name, f"{arch}__{DRYRUN_SHAPE}__{mesh}.json"))
        return done

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def phase_dryrun(runs: DryRuns):
    """``launch.dryrun``'s cells (``runs``, started before the train
    phase), each under its default remat "full": TinyLlama's train cell on
    the fake 256-rank group over fake CUDA and fake CPU tensors (wire
    bytes against ``param_specs``, each layer's kernels twice, FLOPs above
    and peak below the cell without remat, the two records alike) and
    Qwen3-MoE's on the fake 512-rank two-pod group (reduce-scatter against
    ``param_specs``, all-reduce within twice the single pod's); no
    launch.  Returns the dry runs' launches (all 0)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import spec_wire_bytes
    t_phase = time.perf_counter()
    log("dryrun", f"waiting for the cells {list(runs.procs)}")
    recs = {}
    for name, (rc, out, path) in runs.wait().items():
        tail = "\n".join(out.strip().splitlines()[-5:])
        check(rc == 0, f"dryrun {name}: exit code {rc}: {tail}")
        recs[name] = json.loads(path.read_text())
        log("dryrun", {"cell": name, "record": recs[name]})
    # each record counts its own process's launches by kernel module
    launches = {
        name: sum(r["launches"].get(m.__name__.rsplit(".", 1)[1], 0)
                  for r in recs.values())
        for name, m in _kernel_modules().items()}
    for name, rec in recs.items():
        missing = [k for k in DRYRUN_KEYS if k not in rec]
        check(not missing and not rec.get("skipped"),
              f"dryrun {name}: skipped or missing keys {missing}")
        check(not any(rec["launches"].values()),
              f"dryrun {name}: kernels launched {rec['launches']}")
        check(rec["remat"] == "full", f"dryrun {name}: remat {rec['remat']}")
        check(all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
            "hlo_flops_per_device", "hlo_bytes_per_device",
            "mem_argument_bytes", "mem_temp_bytes")),
              f"dryrun {name}: positive finite flops, bytes and memory")
    cfg = get_config(DRYRUN_ARCH)
    want = spec_wire_bytes(cfg, SHAPES[DRYRUN_SHAPE],
                           {"data": 16, "model": 16})
    # under remat each layer's flash and norms (ln1, ln2) run again
    calls = {"flash_attention_fwd": 2 * cfg.n_layers,
             "rmsnorm": 2 * 2 * cfg.n_layers + 1}
    for dev in ("cuda", "cpu"):
        rec = recs[dev]
        check(rec["n_chips"] == 256 and rec["device"] == dev,
              f"dryrun {dev}: {rec['n_chips']} chips on {rec['device']}")
        check(rec["kernel_calls"] == calls, f"dryrun {dev}: fake kernel "
              f"calls {rec['kernel_calls']}, expected {calls}")
        for kind in ("all-gather", "reduce-scatter"):
            got = rec["coll_breakdown"].get(kind, 0.0)
            check(abs(got - want[kind]) <= DRYRUN_RTOL * want[kind],
                  f"dryrun {dev}: {kind} wire bytes {got!r}, param_specs "
                  f"gives {want[kind]!r}")
        check(rec["hlo_flops_per_device"] > DRYRUN_NONE_FLOPS and
              rec["mem_peak_bytes"] < DRYRUN_NONE_PEAK,
              f"dryrun {dev}: remat full's FLOPs "
              f"{rec['hlo_flops_per_device']} (above {DRYRUN_NONE_FLOPS}) "
              f"and peak {rec['mem_peak_bytes']} (below {DRYRUN_NONE_PEAK})")
    differ = {k: (recs["cuda"][k], recs["cpu"][k]) for k in DRYRUN_SAME
              if recs["cuda"][k] != recs["cpu"][k]}
    check(not differ, f"dryrun: the CUDA and CPU records differ in {differ}")
    moe = recs["moe_multi"]
    moe_want = spec_wire_bytes(get_config(DRYRUN_MOE_ARCH),
                               SHAPES[DRYRUN_SHAPE],
                               {"pod": 2, "data": 16, "model": 16}, a2a=True)
    got = moe["coll_breakdown"].get("reduce-scatter", 0.0)
    check(moe["n_chips"] == 512 and moe["moe_impl"] == "a2a" and
          abs(got - moe_want["reduce-scatter"])
          <= DRYRUN_RTOL * moe_want["reduce-scatter"],
          f"dryrun moe_multi: {moe['n_chips']} chips, {moe['moe_impl']}, "
          f"reduce-scatter {got!r}, param_specs gives "
          f"{moe_want['reduce-scatter']!r}")
    all_reduce = moe["coll_breakdown"].get("all-reduce", 0.0)
    check(all_reduce <= 2 * DRYRUN_MOE_SINGLE_ALL_REDUCE,
          f"dryrun moe_multi: all-reduce {all_reduce} B, past twice the "
          f"single pod's {DRYRUN_MOE_SINGLE_ALL_REDUCE}")
    rec = recs["cuda"]
    log("dryrun", {
        "card": card_line(), "cell": f"{DRYRUN_ARCH} {DRYRUN_SHAPE} "
        f"{DRYRUN_MESH}", "remat": rec["remat"], "spec_wire_bytes": want,
        "wall_s": {n: r["wall_s"] for n, r in recs.items()},
        "trace_s": {n: r["compile_s"] for n, r in recs.items()},
        "flops_per_device": rec["hlo_flops_per_device"],
        "wire_bytes_per_device": rec["coll_wire_bytes_per_device"],
        "peak_bytes_per_device": rec["mem_peak_bytes"],
        "peak_by_op": rec["mem_peak_by_op"], "peak_top": rec["mem_peak_top"],
        "kernel_calls": rec["kernel_calls"],
        "roofline": rec["roofline"], "moe_multi": {
            "cell": f"{DRYRUN_MOE_ARCH} {DRYRUN_SHAPE} {DRYRUN_MOE_MESH}",
            "spec_wire_bytes": moe_want,
            "coll_breakdown": moe["coll_breakdown"],
            "flops_per_device": moe["hlo_flops_per_device"],
            "peak_bytes_per_device": moe["mem_peak_bytes"],
            "kernel_calls": moe["kernel_calls"]},
        "launches": launches, "wait_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# --ranks: the sharded trainer across the cards of one host, under
# ``torchrun --nproc-per-node N chip_smoke.py --ranks``
# ---------------------------------------------------------------------------
RANKS_STEPS = 3
RANKS_DENSE = "tinyllama-1.1b"
RANKS_MOE, RANKS_MOE_ORACLE_DEPTH, RANKS_MOE_DEPTH = "mixtral-8x7b", 1, 2
# bf16 products: each rank's weight gradient is rounded to bf16 over its
# own rows (2^-8 of a partial) before the ranks' float32 mean, one card's
# over all rows; the forward's products tile 2 rows a rank as 8 alike
RANKS_LOSS_RTOL = 1e-3
RANKS_GRAD_REL_L2 = 1e-2


def _ranks_steps(step, state, batches, device):
    """-> (state, losses, each step's ms: every rank's wall, from a
    barrier to its step's end on its device)."""
    import torch.distributed as dist
    losses, ms = [], []
    for b in batches:
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    return state, losses, ms


def _grads_full(state) -> dict:
    """Every parameter's gradient, gathered whole (a collective), on the
    host."""
    return {n: p.grad.full_tensor().float().cpu()
            for n, p in state.model.named_parameters()}


def _ranks_case(cfg, ex, shape, mesh_shape, device, oracle_accum=None):
    """``build_sharded_train`` on a ``mesh_shape`` mesh: step 1, its
    gradients gathered, steps 2..RANKS_STEPS; with ``oracle_accum``, rank
    0 then runs ``make_train_step`` (that accum) on one device from the
    same init and batches: the losses and step 1's gradients against it.
    -> this rank's record."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import build_sharded_train
    rank = dist.get_rank()
    cuda = device.type == "cuda"
    mesh = init_device_mesh(device.type, mesh_shape,
                            mesh_dim_names=("data", "model"))
    pipe = DataPipeline(cfg, shape, SEED, ex=ex)
    batches = [pipe.batch_at(i) for i in range(RANKS_STEPS)]
    step, place = build_sharded_train(cfg, ex, mesh, shape)
    mods = _kernel_modules()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = place(init_train_state(cfg, ex, SEED))
    params = dict(state.model.named_parameters())
    full_numel = sum(p.numel() for p in params.values())
    local_numel = sum(p.to_local().numel() for p in params.values())
    for m in mods.values():
        m.launches = 0
    state, losses, ms = _ranks_steps(step, state, batches[:1], device)
    grads = _grads_full(state)
    state, more, more_ms = _ranks_steps(step, state, batches[1:], device)
    launches = {n: m.launches for n, m in mods.items()}
    rec = {"mesh": list(mesh_shape), "losses": losses + more,
           "step_ms": ms + more_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9
           if cuda else None,
           "state_gb": 12 * local_numel / 1e9,
           "state_gb_one_device": 12 * full_numel / 1e9,
           "launches": launches}
    if cuda:
        expected = {k: RANKS_STEPS * n for k, n in
                    expected_train_launches(cfg, shape.seq_len).items()}
        check(launches == expected, f"ranks {cfg.name} rank {rank}: launches "
              f"{launches}, expected {expected}")
    check(all(math.isfinite(v) for v in rec["losses"]),
          f"ranks {cfg.name}: finite losses {rec['losses']}")
    del state, params
    if cuda:
        torch.cuda.empty_cache()
    if oracle_accum is not None and rank == 0:
        one = init_train_state(cfg, ex, SEED)
        one_step = make_train_step(cfg, ex, accum=oracle_accum)
        one, one_losses, one_ms = _ranks_steps_local(one_step, one,
                                                     batches[:1], device)
        # .grad keeps the microbatches' sum; the step divides it by accum
        one_grads = {n: p.grad.float().cpu() / oracle_accum
                     for n, p in one.model.named_parameters()}
        one, more, more_ms = _ranks_steps_local(one_step, one, batches[1:],
                                                device)
        one_losses += more
        errs = {n: float(torch.linalg.norm(grads[n] - one_grads[n])
                         / max(float(torch.linalg.norm(one_grads[n])),
                               1e-30)) for n in grads}
        worst = max(errs, key=errs.get)
        gap = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                      one_losses))
        rec.update(one_device_losses=one_losses, one_device_ms=one_ms + more_ms,
                   one_device_accum=oracle_accum, max_loss_rel_gap=gap,
                   worst_grad=worst, worst_grad_rel_l2=errs[worst],
                   mean_grad_rel_l2=sum(errs.values()) / len(errs))
        check(gap <= RANKS_LOSS_RTOL, f"ranks {cfg.name}: losses "
              f"{rec['losses']} vs one device's {one_losses}")
        check(errs[worst] <= RANKS_GRAD_REL_L2, f"ranks {cfg.name}: step 1's "
              f"gradient of {worst} {errs[worst]} from one device's")
        del one
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _ranks_steps_local(step, state, batches, device):
    """``_ranks_steps`` on one rank alone (no barrier)."""
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    return state, losses, ms


def ranks_main(argv) -> int:
    """The sharded trainer on every rank of a torchrun group (NCCL on the
    cards, one a rank; ``--device cpu --reduced`` runs it on gloo over
    the reduced configs): TinyLlama-1.1B at full depth on a (world, 1)
    mesh against ``make_train_step`` on rank 0's card; Mixtral-8x7B at
    full width, 1 layer, a2a on (world, 1) against one card's
    ``make_train_step`` with accum = world (each microbatch routed on its
    own, as each data rank's tile is, and ``cap_exp`` = ``capacity()``
    there), then 2 layers on (world / 2, 2), the all-to-all between the
    cards.  Rank 0 prints each case's every rank's numbers."""
    import argparse

    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails outside a checkout of the repo
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train_exec_config
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])) if cuda \
        else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            device_id=device if cuda else None)
    t0 = time.perf_counter()
    try:
        seq = 16 if args.reduced else TRAIN_SEQ_SHARD

        def config(arch, depth=None):
            cfg = get_config(arch)
            cfg = cfg.reduced() if args.reduced else cfg
            if depth is not None:
                cfg = dataclasses.replace(cfg, n_layers=depth)
            ex = train_exec_config(cfg, device)
            return cfg, ex, ShapeConfig("train", "train", seq, TRAIN_BATCH)

        cases = {}
        cfg, ex, shape = config(RANKS_DENSE)
        cases["dense"] = _ranks_case(cfg, ex, shape, (world, 1), device,
                                     oracle_accum=1)
        cfg, ex, shape = config(RANKS_MOE, RANKS_MOE_ORACLE_DEPTH)
        ex = dataclasses.replace(ex, moe_impl="a2a")
        cases["moe_data"] = _ranks_case(cfg, ex, shape, (world, 1), device,
                                        oracle_accum=world)
        if world % 2 == 0:
            cfg, ex, shape = config(RANKS_MOE, RANKS_MOE_DEPTH)
            ex = dataclasses.replace(ex, moe_impl="a2a")
            cases["moe_a2a"] = _ranks_case(cfg, ex, shape, (world // 2, 2),
                                           device)
        every = [None] * world
        dist.all_gather_object(every, cases)
        names = [None] * world
        dist.all_gather_object(names, torch.cuda.get_device_name(device)
                               if cuda else "cpu")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for case in every[0]:
            log("ranks", {"case": case, "world_size": world,
                          "reduced": args.reduced, "devices": names,
                          "by_rank": [e[case] for e in every]})
        log("done", f"ranks in {time.perf_counter() - t0:.1f} s")
        if cuda:
            print(card_line())
        print(json.dumps({"ok": True, "ranks": world}))
    return 0


# the serving paths: arch, serve depth (None: the config's), serve
# prompt, depth of the card-vs-CPU check, its prompt
PATHS = (
    ("tinyllama-1.1b", None, SERVE_PROMPT, 2, 200),
    # one period of 6 SSM layers + the shared block, then one leftover
    # layer; the prompt is a multiple of the SSD chunk (128)
    ("zamba2-7b", None, SERVE_PROMPT, 7, 256),
    # 8 of 94 layers: 21.15 B params, 42.3 GB in bf16 (all 94 are 470 GB)
    ("qwen3-moe-235b-a22b", 8, SERVE_PROMPT, 1, 128),
    # all 48 layers (1.6 GB in bf16); the prefill's final states go to
    # decode; the check's prompt is two SSD chunks
    ("mamba2-780m", None, SERVE_PROMPT, 2, 256),
    # 12 of 60 layers (7.61 B params, 15.2 GB in bf16; all 60 are 68.8 GB
    # before the KV cache); the check's prompt is longer than the 576
    # prefix positions
    ("llava-next-34b", 12, SERVE_PROMPT, 1, 640),
    # all 24 + 24 layers (0.76 B params, 1.5 GB in bf16) over 1500 encoder
    # frames (30 s of audio); prompt 384 + 64 new tokens is the decoder's
    # 448-token context (openai/whisper's n_text_ctx); the check runs 2 + 2
    # layers at the full 1500 frames
    ("whisper-medium", None, WHISPER_PROMPT, 2, WHISPER_PROMPT),
)
SOURCES = {
    # kernel: (source, the TPU kernel it replaces)
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:90"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:26"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:69"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:45"),
    "wavefront": ("src/repro_torch/csrc/wavefront.cu",
                  "src/repro/events/batch.py:277"),
}
NOT_PALLAS = {"wavefront": "replaces _jax_shape_fn, a jitted array program "
                           "of the study's event re-rank, not a Pallas "
                           "kernel"}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return {"flash_attention_fwd": phase_flash(gen),
            "rmsnorm": phase_rmsnorm(gen), "ssd_scan": phase_ssd(gen),
            "moe_gmm": phase_gmm(gen), "wavefront": phase_wavefront()}


# 2b. lint: the findings the card's entry points may keep, because the
# code is CPU-only: the gmm's plain version (ops sends a CUDA tensor to
# the kernel) and the key check of wavefront's CPU branch
LINT_CPU_ONLY = (
    "torch-hygiene::src/repro_torch/kernels/moe_gmm.py::moe_gmm_plain::"
    "host-sync: `.tolist()` on tensor data (block_group_ids) copies it to "
    "the host and waits for the card",
    "torch-hygiene::src/repro_torch/kernels/wavefront.py::wavefront::"
    "host-sync: `int()` of tensor data (key_rows) copies it to the host and "
    "waits for the card",
)
# the entries whose card path syncs (the gmm's dw: ROADMAP Queue B item 3)
LINT_SYNC_ENTRIES = ("_MoEGMM.backward",)
# grad-phase op, shape (as GRAD_CASES), its autograd Function in ops
LINT_OPS = [("rmsnorm", (256, 2048), "_RMSNorm"),
            ("ssd", (1, 256, 8, 64, 1, 128, 128), "_SSD"),
            ("gmm", (4, 128, 256, 256, 128), "_MoEGMM"),
            ("flash", (1, 8, 2, 256, 256, 64, True), "_FlashAttention")]
# forwards run again at another shape (entry, op, shape): the gmm's decode
# kernel, at block_t 8
LINT_MORE_FORWARDS = [("_MoEGMM.forward", "gmm", (16, 8, 512, 256, 8))]


def _syncs(fn) -> str:
    """'' when ``fn()`` runs under ``torch.cuda.set_sync_debug_mode(
    "error")``, else the error of the synchronizing call it made; the
    earlier mode is restored whatever ``fn`` does."""
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
    return ""


def _staged_terms():
    """The cost terms' inputs as ``batched_simulate`` stages them on the
    card (the scan phase's cell, 3,072 points) -> a call of
    ``_terms_core`` on them."""
    from repro_torch.dse import batched_sim as bs
    w, batch, local, mcms = scan_cell()
    staged, core = [], bs._terms_core

    def capture(*args):
        staged.append(args)
        return core(*args)
    bs._terms_core = capture
    try:
        bs.batched_simulate(w, batch, bs.MCMBatch.from_mcms(mcms, local),
                            fabric="oi", hw=mcms[0].hw, device="cuda")
    finally:
        bs._terms_core = core
    (t, w_scalars, fabric, hw), = staged
    check(all(v.is_cuda for v in t.values()), "terms staged on the card")
    return lambda: core(t, w_scalars, fabric, hw)


def phase_lint():
    """chiplint over the port's tree (``repro_torch.analysis``, as ``cli
    lint`` runs it): baseline-exact, the findings by rule; then the
    torch-hygiene rule's verdicts held against the card.  Each registered
    entry point is linted alone; the ones whose findings lie on the card's
    path (``LINT_SYNC_ENTRIES``; ``LINT_CPU_ONLY`` lie off it) must make
    the host wait, every other must not: each runs once to warm up
    (kernels built), then under ``torch.cuda.set_sync_debug_mode("error")``
    with its inputs already on the card, the forward of a backward case
    outside the mode."""
    from collections import Counter

    import numpy as np

    from repro_torch.analysis import (DEFAULT_CONFIG, diff_baseline,
                                      load_baseline, run_lint)
    from repro_torch.analysis.astutil import ModuleCache
    from repro_torch.analysis.findings import DEFAULT_BASELINE
    from repro_torch.analysis.torch_hygiene import check_torch_hygiene
    from repro_torch.kernels import ops
    from repro_torch.kernels.wavefront import wavefront

    t0 = time.perf_counter()
    report = run_lint(ROOT, DEFAULT_CONFIG)
    new, stale = diff_baseline(report.findings,
                               load_baseline(ROOT / DEFAULT_BASELINE))
    log("lint", {"files": report.n_files,
                 "findings_by_rule": dict(Counter(
                     f.rule for f in report.findings)),
                 "new": len(new), "stale": len(stale),
                 "suppressed": report.n_suppressed,
                 "lint_s": round(time.perf_counter() - t0, 3)})
    check(not new and not stale,
          f"the tree is baseline-exact ({DEFAULT_BASELINE}): "
          f"{[f.render() for f in new]} {stale}")
    check(report.n_files > 80, f"lint scanned {report.n_files} files")

    cache = ModuleCache(ROOT)
    verdict = {}
    for entry in DEFAULT_CONFIG.torch_entries:
        on_card = [f for f in check_torch_hygiene(cache, (entry,))
                   if f.fingerprint not in LINT_CPU_ONLY]
        verdict[entry.qualname] = [f"{f.path}:{f.line}" for f in on_card]
    log("lint", {"static_syncs_by_entry": verdict})
    check(sorted(q for q, v in verdict.items() if v)
          == sorted(LINT_SYNC_ENTRIES),
          f"entries with syncs on the card's path: {verdict}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    runs = {}        # entry -> the call that runs it, warmed up
    runs["_terms_core"] = _staged_terms()
    tabs, key_rows, rows = wavefront_inputs(
        [("gpipe", 16, 1, 64), ("1f1b", 8, 1, 32), ("interleaved", 2, 2, 8)],
        1024, np.random.RandomState(SEED))
    wf = [t.cuda() for t in (*tabs, key_rows, rows)]
    runs["wavefront"] = lambda: wavefront(*wf)
    q = torch.randn(2, 8, 1, 64, device="cuda", generator=gen).to(BF16)
    kc, vc = (torch.randn(2, 2, 256, 64, device="cuda",
                          generator=gen).to(BF16) for _ in range(2))
    runs["decode_attention"] = lambda: ops.decode_attention(
        q, kc, vc, 200, window=128)
    backward = {}    # backward entry -> (the op, its inputs, output grads)
    for op, shape, function in LINT_OPS:
        fn, _, ins, douts, _, _ = _grad_case(op, shape, BF16, gen)
        runs[f"{function}.forward"] = (lambda fn=fn, ins=ins: fn(*ins))
        backward[f"{function}.backward"] = (fn, ins, douts)
    for entry, op, shape in LINT_MORE_FORWARDS:
        fn, _, ins, _, _, _ = _grad_case(op, shape, BF16, gen)
        runs[f"{entry} {shape}"] = (lambda fn=fn, ins=ins: fn(*ins))
    for entry in verdict:
        check(entry in runs or entry in backward,
              f"chip_smoke runs the registered entry {entry}")
    for fn in runs.values():
        fn()
    for fn, ins, douts in backward.values():
        _fwd_bwd(fn, ins, douts)
    torch.cuda.synchronize()

    got = {}
    for entry, fn in runs.items():
        got[entry] = _syncs(fn)
    for entry, (fn, ins, douts) in backward.items():
        out = fn(*ins)                      # the forward, outside the mode
        outs = out if isinstance(out, tuple) else (out,)
        if entry == "_MoEGMM.backward":     # as a training step calls it
            got[entry] = _syncs(out.sum().backward)
        else:
            got[entry] = _syncs(lambda: torch.autograd.grad(
                outs, ins, douts[:len(outs)]))
    log("lint", {"card_syncs_by_entry": got,
                 "phase_s": round(time.perf_counter() - t0, 3)})
    for entry, err in got.items():
        name = entry.split(" ")[0]   # a forward at another shape: its entry
        want = name in LINT_SYNC_ENTRIES
        check(bool(err) == want,
              f"{entry} {'syncs' if err else 'runs without a sync'} under "
              f"set_sync_debug_mode('error') on the card, while the "
              f"torch-hygiene rule says it "
              f"{'syncs' if want else 'does not'}: {err or verdict[name]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("header", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    phase_build()
    records = phase_kernels()
    t_new = time.perf_counter()
    phase_lint()
    log("done", f"lint phase in {time.perf_counter() - t_new:.1f} s")
    by_path = {}
    for arch, serve_depth, serve_prompt, check_depth, prompt in PATHS:
        launches, served = phase_serve(arch, serve_depth, serve_prompt)
        phase_profile(*served)
        del served   # the served model
        torch.cuda.empty_cache()
        phase_check(arch, check_depth, prompt)
        by_path[arch] = launches
    by_path["study"] = phase_study()
    phase_scan()
    by_path["calibrate"] = phase_calibrate()
    t_new = time.perf_counter()
    by_path["grad"], grad_records = phase_grad()
    dryruns = DryRuns()
    try:
        # the dry run needs the host alone: it runs while the train
        # phase's steps keep the card busy
        dryruns.start()
        for arch, label, *shape in TRAIN_PATHS:
            by_path[label], by_path[f"{label}_remat_full"] = \
                phase_train(arch, *shape)
        log("done", f"grad and train phases in "
            f"{time.perf_counter() - t_new:.1f} s")
        t_new = time.perf_counter()
        by_path["validate"] = phase_validate()
        by_path["resume"] = phase_resume()
        log("done", f"validate and resume phases in "
            f"{time.perf_counter() - t_new:.1f} s")
        t_new = time.perf_counter()
        by_path["shard"] = phase_shard()
        log("done", f"shard phase in {time.perf_counter() - t_new:.1f} s")
        t_new = time.perf_counter()
        by_path["dryrun"] = phase_dryrun(dryruns)
        log("done", f"dryrun phase in {time.perf_counter() - t_new:.1f} s")
    finally:
        dryruns.stop()

    kernels = []
    for name, rec in records.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {a: n[name] for a, n in by_path.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
            **({"note": NOT_PALLAS[name]} if name in NOT_PALLAS else {}),
            # forward + backward through ops (the grad phase)
            "fwd_bwd": [{k: r[k] for k in ("case", "shape", "dtype", "ms",
                                           "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "grad_rel_l2")}
                        for r in grad_records.values()
                        if GRAD_KERNEL[r["op"]] == name],
            "other_shapes": [
                {k: r[k] for k in ("case", "shape", "dtype", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "max_abs_err", "library_max_abs_err",
                                   "state_ms", "state_bound_ms",
                                   "state_max_abs_err")
                 if k in r}
                for r in rec.get("shapes", [])]})
    log("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(ranks_main(sys.argv[1:]) if "--ranks" in sys.argv[1:]
                 else main())
    except Exception as e:
        # the failing phase: the innermost phase_* function on the stack
        import traceback
        phase = next((f.name[len("phase_"):] for f in reversed(
            traceback.extract_tb(e.__traceback__))
            if f.name.startswith("phase_")), "main")
        print(f"[fail] {phase}: {e}", flush=True)
        raise
