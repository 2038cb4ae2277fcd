"""The production dry run (counterpart of ``repro/launch/dryrun.py``):
every (architecture x input shape x mesh) cell's step traced over fake
tensors on a fake process group of 256 ranks (one pod, ``(16, 16)``
``("data", "model")``) or 512 (two pods, ``(2, 16, 16)``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        tinyllama_1_1b --shape train_4k --device cpu

The reference lowers and compiles each cell against the production mesh
with ``ShapeDtypeStruct`` inputs and reads ``cost_analysis``,
``memory_analysis`` and the HLO's collectives.  The port has no
compiler: each cell runs the port's own step once, eagerly, as rank 0 of
a ``"fake"`` process group (no communication, no other process), with
every tensor a fake one (``FakeTensorMode``: shapes and dtypes, no
memory, no kernel).  Train cells run one step of
``launch/train.py::build_sharded_train`` under the reference's dry-run
remat, ``ExecConfig(remat="full")`` (each layer body recomputed in the
backward); prefill and decode cells run
``make_prefill_step`` and ``make_serve_step`` on a module sharded by
``parallel/fsdp.py::shard_module`` with ``param_specs`` (decode's cache
placed by ``cache_specs``).  Around the step only:
  * ``launch/hlo.py::collectives_from_trace``: each collective's result
    and ring wire bytes, and the bytes every other op reads and writes;
  * ``FlopCounterMode`` (``hlo.counting_flops``, without its per-module
    tracker): the FLOPs of the torch ops (the backwards in
    torch ops among them), to which the hand kernels' fake branches add
    their nominal operations and bytes (``hlo.counting_kernels``);
  * and the peak of the rank's live storages (``collectives_from_trace``
    again: ``MemTracker``'s per-module bookkeeping makes a trace
    quadratic in the depth).
Eager tracing sees every layer, so no depth is extrapolated.  Each cell
writes ``<out>/<arch>__<shape>__<mesh>.json`` (default
``artifacts/dryrun_torch/``) with the reference's keys; an existing one
is kept unless ``--force``.  A cell that fails is listed and the run
exits 1.  ``--device cuda`` (the default) makes the fake tensors CUDA
ones, which need a CUDA build of torch; ``--device cpu`` traces the same
step on CPU fakes.  Nothing is launched either way.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch.hlo import tensor_bytes
from repro_torch.launch.mesh import fsdp_axes, make_production_mesh
from repro_torch.launch.steps import (TrainState, make_prefill_step,
                                      make_serve_step)
from repro_torch.models import build_model
from repro_torch.models.common import ExecConfig
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import (_ep_on_model, axis_sizes,
                                           batch_specs, cache_specs,
                                           local_slice, param_specs)

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# Cells skipped per DESIGN.md §shape-cell-skips (pure full attention at
# 500k decode; enc-dec audio backbone bounded at 1500 frames).
LONG_OK = {"mamba2_780m", "zamba2_7b", "mixtral_8x7b", "gemma2_2b",
           "gemma3_27b"}

WORLD = {"single": 256, "multi": 512}
# the parameters' and the compute's dtype (the reference's dry run's)
DTYPE = torch.bfloat16
# the kernel modules whose ``launches`` a cell must leave where it found
# them: the dry run launches nothing
_KERNEL_MODULES = ("flash_attention", "rmsnorm", "ssd_scan", "moe_gmm")


def _data_ranks(sizes) -> int:
    """Ranks over the data axes (``pod`` and ``data``)."""
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _batch_sharded(shape, sizes) -> bool:
    """Whether the data ranks split the batch (``cache_specs``' test)."""
    data = _data_ranks(sizes)
    return shape.global_batch % data == 0 and shape.global_batch >= data


def cell_enabled(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_OK
    return True


def skip_reason(cfg: ModelConfig, shape, sizes) -> str | None:
    """Why the port cannot run this cell's step on a mesh of ``sizes``,
    or None: a MoE train step whose experts do not divide the model axis
    would take the dense dispatch, which ``build_sharded_train`` refuses
    past one data rank; a decode step at a batch the data ranks do not
    divide would find its KV cache's sequence split over them
    (``cache_specs``), which the port's decode cannot index."""
    data = _data_ranks(sizes)
    if shape.kind == "train" and cfg.moe is not None \
            and not _ep_on_model(cfg, sizes) and data > 1:
        return (f"{cfg.name}: {cfg.moe.n_experts} experts do not divide "
                f"the model axis of {sizes['model']}, so the all-to-all "
                f"cannot hold them, and build_sharded_train refuses the "
                f"dense MoE dispatch past one data rank ({data} here)")
    if shape.kind == "decode" and cfg.attn is not None \
            and not _batch_sharded(shape, sizes):
        return (f"{cfg.name}: at batch {shape.global_batch} cache_specs "
                f"splits the KV cache's sequence over the {data} data "
                f"ranks; the port's decode step indexes its cache at the "
                f"global position and has no cross-rank softmax")
    return None


def exec_config(cfg: ModelConfig, shape, device, mesh,
                remat: str = "full") -> ExecConfig:
    """The reference's dry-run knobs that the port has: bf16 parameters
    and compute, its remat ("full": each layer body recomputed in the
    backward; serving runs without grad, where remat does nothing), its
    attention block and SSD chunk; the all-to-all where the experts
    divide the model axis (train only: serving runs the dense
    dispatch)."""
    long = shape.seq_len >= 32768
    a2a = cfg.moe is not None and shape.kind == "train" \
        and _ep_on_model(cfg, axis_sizes(mesh))
    return ExecConfig(param_dtype=DTYPE, compute_dtype=DTYPE, remat=remat,
                      attn_block=2048 if long else 1024,
                      ssd_chunk=1024 if long else 256, device=str(device),
                      moe_impl="a2a" if a2a else "dense",
                      mesh=mesh if a2a else None)


@contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in which this process is
    rank 0, destroyed on exit.  Raises if a default group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "this process already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _fake_module(model_fns, ex, fake_mode):
    """The family's module with fake parameters of ``ex.param_dtype`` on
    ``ex.device`` (made on the meta device, then given fake storage)."""
    model = model_fns.skeleton(ex.param_dtype)
    with fake_mode:
        model.to_empty(device=ex.device)
    return model


def spec_wire_bytes(cfg: ModelConfig, shape, mesh_sizes,
                    a2a: bool = False) -> dict | None:
    """The all-gather and reduce-scatter wire bytes one rank's train
    step should make, from ``param_specs`` alone: each parameter
    gathered over the axes its spec shards it on (an expert keeps its
    ``model`` shard under the all-to-all) is S·(N-1)/N on the wire for S
    its gathered bytes and N those axes' ranks, whatever order the axes
    go in; its gradient's reduce-scatter the same.  The forward reads
    each parameter once and the backward gathers it again (for a layer
    under remat, in its recompute), but for a lookup table (an untied
    embedding), which the backward does not read.  Under the all-to-all each MoE layer gathers its output and,
    in the backward, the gradient of its input over the model axis.
    Holds for the transformer families (dense, moe, vlm); None for
    others and for serving cells."""
    if shape.kind != "train" or cfg.family not in ("dense", "moe", "vlm"):
        return None
    model = build_model(cfg).skeleton(DTYPE)
    specs = param_specs(cfg, model, mesh_sizes)
    itemsize = DTYPE.itemsize
    gathers = scatters = 0.0
    for name, p in model.named_parameters():
        keep = a2a and name.endswith((".moe.w1", ".moe.w2", ".moe.w3"))
        n = kept = 1
        for entry in specs[name]:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is None or mesh_sizes[a] == 1:
                    continue
                if keep and a == "model":
                    kept *= mesh_sizes[a]
                else:
                    n *= mesh_sizes[a]
        size = p.numel() * itemsize / kept
        wire = size * (n - 1) / n
        reads = 1
        if name == "embed":
            # a lookup, not saved; tied, the unembedding reads it again
            reads = 2 if cfg.tie_embeddings else 0
        gathers += wire * (1 + reads)
        scatters += wire
    detail = {"param_gathers": gathers, "param_reduce_scatters": scatters}
    if a2a:
        m = mesh_sizes["model"]
        act = (shape.global_batch // _data_ranks(mesh_sizes)) \
            * shape.seq_len * cfg.d_model * itemsize
        detail["a2a_activation_gathers"] = \
            2 * cfg.n_layers * act * (m - 1) / m
    return {"all-gather": gathers + detail.get("a2a_activation_gathers",
                                               0.0),
            "reduce-scatter": scatters, "detail": detail}


def _state_bytes(state: TrainState) -> float:
    return tensor_bytes([_local(p) for p in state.model.parameters()]
                        + [_local(t) for t in state.opt.m.values()]
                        + [_local(t) for t in state.opt.v.values()])


def _out_bytes(out, args) -> float:
    """Bytes of the tensors in ``out`` whose storage is none of
    ``args``'s (what the step makes, not what it updates in place)."""
    from torch.multiprocessing.reductions import StorageWeakRef

    def flat(x):
        if isinstance(x, torch.Tensor):
            yield _local(x)
        elif isinstance(x, dict):
            for v in x.values():
                yield from flat(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from flat(v)
        elif isinstance(x, torch.nn.Module):
            yield from flat(list(x.parameters()))
    known = {StorageWeakRef(t.untyped_storage()) for t in flat(args)}
    new = {StorageWeakRef(t.untyped_storage()): t for t in flat(out)}
    return tensor_bytes([t for k, t in new.items() if k not in known])


def _prepare(cfg, shape, ex, mesh, fake_mode):
    """-> (step(*args), args, the local argument bytes, the tensors live
    before the step: the state, and a serving step's local batch or cache
    (each a copy of its own, not a view of the global one; a train step
    slices its global batch itself))."""
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.parallel import fsdp
    model_fns = build_model(cfg)
    sizes = axis_sizes(mesh)
    coords = {a: mesh.get_local_rank(a) for a in sizes}
    if shape.kind == "train":
        step, place = build_sharded_train(cfg, ex, mesh, shape)
        model = _fake_module(model_fns, ex, fake_mode)
        with fake_mode:
            state = place(TrainState(model=model, opt=adamw_init(
                dict(model.named_parameters()))))
            batch = model_fns.make_batch(0, shape, ex, kind="train")
        spec_for = batch_specs(cfg, shape, mesh, kind="train")
        local = [local_slice(v, spec_for(k), mesh, coords)
                 for k, v in batch.items()]
        tracked = [*state.model.parameters(), *state.opt.m.values(),
                   *state.opt.v.values()]
        return step, (state, batch), \
            _state_bytes(state) + tensor_bytes(local), tracked
    model = _fake_module(model_fns, ex, fake_mode)
    fsdp.shard_module(model, param_specs(cfg, model, mesh), mesh,
                      compute_dtype=ex.compute_dtype)
    params = tensor_bytes([_local(p) for p in model.parameters()])
    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, ex)
        spec_for = batch_specs(cfg, shape, mesh, kind="prefill")
        with fake_mode:
            batch = model_fns.make_batch(0, shape, ex)
            batch = {k: local_slice(v, spec_for(k), mesh, coords).clone()
                     for k, v in batch.items()}
        return prefill, (model, batch), \
            params + tensor_bytes(list(batch.values())), \
            list(model.parameters())
    serve = make_serve_step(cfg, ex)
    rule = cache_specs(cfg, shape, mesh)
    with fake_mode:
        cache = model_fns.init_cache(shape.global_batch, shape.seq_len, ex)
        cache = {k: local_slice(v, _heads_whole(rule(k, tuple(v.shape))),
                                mesh, coords).clone()
                 for k, v in cache.items()}
        tokens = torch.zeros((shape.global_batch,), dtype=torch.int64,
                             device=ex.device)
        if _batch_sharded(shape, sizes):
            tokens = local_slice(tokens, (fsdp_axes(mesh),), mesh, coords)
    pos = shape.seq_len - 1
    return (lambda m, c, t: serve(m, c, t, pos)), (model, cache, tokens), \
        params + tensor_bytes([*cache.values(), tokens]), \
        [*model.parameters(), *cache.values()]


def _heads_whole(spec) -> tuple:
    """``cache_specs``'s entry without the ``model`` axis: the port's
    serving step gathers its weights over ``model`` and computes every
    head on every model rank, so its cache holds every head; the batch
    (at batch 1 the sequence) stays over the data axes."""
    def drop(entry):
        axes = tuple(a for a in (entry if isinstance(entry, tuple)
                                 else (entry,)) if a not in (None, "model"))
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    return tuple(drop(e) for e in spec)


def _launches() -> dict:
    import importlib
    return {m: importlib.import_module(f"repro_torch.kernels.{m}").launches
            for m in _KERNEL_MODULES}


def measure(cfg: ModelConfig, shape, mesh, device, remat: str = "full"
            ) -> dict:
    """Trace one step of ``shape.kind`` for ``cfg`` on ``mesh`` (a
    ``DeviceMesh`` over a fake group) over fake tensors on ``device``
    under ``remat`` (``ExecConfig.remat``) -> the record's measured
    fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = torch.device(device)
    sizes = axis_sizes(mesh)
    t0 = time.perf_counter()
    ex = exec_config(cfg, shape, device, mesh, remat)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, args, arg_bytes, tracked = _prepare(cfg, shape, ex, mesh,
                                              fake_mode)
    t_lower = time.perf_counter() - t0
    before = _launches()
    # the first remat checkpoint imports torch._dynamo, whose frames would
    # hold the step's frames in a reference cycle (freed whenever the
    # cyclic collector runs, which would move the live storages' peak):
    # it is imported here
    from torch import _dynamo  # noqa: F401
    with fake_mode:
        t0 = time.perf_counter()
        # the backward on this thread for fake CUDA tensors too, as for
        # CPU ones: a remat body's recompute then counts its kernels (the
        # counts are this thread's context variable)
        with hlo_mod.collectives_from_trace() as trace, \
                hlo_mod.counting_flops() as flops, \
                hlo_mod.counting_kernels() as kernels, \
                torch.autograd.set_multithreading_enabled(False):
            trace.track(tracked)
            start = trace.live_bytes
            out = step(*args)
        t_trace = time.perf_counter() - t0
        peak = trace.peak_bytes
        peak_by_op, peak_top = trace.peak_breakdown()
        out_bytes = _out_bytes(out, args)
    launched = {m: n - before[m] for m, n in _launches().items()}
    coll = trace.stats
    n_chips = dist.get_world_size()
    torch_flops = float(flops.get_total_flops())
    flops_x = torch_flops + kernels.flops
    bytes_x = trace.hbm_bytes + kernels.bytes
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    mult = 6.0 if shape.kind == "train" else 2.0
    return {
        "kind": shape.kind, "n_chips": n_chips,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "mesh_shape": sizes, "device": device.type,
        "hlo_flops_per_device": flops_x,
        "hlo_bytes_per_device": bytes_x,
        "coll_wire_bytes_per_device": coll.total_wire,
        "raw_flops_per_device": flops_x,
        "raw_bytes_per_device": bytes_x,
        "raw_wire_bytes_per_device": coll.total_wire,
        "depth_points": {"l1": cfg.n_layers, "l2": cfg.n_layers, "pts": [],
                         "note": "eager tracing runs every layer: no depth "
                                 "extrapolation"},
        "coll_result_bytes_per_device": coll.total_result,
        "coll_breakdown": coll.wire_bytes,
        "coll_counts": coll.counts,
        "spec_wire_bytes": spec_wire_bytes(cfg, shape, sizes,
                                           a2a=ex.moe_impl == "a2a"),
        "torch_flops_per_device": torch_flops,
        "kernel_flops_per_device": kernels.flops,
        "kernel_bytes_per_device": kernels.bytes,
        "kernel_calls": kernels.calls,
        "launches": launched,
        "moe_impl": ex.moe_impl if cfg.moe is not None else None,
        "remat": ex.remat,
        "mem_argument_bytes": arg_bytes,
        "mem_output_bytes": out_bytes,
        "mem_temp_bytes": float(peak - start),
        "mem_peak_bytes": float(peak),
        # what holds the peak: the live storages by the op that made them
        # and the largest (op, shape, dtype) groups among them
        "mem_peak_by_op": peak_by_op, "mem_peak_top": peak_top,
        "mem_generated_code_bytes": 0.0,
        "roofline": hlo_mod.roofline_terms(flops_x, bytes_x,
                                           coll.total_wire, n_chips),
        "model_flops_step": mult * cfg.active_param_count() * tokens,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "lower_s": t_lower, "compile_s": t_trace,
    }


def trace_cell(arch: str, shape_name: str, mesh_kind: str,
               device="cuda") -> dict:
    """One cell's record, on the production mesh of ``mesh_kind`` over a
    fake group of its own (the process must hold no default group)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    with fake_group(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device=torch.device(device).type)
        reason = skip_reason(cfg, shape, axis_sizes(mesh))
        if reason:
            return {**head, "skipped": True, "reason": reason}
        return {**head, **measure(cfg, shape, mesh, device)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, device="cuda",
             out_dir: Path = ART, force: bool = False) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        print(f"[skip] {out_path.name} exists")
        return json.loads(out_path.read_text())
    if not cell_enabled(arch, shape_name):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "skipped": True,
               "reason": "long_500k inapplicable (see DESIGN.md)"}
    else:
        t0 = time.perf_counter()
        rec = trace_cell(arch, shape_name, mesh_kind, device)
        rec["wall_s"] = time.perf_counter() - t0
    out_path.write_text(json.dumps(rec, indent=1))
    if rec.get("skipped"):
        print(f"[skipped] {arch} {shape_name} {mesh_kind}: {rec['reason']}")
    else:
        print(f"[ok] {arch} {shape_name} {mesh_kind}: "
              f"flops/dev={rec['hlo_flops_per_device']:.3e} "
              f"bytes/dev={rec['hlo_bytes_per_device']:.3e} "
              f"wire/dev={rec['coll_wire_bytes_per_device']:.3e} "
              f"argbytes/dev={rec['mem_argument_bytes'] / 1e9:.2f}GB "
              f"temp/dev={rec['mem_temp_bytes'] / 1e9:.2f}GB "
              f"(prepare {rec['lower_s']:.1f}s trace "
              f"{rec['compile_s']:.1f}s, wall {rec['wall_s']:.1f}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[None] + list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (needs a CUDA "
                    "build of torch) or cpu")
    ap.add_argument("--out", default=str(ART),
                    help="directory of the per-cell records")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) \
        else [args.arch.replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                try:
                    run_cell(arch, shape, mk, device=args.device,
                             out_dir=Path(args.out), force=args.force)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mk, repr(e)))
                    print(f"[FAIL] {arch} {shape} {mk}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
