"""The production dry run (``repro_torch/launch/dryrun.py``,
``launch/hlo.py``) and what it rests on, on the CPU.

* The wire formulas and ``roofline_terms`` against ``repro.launch.hlo``'s
  on the same sizes (the reference parses HLO text: each case is one
  collective line of it).  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at
  import, so its record's keys are read from its source, not imported.
* Each hand-kernel op's fake branch (``kernels/ops.py``): the plain
  version's shapes and dtypes, forward and backward, the kernel's nominal
  FLOPs (``kernels/cost.py``) counted, no data-dependent op; a real
  tensor never takes it.
* ``parallel/fsdp.py`` under fake tensors: every saved tensor that is a
  gathered parameter is saved as ``_Saved``, its own parameter, and no
  activation is.
* A tiny dense model and a tiny MoE over the all-to-all on a (4, 2) mesh
  of a fake 8-rank group: the trace's all-gather and reduce-scatter bytes
  equal the sums ``param_specs`` gives, and two runs give one record;
  on a (2, 2, 2) ("pod", "data", "model") mesh too (the experts'
  gradients one reduce-scatter over pod and data).
* The dry run's remat "full": each layer's kernels once more, the wire
  bytes unchanged, the peak lower; Zamba2's leftover layers outside it.
* The CLI writes the reference's skipped records.

Every fake group is made and destroyed inside its test
(``dryrun.fake_group``).
"""
import ast
import contextlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo as ref_hlo
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import cost, ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_plain
from repro_torch.launch import dryrun, hlo

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


# ---------------------------------------------------------------------------
# hlo: wire formulas, roofline terms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_are_the_reference_s(kind):
    """One collective of each kind over groups of 2-512 and results of
    1-10^8 bytes: the port's result and wire bytes are what the
    reference's ``parse_collectives`` reads from the same HLO line."""
    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(20):
        n = int(rng.choice([2, 4, 8, 16, 256, 512]))
        rows = int(rng.integers(1, 5000))
        cols = int(rng.integers(1, 5000))
        dt, size = ("bf16", 2) if rng.random() < 0.5 else ("f32", 4)
        groups = ",".join(str(i) for i in range(n))
        line = (f"%x = {dt}[{rows},{cols}]{{1,0}} {kind}({dt}[{rows},{cols}]"
                f" %p), replica_groups={{{{{groups}}}}}")
        want = ref_hlo.parse_collectives(line)
        got = hlo.CollectiveStats()
        got.add(kind, float(rows * cols * size), n)
        assert got.result_bytes == want.result_bytes
        assert got.wire_bytes[kind] == pytest.approx(
            want.wire_bytes[kind], rel=1e-15)
        assert got.counts == want.counts
        assert got.total_wire == pytest.approx(want.total_wire, rel=1e-15)


def test_roofline_terms_are_the_reference_s_on_the_h100_sheet():
    """The same terms as the reference's at the same rates; the defaults
    are one H100 SXM's data-sheet rates, not the reference's v5e."""
    rates = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
    for flops, nbytes, wire in ((5.5e14, 2e13, 6.4e9), (1.0, 2.0, 3.0)):
        assert hlo.roofline_terms(flops, nbytes, wire, 256) == \
            ref_hlo.roofline_terms(flops, nbytes, wire, 256, **rates)
    assert (hlo.H100_SXM_BF16_FLOPS, hlo.H100_SXM_HBM3_BYTES_PER_S,
            hlo.H100_SXM_NVLINK_BYTES_PER_S) == (989e12, 3.35e12, 450e9)
    assert hlo.roofline_terms(1.0, 1.0, 1.0, 1) != \
        ref_hlo.roofline_terms(1.0, 1.0, 1.0, 1)


def test_the_trace_reads_c10d_collectives_with_their_groups():
    """``dist`` calls (the all-to-all MoE's, the optimizer's) under fake
    tensors: each collective's result bytes and its group's size, by the
    reference's formulas; ``wait_tensor`` and views move no bytes."""
    import torch.distributed as dist
    with dryrun.fake_group(8), FakeTensorMode():
        sub = dist.new_group([0, 1, 2, 3])
        x = torch.empty(4, 8)
        with hlo.collectives_from_trace() as trace:
            dist.all_to_all_single(torch.empty(4, 8), x, group=sub)
            dist.all_gather([torch.empty(4, 8) for _ in range(4)], x,
                            group=sub)
            dist.all_reduce(x)
            x.view(32)
    want = hlo.CollectiveStats()
    want.add("all-to-all", 128.0, 4)
    want.add("all-gather", 512.0, 4)
    want.add("all-reduce", 128.0, 8)
    assert trace.stats == want
    assert trace.hbm_bytes == 0.0


# ---------------------------------------------------------------------------
# the ops' fake branches
# ---------------------------------------------------------------------------
def _case(op, dt):
    """-> (fn(*inputs) through ops, the plain version likewise, inputs
    (the differentiable first), the nominal FLOPs the fake call counts,
    the kernels it counts)."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g).to(dt)
    if op in ("flash", "flash_window_cross"):
        b, hq, hkv, sq, sk, d = 2, 4, 2, 48, 64 if op != "flash" else 48, 16
        win = 16 if op != "flash" else None
        ins = [rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)]
        flops = cost.flash_fwd_cost(b, hq, hkv, sq, sk, d, win, True, 1)[0]
        return (lambda q, k, v: ops.flash_attention(q, k, v, window=win),
                lambda q, k, v: flash_attention_plain(q, k, v, win)[0],
                ins, 3, flops, {"flash_attention_fwd": 1})
    if op == "rmsnorm":
        ins = [rnd(6, 5, 32), rnd(32)]
        return (lambda x, w: ops.rmsnorm(x, w),
                lambda x, w: rmsnorm_plain(x, w), ins, 2,
                4.0 * 30 * 32, {"rmsnorm": 1})
    if op in ("ssd", "ssd_state"):
        bb, s, h, p, gr, n, chunk = 2, 32, 4, 8, 2, 8, 8
        state = op == "ssd_state"
        ins = [rnd(bb, s, h, p),
               torch.nn.functional.softplus(torch.randn(bb, s, h,
                                                        generator=g)),
               -torch.rand(h, generator=g), rnd(bb, s, gr, n),
               rnd(bb, s, gr, n)]
        return (lambda *t: ops.ssd(*t, chunk=chunk, return_state=state),
                lambda *t: ssd_plain(*t, chunk=chunk, return_state=state),
                ins, 5, cost.ssd_flops(bb, s, h, p, n, chunk),
                {"ssd_scan": 1})
    e, rows, k, n, bt = 4, 16, 16, 24, 8
    ids = torch.arange(e, dtype=torch.int32).repeat_interleave(rows // bt)
    t = e * rows
    return (lambda x, w: ops.moe_gmm(x, w, ids, block_t=bt),
            lambda x, w: moe_gmm_plain(x, w, ids, bt),
            [rnd(t, k), rnd(e, k, n) * k ** -0.5], 2, 2.0 * t * k * n,
            {"moe_gmm": 1})


def _shapes(fn, ins, n_grad):
    """The outputs' and the differentiable inputs' gradients' (shape,
    dtype) through ``fn``."""
    leaves = [t.detach().requires_grad_(i < n_grad)
              for i, t in enumerate(ins)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(o.float().sum() for o in outs).backward()
    return ([(tuple(o.shape), o.dtype) for o in outs],
            [(tuple(t.grad.shape), t.grad.dtype) for t in leaves[:n_grad]])


OPS = ["flash", "flash_window_cross", "rmsnorm", "ssd", "ssd_state", "gmm"]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", OPS)
def test_fake_branch_has_the_plain_shapes_and_counts_the_kernel(op, dt):
    """On fake tensors each op returns the plain version's shapes and
    dtypes, forward and backward, counts its kernel's nominal FLOPs
    (and for the gmm the backward's dx and dw, 2·T·K·N each), and runs
    no data-dependent op (no ``DataDependentOutputException``)."""
    fn, plain, ins, n_grad, flops, calls = _case(op, dt)
    want = _shapes(plain, ins, n_grad)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in ins]
        with hlo.counting_kernels() as counts:
            got = _shapes(fn, fake, n_grad)
    assert got == want
    if op == "gmm":
        assert counts.calls == {"moe_gmm": 2, "moe_gmm_dw": 1}
        assert counts.flops == 3 * flops
    else:
        assert counts.calls == calls and counts.flops == flops
    assert counts.bytes > 0


@pytest.mark.parametrize("op", OPS)
def test_real_tensors_never_take_the_fake_branch(op):
    """With counting active, a real CPU tensor takes the plain version
    (the same values) and counts nothing."""
    fn, plain, ins, _, _, _ = _case(op, torch.float32)
    with hlo.counting_kernels() as counts:
        got = fn(*ins)
    want = plain(*ins)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert counts == hlo.KernelCounts()


def test_cost_counts_the_kernel_s_mask():
    """``attn_live_pairs`` / ``attn_live_keys`` count the kernel's mask
    (query i at position i + Sk - Sq)."""
    for sq, sk, win, causal in ((48, 48, None, True), (48, 64, 16, True),
                                (30, 100, None, False), (7, 7, 1, True),
                                (20, 50, 5, False)):
        r = torch.arange(sq)[:, None] + (sk - sq)
        c = torch.arange(sk)[None, :]
        mask = (r - c < win) if win else torch.ones(sq, sk, dtype=bool)
        if causal:
            mask &= c <= r
        assert cost.attn_live_pairs(sq, sk, win, causal) == int(mask.sum())
        cols = mask.any(0).nonzero()
        assert cost.attn_live_keys(sq, sk, win, causal) == \
            int(cols.max() - cols.min() + 1)


# ---------------------------------------------------------------------------
# fsdp under fake tensors
# ---------------------------------------------------------------------------
def test_fsdp_saves_gathered_parameters_only_under_fakes(monkeypatch):
    """A sharded tiny TinyLlama's forward inside ``gathered_forward`` on
    fake tensors: a packed tensor is saved as ``_Saved`` exactly when its
    storage is a gathered parameter's, and as that parameter (every fake
    tensor's data_ptr is 0, so a pointer key would match them all)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.models import ExecConfig, build_model
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import param_specs
    gathered, packed = {}, []
    real_gather = fsdp._gather

    def gather(p, grad=True):
        full = real_gather(p, grad)
        key = StorageWeakRef(full.untyped_storage())
        with torch.no_grad():
            local = StorageWeakRef(p.to_local().untyped_storage())
        if key != local:                # a copy, not the shard itself
            gathered[key] = p
        return full
    monkeypatch.setattr(fsdp, "_gather", gather)
    real_hooks = torch.autograd.graph.saved_tensors_hooks

    def hooks(pack, unpack):
        def spy(t):
            out = pack(t)
            packed.append((t, out))
            return out
        return real_hooks(spy, unpack)
    monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", hooks)

    cfg = get_config("tinyllama_1_1b").reduced()
    ex = ExecConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                    device="cpu")
    fns = build_model(cfg)
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        model = fns.skeleton(ex.param_dtype)
        with mode:
            model.to_empty(device="cpu")
        fsdp.shard_module(model, param_specs(cfg, model, mesh), mesh,
                          compute_dtype=ex.compute_dtype)
        with mode:
            batch = fns.make_batch(0, ShapeConfig("t", "train", 16, 4), ex,
                                   kind="train")
            with fsdp.gathered_forward():
                loss, _ = fns.loss(model, batch, ex)
    saved = params = 0
    for t, out in packed:
        owner = gathered.get(StorageWeakRef(t.untyped_storage()))
        if owner is None:
            assert not isinstance(out, fsdp._Saved)
        else:
            assert isinstance(out, fsdp._Saved) and out.param is owner
            params += 1
        saved += 1
    assert params >= cfg.n_layers * 7 and saved > params


# ---------------------------------------------------------------------------
# tiny sharded steps on a fake (4, 2) mesh
# ---------------------------------------------------------------------------
# fields that are times, not counts
TIMES = ("lower_s", "compile_s")


def _tiny_record(arch, kind="train", mesh=(4, 2), remat="full", cfg=None):
    """One step's record, 8 x 32 tokens, on a fake 8-rank ``mesh``: (4,
    2) ("data", "model") or (2, 2, 2) ("pod", "data", "model")."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = cfg or get_config(arch).reduced()
    shape = ShapeConfig("tiny", kind, 32, 8)
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                      "model")
    with dryrun.fake_group(8):
        return dryrun.measure(cfg, shape, init_device_mesh(
            "cpu", mesh, mesh_dim_names=names), "cpu", remat=remat)


@pytest.mark.parametrize("arch,moe_impl", [("tinyllama_1_1b", None),
                                           ("qwen3_moe_235b_a22b", "a2a")])
def test_tiny_step_s_wire_bytes_are_the_spec_sums(arch, moe_impl):
    """One train step of a tiny dense model and a tiny MoE over the
    all-to-all, 8 x 32 tokens on a (4, 2) mesh: the traced all-gather and
    reduce-scatter bytes equal ``spec_wire_bytes`` (from ``param_specs``)
    exactly; no kernel launches; a second run gives the same record."""
    rec = _tiny_record(arch)
    assert rec["moe_impl"] == moe_impl
    spec = rec["spec_wire_bytes"]
    want = dryrun.spec_wire_bytes(get_config(arch).reduced(),
                                  ShapeConfig("tiny", "train", 32, 8),
                                  {"data": 4, "model": 2},
                                  a2a=moe_impl == "a2a")
    assert spec == want
    for kind in ("all-gather", "reduce-scatter"):
        assert rec["coll_breakdown"][kind] == spec[kind]
    if moe_impl:
        assert spec["detail"]["a2a_activation_gathers"] > 0
        assert rec["coll_counts"]["all-to-all"] > 0
        assert rec["kernel_calls"]["moe_gmm_dw"] > 0
    assert not any(rec["launches"].values())
    assert rec["hlo_flops_per_device"] == \
        rec["torch_flops_per_device"] + rec["kernel_flops_per_device"]
    assert rec["mem_temp_bytes"] > 0 and rec["mem_argument_bytes"] > 0
    again = _tiny_record(arch)
    assert {k: v for k, v in rec.items() if k not in TIMES} == \
        {k: v for k, v in again.items() if k not in TIMES}


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "tinyllama_1_1b"])
def test_two_pod_gradients_reduce_scatter_as_the_specs_say(arch):
    """On a (2, 2, 2) ("pod", "data", "model") mesh the traced
    reduce-scatter and all-gather equal ``spec_wire_bytes`` exactly and
    the (4, 2) mesh's: an expert's gradient (kept ``model`` shard, dim
    over pod and data) is one reduce-scatter over the four data ranks,
    not a reduce-scatter over one axis and an all-reduce over the other
    (183040 B of reduce-scatter and 52795 of all-reduce before); the
    all-reduce stays within 1.5x the (4, 2) mesh's."""
    one = _tiny_record(arch)
    two = _tiny_record(arch, mesh=(2, 2, 2))
    spec = two["spec_wire_bytes"]
    assert spec == one["spec_wire_bytes"]
    for kind in ("all-gather", "reduce-scatter"):
        assert two["coll_breakdown"][kind] == spec[kind] == \
            one["coll_breakdown"][kind]
    assert two["coll_breakdown"]["all-reduce"] <= \
        1.5 * one["coll_breakdown"]["all-reduce"]


# the kernel calls "full" adds to a step: each layer's forward once more
# (2 layers; Qwen3-MoE's norms are ln1, ln2 and the q and k norms, its
# experts 3 gmm calls; the gmm's dw is the backward's, not recomputed)
RECOMPUTED = {"tinyllama_1_1b": {"flash_attention_fwd": 2, "rmsnorm": 4},
              "qwen3_moe_235b_a22b": {"flash_attention_fwd": 2,
                                      "rmsnorm": 8, "moe_gmm": 6,
                                      "moe_gmm_dw": 0}}


@pytest.mark.parametrize("arch", list(RECOMPUTED))
def test_full_remat_recomputes_each_layer_once(arch):
    """Under "full" (the dry run's default) each layer's kernels run once
    more, the all-gather and reduce-scatter still equal the spec sums
    (the second gather of a layer's parameter is its recompute's), the
    all-to-all's forward dispatch runs again, the FLOPs rise and the
    peak falls below "none"'s."""
    none = _tiny_record(arch, remat="none")
    full = _tiny_record(arch)
    assert (none["remat"], full["remat"]) == ("none", "full")
    assert {k: n - none["kernel_calls"][k]
            for k, n in full["kernel_calls"].items()} == RECOMPUTED[arch]
    for kind in ("all-gather", "reduce-scatter"):
        assert full["coll_breakdown"][kind] == none["coll_breakdown"][kind] \
            == full["spec_wire_bytes"][kind]
    if "moe_gmm" in full["kernel_calls"]:
        assert full["coll_breakdown"]["all-to-all"] > \
            none["coll_breakdown"]["all-to-all"]
    assert full["hlo_flops_per_device"] > none["hlo_flops_per_device"]
    assert full["mem_peak_bytes"] < none["mem_peak_bytes"]
    # what holds each peak: the live storages by the op that made them
    for rec in (none, full):
        assert sum(rec["mem_peak_by_op"].values()) == rec["mem_peak_bytes"]
        top = [n for *_, n in rec["mem_peak_top"]]
        assert top == sorted(top, reverse=True) and sum(top) <= \
            rec["mem_peak_bytes"]


def test_the_record_does_not_follow_the_cyclic_collector(monkeypatch):
    """A step's record under remat "full" is the same whether Python's
    cyclic collector runs every 100 ops or never inside the trace: no
    reference cycle holds a traced tensor (a module tracker's hooks, or
    the first checkpoint's import of torch._dynamo, would), so the live
    storages' peak does not move with the collector's timing, which
    differs between fake CUDA and fake CPU tensors."""
    import gc

    from torch.utils._python_dispatch import TorchDispatchMode

    class Collecting(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Collecting.ops += 1
            if Collecting.ops % 100 == 0:
                gc.collect()
            return func(*args, **(kwargs or {}))

    trace = hlo.collectives_from_trace

    def collecting_trace():
        @contextlib.contextmanager
        def both():
            with trace() as mode, Collecting():
                yield mode
        return both()
    monkeypatch.setattr(hlo, "collectives_from_trace", collecting_trace)
    often = _tiny_record("tinyllama_1_1b")
    monkeypatch.setattr(hlo, "collectives_from_trace", trace)
    gc.disable()
    try:
        never = _tiny_record("tinyllama_1_1b")
    finally:
        gc.enable()
    assert Collecting.ops > 1000
    assert {k: v for k, v in often.items() if k not in TIMES} == \
        {k: v for k, v in never.items() if k not in TIMES}


def test_zamba2_s_leftover_layers_are_not_recomputed():
    """Zamba2 at 5 layers, period 2: two periods (2 SSM layers and the
    shared block each) run under remat, the fifth layer without it, so
    "full" adds 4 SSD scans (not 5) and 2 flash calls."""
    import dataclasses
    cfg = dataclasses.replace(get_config("zamba2_7b").reduced(), n_layers=5)
    assert (cfg.hybrid_period, cfg.n_layers % cfg.hybrid_period) == (2, 1)
    none = _tiny_record("zamba2_7b", remat="none", cfg=cfg)
    full = _tiny_record("zamba2_7b", cfg=cfg)
    assert none["kernel_calls"]["ssd_scan"] == 5
    assert full["kernel_calls"]["ssd_scan"] == 5 + 4
    assert full["kernel_calls"]["flash_attention_fwd"] == \
        none["kernel_calls"]["flash_attention_fwd"] + 2


@pytest.mark.parametrize("arch,kind", [("zamba2_7b", "train"),
                                       ("mamba2_780m", "train"),
                                       ("llava_next_34b", "train"),
                                       ("whisper_medium", "train"),
                                       ("whisper_medium", "prefill"),
                                       ("whisper_medium", "decode"),
                                       ("zamba2_7b", "prefill"),
                                       ("zamba2_7b", "decode"),
                                       ("mixtral_8x7b", "decode")])
def test_tiny_cells_of_every_family_trace(arch, kind):
    """The other families' steps trace on the fake mesh: work counted,
    no kernel launched."""
    rec = _tiny_record(arch, kind)
    assert rec["hlo_flops_per_device"] > 0 and rec["hlo_bytes_per_device"]
    assert rec["coll_wire_bytes_per_device"] > 0
    assert not any(rec["launches"].values())


def test_a_default_group_is_refused():
    with dryrun.fake_group(8):
        with pytest.raises(RuntimeError, match="already has a default"):
            with dryrun.fake_group(8):
                pass


# ---------------------------------------------------------------------------
# the CLI and the reference's record
# ---------------------------------------------------------------------------
def _reference_record_keys():
    """The keys of ``rec`` in the reference's ``run_cell``, read from its
    source (importing it sets ``XLA_FLAGS``)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    recs = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and getattr(n.targets[0], "id", None) == "rec"
            and isinstance(n.value, ast.Dict)]
    return {k.value for k in max(recs, key=lambda d: len(d.keys)).keys}


def test_records_hold_the_reference_s_keys():
    rec = _tiny_record("tinyllama_1_1b")
    missing = _reference_record_keys() - set(rec) - {"arch", "shape",
                                                     "mesh"}
    assert not missing


def test_cli_writes_skipped_cells(tmp_path):
    """Mixtral's 8 experts do not divide the model axis of 16, so its
    train cells are skipped with the reason; long_500k is inapplicable
    to full attention, and at batch 1 the other archs' KV caches would
    be split over the sequence.  The records are written and the run
    exits 0."""
    out = tmp_path / "dry"
    runs = [("mixtral_8x7b", "train_4k", "dense MoE dispatch"),
            ("tinyllama_1_1b", "long_500k", "inapplicable"),
            ("gemma2_2b", "long_500k", "cross-rank softmax")]
    for arch, shape, _ in runs:
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "both", "--device", "cpu",
             "--out", str(out)], capture_output=True, text=True,
            timeout=240, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        assert p.returncode == 0, p.stdout + p.stderr
        assert "ALL CELLS OK" in p.stdout
    for arch, shape, reason in runs:
        for mesh in ("single", "multi"):
            rec = json.loads((out / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            assert rec["skipped"] and reason in rec["reason"]
