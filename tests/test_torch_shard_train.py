"""The port's sharded trainer (``launch/train.py::build_sharded_train``)
on gloo ranks on the CPU, against the port's unsharded
``make_train_step`` and, through ``convert.params_from_jax``, the
reference's unsharded ``make_train_step``.

The reference's own sharded step does not run on this jax (ROADMAP C3),
so its unsharded step is the oracle; with ``moe_impl="a2a"`` it runs
``moe_apply_a2a`` on four host devices in a subprocess, which is the
function the port's sharded Mixtral step computes (the aux loss and the
capacity of each (data, model) tile).  The port's unsharded step routes
over the whole batch, so for the a2a it is no oracle.

Reduced TinyLlama at (2, 1) and (4, 1), Mamba2 at (1, 2) and Mixtral's
a2a at (2, 2), batch 8 x 16, 3 steps at base lr 5e-3, float32 on both
sides with sums in other orders: each loss within 1e-5 relative, every
parameter within 1e-5 relative L2 (``REL_L2``).  Each rank's local shard
of every parameter, m and v is exactly its spec's slice of the full
tensor, before and after the steps.  Under ``remat="full"`` the (1, 2)
step's gradients are the unsharded step's bit for bit, and the a2a's
steps the "none" ones'.  On a (2, 2, 2) ("pod", "data", "model") mesh
the experts' gradients reduced over the flattened (pod, data) group
equal DTensor's plan over the two axes.  A crash-restore at (2, 1) through
``launch.train.main`` is bit for bit; a checkpoint of a sharded state is
copied to the host by rank 0 alone and restores every rank's shards
exactly.  Every multi-process case joins its
ranks against a deadline (``tests/_torch_ranks.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import (checkpoint_case, freed_case, resume_case,
                          run_ranks, train_case, two_pod_grads_case,
                          wait_case)
from repro.configs import get_config as jax_get_config
from repro.launch.steps import init_train_state as jax_init_train_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_grad_step, make_train_step)
from repro_torch.models import ExecConfig
from repro_torch.optim import adamw_init

BATCH, SEQ, STEPS = 8, 16, 3
LOSS_RTOL = 1e-5
REL_L2 = 1e-5
LR = dict(base_lr=5e-3, warmup=5, total=120)
JEX = JaxExecConfig(backend="xla", attn_block=16, ssd_chunk=8)
EX = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
ROOT = Path(__file__).resolve().parents[1]
XLA_QUICK = {"xla_backend_optimization_level": 0}


def _jax_name(arch):
    return arch.replace("-", "_").replace(".", "_")


def _batches(arch):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(11)
    return {k: rng.integers(0, cfg.vocab, (STEPS, BATCH, SEQ)).astype(
        np.int64) for k in ("tokens", "labels")}


@lru_cache(maxsize=None)
def _initial(arch):
    """The reference's seeded init, as the port's state dict."""
    cfg = jax_get_config(_jax_name(arch)).reduced()
    state = jax_init_train_state(cfg, JEX, seed=0)
    return {k: v.float() for k, v in
            params_from_jax(jax.device_get(state.params),
                            get_config(arch).reduced()).items()}


@lru_cache(maxsize=None)
def _reference(arch):
    """The reference's unsharded step, 3 steps -> (losses, the port's
    state dict of its parameters)."""
    cfg = jax_get_config(_jax_name(arch)).reduced()
    state = jax_init_train_state(cfg, JEX, seed=0)
    step = jax_make_train_step(cfg, JEX, **LR)
    batches = _batches(arch)
    losses = []
    for i in range(STEPS):
        batch = {k: jax.numpy.asarray(v[i], jax.numpy.int32)
                 for k, v in batches.items()}
        if i == 0:
            step = jax.jit(step).lower(state, batch).compile(
                compiler_options=XLA_QUICK)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, params_from_jax(jax.device_get(state.params),
                                   get_config(arch).reduced())


_REFERENCE_A2A = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch.steps import init_train_state, make_train_step
from repro.models.common import ExecConfig

arg = json.loads(sys.argv[1])
cfg = get_config(arg["arch"]).reduced()
shape = tuple(arg["mesh"])
n = int(np.prod(shape))
mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
ex = ExecConfig(backend="xla", attn_block=16, ssd_chunk=8, moe_impl="a2a",
                mesh=mesh)
state = init_train_state(cfg, ex, seed=0)
step = jax.jit(make_train_step(cfg, ex, **arg["lr"]))
data = np.load(arg["batches"])
losses = []
for i in range(data["tokens"].shape[0]):
    batch = {k: jax.numpy.asarray(data[k][i], jax.numpy.int32)
             for k in data.files}
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))
flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))[0]
np.savez(arg["out"], **{"/".join(str(getattr(k, "key", k)) for k in p):
                        np.asarray(v) for p, v in flat})
print(json.dumps(losses))
"""


def _reference_a2a(arch, mesh, batches, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps({"arch": _jax_name(arch), "mesh": list(mesh),
                      "lr": LR, "batches": str(batches), "out": str(out)})
    run = subprocess.run([sys.executable, "-c", _REFERENCE_A2A, arg],
                         env=env, check=True, timeout=300,
                         capture_output=True, text=True)
    losses = json.loads(run.stdout.strip().splitlines()[-1])
    tree = {}
    for key, v in np.load(out).items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return losses, params_from_jax(tree, get_config(arch).reduced())


def _port_unsharded(arch, remat="none"):
    cfg = get_config(arch).reduced()
    ex = dataclasses.replace(EX, remat=remat)
    state = init_train_state(cfg, ex, 0)
    state.model.load_state_dict(_initial(arch))
    state = TrainState(model=state.model,
                       opt=adamw_init(dict(state.model.named_parameters())))
    step = make_train_step(cfg, ex, **LR)
    batches = _batches(arch)
    losses = []
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v[i])
                                for k, v in batches.items()})
        losses.append(float(m["loss"]))
    return losses, {n: p.detach() for n, p in
                    state.model.named_parameters()}


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want)
                 / max(float(torch.linalg.norm(want)), 1e-30))


def _sharded(arch, mesh, tmp_path, moe_impl, remat="none"):
    torch.save(_initial(arch), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **_batches(arch))
    results = run_ranks(train_case, int(np.prod(mesh)), tmp_path,
                        mesh_shape=mesh, arch=arch,
                        state_path=str(tmp_path / "state.pt"),
                        batches=str(tmp_path / "batches.npz"), steps=STEPS,
                        moe_impl=moe_impl, lr=LR, remat=remat)
    for r in results:
        assert r["placement_faults"] == []
        assert r["losses"] == results[0]["losses"]
    total = sum(t.numel() for t in _initial(arch).values())
    # the state really is sharded: norms and scalars stay whole
    assert max(r["local_numel"] for r in results) \
        < 0.6 * total * 2 / int(np.prod(mesh))
    return results[0]["losses"], results[0]["params"]


def _compare(losses, params, want_losses, want_params, what):
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL,
                               err_msg=what)
    assert set(params) == set(want_params)
    errs = {n: _rel_l2(params[n], want_params[n]) for n in params}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= REL_L2, f"{what}: {worst} {errs[worst]:.3g}"


@pytest.mark.parametrize("arch,mesh", [
    ("tinyllama-1.1b", (2, 1)), ("tinyllama-1.1b", (4, 1)),
    # a model axis: Mamba2's packed in_proj (z, x, B, C, dt) is stored
    # sharded over it and computed gathered, as every dense block
    ("mamba2-780m", (1, 2))], ids=lambda v: v if isinstance(v, str)
    else f"{v[0]}x{v[1]}")
def test_sharded_dense_step_matches_unsharded(arch, mesh, tmp_path):
    losses, params = _sharded(arch, mesh, tmp_path, "dense")
    _compare(losses, params, *_port_unsharded(arch), "port unsharded")
    _compare(losses, params, *_reference(arch), "reference unsharded")


def test_sharded_a2a_moe_step_matches_reference(tmp_path):
    arch, mesh = "mixtral-8x7b", (2, 2)
    losses, params = _sharded(arch, mesh, tmp_path, "a2a")
    want = _reference_a2a(arch, mesh, tmp_path / "batches.npz",
                          tmp_path / "ref.npz")
    _compare(losses, params, *want, "reference unsharded, a2a")


def test_sharded_full_remat_is_bit_for_bit_the_unsharded_one(tmp_path):
    """Under ``remat="full"`` on a (1, 2) mesh (the model ranks compute
    the whole batch alike, and the average of two equal gradients is
    exact) the sharded step's loss and every gradient are the unsharded
    step's bit for bit: the recompute's gathers hand the layer bodies the
    same parameters as their forward.  (The clipping norm sums the
    shards' squares in another order, so the updates differ in the last
    bits.)"""
    arch = "tinyllama-1.1b"
    torch.save(_initial(arch), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **_batches(arch))
    got = run_ranks(train_case, 2, tmp_path, mesh_shape=(1, 2), arch=arch,
                    state_path=str(tmp_path / "state.pt"),
                    batches=str(tmp_path / "batches.npz"), steps=1,
                    moe_impl="dense", lr=LR, remat="full")[0]
    cfg = get_config(arch).reduced()
    ex = dataclasses.replace(EX, remat="full")
    state = init_train_state(cfg, ex, 0)
    state.model.load_state_dict(_initial(arch))
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(arch).items()}
    loss, _ = make_grad_step(cfg, ex)(state.model, batch)
    assert got["losses"] == [float(loss)]
    want = dict(state.model.named_parameters())
    assert set(got["grads"]) == set(want)
    for name, g in got["grads"].items():
        assert torch.equal(g, want[name].grad), name


def test_sharded_a2a_moe_under_full_remat_is_the_plain_step(tmp_path):
    """The all-to-all MoE on a (2, 2) mesh under ``remat="full"``: the
    recompute runs the dispatch's all-to-alls and the experts' gmm again
    in the backward, on every rank in the same order; the losses and
    parameters are the "none" steps' bit for bit."""
    arch, mesh = "mixtral-8x7b", (2, 2)
    for d in ("none", "full"):
        (tmp_path / d).mkdir()
    losses, params = _sharded(arch, mesh, tmp_path / "none", "a2a")
    r_losses, r_params = _sharded(arch, mesh, tmp_path / "full", "a2a",
                                  "full")
    assert r_losses == losses
    for name, p in params.items():
        assert torch.equal(r_params[name], p), name


def test_two_pod_expert_gradients_equal_dtensor_s_plan(tmp_path):
    """On a (2, 2, 2) ("pod", "data", "model") mesh the all-to-all MoE's
    gradients reduced over the flattened (pod, data) view, one
    reduce-scatter a parameter, are those of DTensor's plan axis by axis
    (a reduce-scatter and an all-reduce for an expert), within the
    rounding of four float32 terms summed in another order."""
    arch = "qwen3-moe-235b-a22b"
    torch.save(_initial(arch), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **_batches(arch))
    got = run_ranks(two_pod_grads_case, 8, tmp_path, arch=arch,
                    state_path=str(tmp_path / "state.pt"),
                    batches=str(tmp_path / "batches.npz"))[0]
    flat, axes = got["flat"], got["axes"]
    assert flat["loss"] == axes["loss"]
    assert set(flat["grads"]) == set(axes["grads"])
    for name, g in flat["grads"].items():
        assert _rel_l2(g, axes["grads"][name]) <= 1e-6, name


def test_dense_moe_over_data_ranks_is_refused(tmp_path):
    """The dense dispatch routes each rank's shard on its own, which is
    not the reference's global capacity and aux: past one data rank a MoE
    trains over the all-to-all."""
    torch.save(_initial("mixtral-8x7b"), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **_batches("mixtral-8x7b"))
    with pytest.raises(RuntimeError, match="moe_impl"):
        run_ranks(train_case, 2, tmp_path, mesh_shape=(2, 1),
                  arch="mixtral-8x7b", state_path=str(tmp_path / "state.pt"),
                  batches=str(tmp_path / "batches.npz"), steps=1,
                  moe_impl="dense", lr=LR)


def test_gathered_parameters_are_freed_after_their_ops(tmp_path):
    """Between a sharded forward and its backward no gathered copy of a
    parameter is alive: the graph holds each as its parameter and the
    backward gathers it again."""
    arch = "tinyllama-1.1b"
    torch.save(_initial(arch), tmp_path / "state.pt")
    np.savez(tmp_path / "batches.npz", **_batches(arch))
    for r in run_ranks(freed_case, 2, tmp_path, arch=arch,
                       state_path=str(tmp_path / "state.pt"),
                       batches=str(tmp_path / "batches.npz")):
        # freed storages are reused, so ``gathered`` counts addresses
        assert r["gathered"] > 0 and r["alive"] == 0
        assert r["grads"]


def test_sharded_resume_is_bit_for_bit(tmp_path):
    res = run_ranks(resume_case, 2, tmp_path, tmp=str(tmp_path),
                    arch="tinyllama-1.1b")
    for r in res:
        assert [h["step"] for h in r["first"]] == [0, 1]
        assert [h["step"] for h in r["resumed"]] == [2, 3]
        assert [h["loss"] for h in r["first"] + r["resumed"]] == \
            [h["loss"] for h in r["straight"]]
    assert res[0]["same_checkpoint"] is True


@pytest.mark.parametrize("arch,mesh", [
    ("tinyllama-1.1b", (2, 1)), ("mamba2-780m", (1, 2))],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_sharded_checkpoint_is_written_by_rank_0_alone(arch, mesh,
                                                      tmp_path):
    """Only rank 0 copies the gathered state to the host; every rank's
    shards come back exactly from the full tensors on disk."""
    torch.save(_initial(arch), tmp_path / "state.pt")
    res = run_ranks(checkpoint_case, 2, tmp_path, mesh_shape=mesh,
                    tmp=str(tmp_path), arch=arch,
                    state_path=str(tmp_path / "state.pt"))
    total = sum(t.numel() for t in _initial(arch).values())
    # the step number (an int64) beside parameters, m and v in float32
    assert res[0]["last_save"]["bytes"] == 3 * 4 * total + 8
    assert res[1]["last_save"]["bytes"] == 0
    for r in res:
        assert r["wrong"] == []
        assert r["last_save"]["step"] == 7


def test_every_rank_waits_for_the_checkpoint_write(tmp_path):
    """Rank 0 alone writes, in the background: ``wait`` holds every rank
    until the write has committed, so a resume on any rank finds it."""
    res = run_ranks(wait_case, 2, tmp_path, tmp=str(tmp_path))
    assert [r["latest"] for r in res] == [3, 3]


def test_kernel_builds_rename_into_place(tmp_path, monkeypatch):
    """Ranks build the kernels together: each process compiles into a file
    of its own and renames it to ``lib<name>.so``, so no rank loads a
    library another is still writing (nvcc and the card stood in for)."""
    import ctypes
    from repro_torch.kernels import _build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel")
    nvcc = tmp_path / "nvcc"
    asked = tmp_path / "asked"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do [ \"$1\" = -o ] && "
                    f"echo \"$2\" > {asked} && echo built > \"$2\"; shift; "
                    "done\n")
    nvcc.chmod(0o755)
    loaded = []
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: loaded.append(path))
    _build.build_all(["k"])
    assert asked.read_text().strip() == str(out / f"libk.{os.getpid()}.so")
    assert sorted(p.name for p in out.iterdir()) == ["libk.so"]
    assert (out / "libk.so").read_text() == "built\n"
    assert loaded == [str(out / "libk.so")]
