"""Rank workers for the port's multi-process tests on the CPU
(``test_torch_moe_a2a.py``, ``test_torch_shard_train.py``): each test
spawns ``world`` processes that join one gloo group through a file store
in the test's temporary directory (no port, so parallel test workers
never clash), run one function of this module and save its result.
Nothing here imports jax, so a rank starts in the time torch takes.

``run_ranks`` joins the ranks against one deadline and kills them when it
passes, so a collective that hangs fails its test instead of the suite.
"""
from __future__ import annotations

import importlib
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 120.0


def run_ranks(fn, world: int, tmp_path, timeout: float = RANK_TIMEOUT_S,
              **kw) -> list:
    """``fn(rank, world, **kw)`` on ``world`` spawned gloo ranks -> their
    results in rank order; raises with a rank's traceback if one failed,
    and kills them all past ``timeout`` seconds."""
    tmp = Path(tmp_path)
    store = tmp / f"store_{fn.__name__}_{world}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn.__module__, fn.__name__, r, world,
                               str(store), str(tmp), kw))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"rank{r}.err") for r in range(world)]
    failed = [e.read_text() for e in errors if e.exists()]
    if failed:
        raise RuntimeError("a rank failed:\n" + failed[0])
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after "
                           f"{timeout} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(module, name, rank, world, store, out, kw):
    out = Path(out)
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        fn = getattr(importlib.import_module(module), name)
        torch.save(fn(rank, world, **kw), out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# The all-to-all MoE
# ---------------------------------------------------------------------------
class _Linear:
    def __init__(self, w):
        self.weight = w


class _MoE:
    """The attributes ``moe_apply_a2a`` reads of ``models.moe.MoE``."""

    def __init__(self, router, w1, w3, w2):
        self.router = _Linear(router)
        self.w1, self.w3, self.w2 = w1, w3, w2


def a2a_case(rank, world, *, mesh_shape, inputs, arch, capacity_factor):
    """The port's ``moe_apply_a2a`` on this rank's tile of the inputs
    (npz: x (B, S, D), dy (B, S, D), router (D, E) in the reference's
    layout, w1, w3 (E, D, F), w2 (E, F, D)), and its gradients of
    ``data * sum(y * dy) + aux``: summed over the data ranks this is the
    reference's ``sum(y * dy) + aux`` (the data ranks hold their own
    losses, averaged at the parameters).  -> this rank's y, aux, x's
    gradient / data, and the router's and its experts' gradients
    averaged over data."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.parallel.moe_a2a import moe_apply_a2a
    from repro_torch.parallel.sharding import local_slice
    mesh = _mesh(mesh_shape)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = {a: mesh.get_local_rank(a) for a in sizes}
    m = dataclasses.replace(get_config(arch).reduced().moe,
                            capacity_factor=capacity_factor)
    arr = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    x = local_slice(arr["x"], ("data", None, None), sizes, coords)
    dy = local_slice(arr["dy"], ("data", None, None), sizes, coords)
    ws = {k: local_slice(arr[k], ("model", None, None), sizes, coords)
          for k in ("w1", "w3", "w2")}
    x = x.clone().requires_grad_()
    router = arr["router"].T.contiguous().requires_grad_()
    ws = {k: v.clone().requires_grad_() for k, v in ws.items()}
    moe = _MoE(router, ws["w1"], ws["w3"], ws["w2"])
    y, aux = moe_apply_a2a(moe, x, m, None, mesh)
    (sizes["data"] * torch.sum(y * dy) + aux).backward()
    data = mesh.get_group("data")

    def data_mean(g):
        g = g.clone()
        dist.all_reduce(g, group=data)
        return g / sizes["data"]

    return {"coords": coords, "y": y.detach(), "aux": aux.detach(),
            "dx": x.grad / sizes["data"],
            "drouter": data_mean(router.grad).T,
            **{f"d{k}": data_mean(v.grad) for k, v in ws.items()}}


# ---------------------------------------------------------------------------
# The sharded trainer
# ---------------------------------------------------------------------------
def _port_state(arch, state_path, ex):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import TrainState
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    cfg = get_config(arch).reduced()
    model = build_model(cfg).init(0, ex)
    model.load_state_dict(torch.load(state_path))
    return cfg, TrainState(model=model,
                           opt=adamw_init(dict(model.named_parameters())))


def _check_placement(cfg, state, mesh) -> list:
    """Names whose local shard (parameter, m, v) is not exactly the
    spec's slice of the full tensor."""
    from repro_torch.parallel.sharding import local_slice, param_specs
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = {a: mesh.get_local_rank(a) for a in sizes}
    specs = param_specs(cfg, state.model, mesh)
    bad = []
    trees = {"param": dict(state.model.named_parameters()),
             "m": state.opt.m, "v": state.opt.v}
    for kind, tree in trees.items():
        for n, t in tree.items():
            full = t.detach().full_tensor()
            want = local_slice(full, specs[n], sizes, coords)
            if not torch.equal(t.detach().to_local(), want):
                bad.append(f"{kind}/{n}")
    return bad


def train_case(rank, world, *, mesh_shape, arch, state_path, batches,
               steps, moe_impl, lr, remat="none"):
    """``steps`` steps of ``build_sharded_train`` (under ``remat``) from
    the state at ``state_path`` on the global batches (npz) -> losses,
    the full parameters after them and the last step's full gradients
    (rank 0), the placement faults before and after the steps, and the
    shapes of this rank's local shards."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.models import ExecConfig
    mesh = _mesh(mesh_shape)
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu",
                    moe_impl=moe_impl, remat=remat)
    cfg, state = _port_state(arch, state_path, ex)
    data = np.load(batches)
    b, s = data["tokens"].shape[1:]
    step_fn, place = build_sharded_train(cfg, ex, mesh,
                                         ShapeConfig("t", "train", s, b),
                                         **lr)
    state = place(state)
    placed = _check_placement(cfg, state, mesh)
    local_numel = sum(p.to_local().numel()
                      for p in state.model.parameters())
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(data[k][i]) for k in data.files}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    after = _check_placement(cfg, state, mesh)
    full = {n: p.detach().full_tensor()
            for n, p in state.model.named_parameters()}
    grads = {n: p.grad.full_tensor()
             for n, p in state.model.named_parameters()}
    return {"losses": losses, "placement_faults": placed + after,
            "local_numel": local_numel,
            "params": full if rank == 0 else None,
            "grads": grads if rank == 0 else None}


def two_pod_grads_case(rank, world, *, arch, state_path, batches):
    """One sharded gradient step of the all-to-all MoE on a (2, 2, 2)
    ("pod", "data", "model") mesh, the state placed twice: its gradients
    reduced over the flattened (pod, data) view (``fsdp._flat_view``) and
    by DTensor's plan on the three-axis mesh -> on rank 0, the full
    gradients of each ({"flat": ..., "axes": ...}) and the losses."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.models import ExecConfig
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import batch_specs, local_slice
    mesh = _mesh((2, 2, 2))
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu",
                    moe_impl="a2a")
    data = np.load(batches)
    b, s = data["tokens"].shape[1:]
    shape = ShapeConfig("t", "train", s, b)
    spec_for = batch_specs(get_config(arch).reduced(), shape, mesh,
                           kind="train")
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    batch = {k: local_slice(torch.from_numpy(data[k][0]), spec_for(k),
                            mesh, coords) for k in data.files}
    out = {}
    flat_view = fsdp._flat_view
    for plan in ("flat", "axes"):
        fsdp._flat_view = flat_view if plan == "flat" else (lambda m: m)
        cfg, state = _port_state(arch, state_path, ex)
        _, place = build_sharded_train(cfg, ex, mesh, shape)
        state = place(state)
        fsdp._flat_view = flat_view
        grad_step = make_grad_step(cfg, dataclasses.replace(ex, mesh=mesh))
        with fsdp.gathered_forward():
            loss, _ = grad_step(state.model, batch)
        grads = {n: p.grad.full_tensor()
                 for n, p in state.model.named_parameters()}
        out[plan] = {"loss": float(loss), "grads": grads}
    return out if rank == 0 else None


def checkpoint_case(rank, world, *, mesh_shape, tmp, arch, state_path):
    """A sharded state saved by ``CheckpointManager`` and restored into
    a second sharded state of other values -> this rank's ``last_save``
    and the names whose local shard (parameter, m, v) differs from the
    saved state's after the restore."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.models import ExecConfig
    mesh = _mesh(mesh_shape)
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
    cfg, state = _port_state(arch, state_path, ex)
    _, place = build_sharded_train(cfg, ex, mesh,
                                   ShapeConfig("t", "train", 16, 4))
    state = place(state)
    with torch.no_grad():
        for i, t in enumerate(list(state.opt.m.values())
                              + list(state.opt.v.values())):
            t.to_local().fill_(0.5 + i)
    cfg, other = _port_state(arch, state_path, ex)
    other = place(other)
    with torch.no_grad():
        for p in other.model.parameters():
            p.to_local().zero_()
    ckpt = CheckpointManager(Path(tmp) / "ckpt", async_write=False)
    ckpt.save(7, state)
    restored, _ = ckpt.restore(7, other)
    trees = [("param", dict(state.model.named_parameters()),
              dict(restored.model.named_parameters())),
             ("m", state.opt.m, restored.opt.m),
             ("v", state.opt.v, restored.opt.v)]
    wrong = [f"{kind}/{n}" for kind, want, got in trees for n in want
             if not torch.equal(want[n].to_local(), got[n].to_local())]
    return {"last_save": dict(ckpt.last_save), "wrong": wrong,
            "numel": sum(t.numel() for t in state.opt.m.values())}


def wait_case(rank, world, *, tmp):
    """Rank 0 writes a checkpoint slowly in the background; every rank
    then calls ``wait`` -> the latest committed step each rank sees
    right after it."""
    from repro_torch.checkpoint import manager
    write = manager._write

    def slow_write(leaves, path):
        time.sleep(1.0)
        write(leaves, path)
    manager._write = slow_write
    ckpt = manager.CheckpointManager(Path(tmp) / "ckpt")
    ckpt.save(3, {"w": torch.ones(4)})
    ckpt.wait()
    return {"latest": ckpt.latest_step()}


def resume_case(rank, world, *, tmp, arch):
    """``launch.train.main`` on this group: 4 steps straight with a
    checkpoint every 2; then 2 steps and a resume to 4 in another
    directory -> the histories and, on rank 0, whether both step-4
    checkpoints hold the same bytes."""
    from repro_torch.checkpoint.manager import _load_arrays
    from repro_torch.launch.train import main
    common = ["--arch", arch, "--reduced", "--device", "cpu", "--batch",
              "4", "--seq", "16", "--ckpt-every", "2"]
    a, b = Path(tmp) / "a", Path(tmp) / "b"
    straight = main(common + ["--steps", "4", "--ckpt-dir", str(a)])
    first = main(common + ["--steps", "2", "--ckpt-dir", str(b)])
    resumed = main(common + ["--steps", "4", "--resume", "--ckpt-dir",
                             str(b)])
    same = None
    if rank == 0:
        ca = _load_arrays(a / "step_00000004")
        cb = _load_arrays(b / "step_00000004")
        same = [n for n, _, _ in ca] == [n for n, _, _ in cb] and all(
            x.dtype == y.dtype and x.tobytes() == y.tobytes()
            for (_, x, _), (_, y, _) in zip(ca, cb))
    return {"straight": straight, "first": first, "resumed": resumed,
            "same_checkpoint": same}


def freed_case(rank, world, *, arch, state_path, batches):
    """One sharded forward on a (world, 1) mesh, then its backward ->
    how many storages of gathered copies the forward registered, how many
    of those copies are alive between the two (the graph saves each as
    its parameter), and whether every parameter got a gradient."""
    import gc
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import build_sharded_train
    from repro_torch.models import ExecConfig, build_model
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import local_slice
    mesh = _mesh((world, 1))
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
    cfg, state = _port_state(arch, state_path, ex)
    data = np.load(batches)
    b, s = data["tokens"].shape[1:]
    _, place = build_sharded_train(cfg, ex, mesh,
                                   ShapeConfig("t", "train", s, b))
    state = place(state)
    coords = {"data": mesh.get_local_rank("data"), "model": 0}
    batch = {k: local_slice(torch.from_numpy(data[k][0]), ("data", None),
                            {"data": world, "model": 1}, coords)
             for k in data.files}
    with fsdp.gathered_forward():
        live = fsdp._SCOPE.get()
        loss, _ = build_model(cfg).loss(state.model, batch, ex)
        gc.collect()
        alive = sum(ref() is not None for ref, _ in live.values())
        gathered = len(live)
        loss.backward()
    return {"gathered": gathered, "alive": alive,
            "grads": all(p.grad is not None
                         for p in state.model.parameters())}
