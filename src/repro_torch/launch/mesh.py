"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the default process
group, which the caller has initialised (``launch/train.py::main``);
the device type follows the caller's device: ``"cuda"`` with NCCL,
``"cpu"`` with gloo.
"""
from __future__ import annotations

import math

import torch


def _mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} devices, have {have} — run "
            f"under torchrun --nproc-per-node {need}")
    if have != need:
        raise RuntimeError(f"mesh {tuple(shape)} needs a world of {need} "
                           f"ranks, the process group has {have}")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def fsdp_axes(mesh) -> tuple:
    """Axes carrying the batch / FSDP dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def make_mesh_from_plan(tp: int, dp: int, *, pod: int = 1, device="cuda"):
    """Build a mesh realising a ChipLight ``ParallelPlan``'s TP x DP grid
    (EP/CP ride the data axis, see parallel/plan.py)."""
    if pod > 1:
        return _mesh((pod, dp, tp), ("pod", "data", "model"), device)
    return _mesh((dp, tp), ("data", "model"), device)
