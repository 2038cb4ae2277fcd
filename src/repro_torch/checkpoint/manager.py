"""Atomic, asynchronous, retention-managed checkpoints of a training state
(counterpart of ``repro/checkpoint/manager.py``).

Layout per step, the reference's:
  <dir>/step_<N>/manifest.json     — leaf names + shapes + dtypes
  <dir>/step_<N>/arrays.npz        — flat leaves as raw bytes
  <dir>/step_<N>/COMMITTED         — atomic-commit marker

A sharded state's DTensor leaves are written whole: every rank joins
each leaf's gather (a collective), rank 0 alone copies it to the host
and writes, the other ranks drop it at once.  ``restore`` reads one leaf
at a time, cuts each rank's block out of it on the host and copies only
that block to the rank's device.

A tree is any nesting of dicts, lists, tuples and NamedTuples (the port's
``TrainState(model, opt)``: ``AdamWState(step, m, v)``) whose leaves are
tensors, numpy arrays or Python numbers; an ``nn.Module`` stands for its
named parameters.  ``save`` copies every leaf to the host BEFORE it
returns — the port's train step updates the parameters, m and v in place
(``optim.adamw_update_``), so a view would be rewritten under the writer
— then writes on a background thread; the write is atomic through the
COMMITTED marker and a rename, so a crash mid-write leaves the previous
step intact.  ``restore`` copies the loaded leaves INTO the template's
tensors (``copy_``, on their device and in their dtype): the live module
and the live m and v tensors take the checkpoint's values.  A dtype numpy
lacks (bfloat16) travels as ``uint16`` bits, its name in the manifest.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

# torch dtypes numpy has no type for: their bits travel in this numpy type
_BITS = {torch.bfloat16: (np.uint16, torch.uint16)}
_BY_NAME = {str(t).removeprefix("torch."): t for t in _BITS}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` in a fixed order: a module's named parameters,
    a dict's keys, a NamedTuple's fields, a list's indices."""
    if isinstance(tree, torch.nn.Module):
        return [(f"{prefix}{n}", p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.rstrip("/"), tree)]
    out = []
    for k, v in items:
        out += _flatten_with_names(v, f"{prefix}{k}/")
    return out


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    """Every rank of the default process group meets here (none without
    one, or with one rank)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A COPY of ``leaf`` in host memory as numpy, and its dtype's name
    (a DTensor's full tensor, gathered from every rank)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype in _BITS:
            bits = t.view(_BITS[t.dtype][1])
            # .cpu() of a CPU tensor is the tensor itself: clone it
            host = bits.clone() if bits.device.type == "cpu" else bits.cpu()
            return host.numpy().view(_BITS[t.dtype][0]), \
                str(t.dtype).removeprefix("torch.")
        host = t.clone() if t.device.type == "cpu" else t.cpu()
        arr = host.numpy()
    else:
        arr = np.array(leaf)            # a copy, also of a numpy array
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _BY_NAME:
        return torch.from_numpy(arr).view(_BY_NAME[dtype])
    return torch.from_numpy(arr)


def _host_leaves(tree, prefix: str = "", keep: bool = True
                 ) -> List[Tuple[str, np.ndarray, str]]:
    """``[(name, host copy, dtype name)]`` of every leaf of ``tree``;
    with ``keep`` False (a rank that does not write) none, though each
    DTensor leaf is still gathered, the collective every rank joins."""
    out = []
    for name, leaf in _flatten_with_names(tree, prefix):
        if keep:
            out.append((name, *_to_host(leaf)))
        elif isinstance(leaf, DTensor):
            leaf.detach().full_tensor()
    return out


def _write(leaves, path: Path) -> None:
    """Write host leaves to ``path`` atomically: a ``.tmp`` directory,
    COMMITTED last, then a rename."""
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    for i, (_, arr, _) in enumerate(leaves):
        # raw bytes: one layout for every dtype, bfloat16's bits included
        arrays[f"a{i}"] = np.ascontiguousarray(arr).reshape(-1).view(
            np.uint8)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"names": [n for n, _, _ in leaves],
                "shapes": [list(a.shape) for _, a, _ in leaves],
                "dtypes": [d for _, _, d in leaves]}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def save_pytree(tree, path) -> None:
    """Write ``tree`` to ``path`` atomically, synchronously."""
    _write(_host_leaves(tree), Path(path))


@contextmanager
def _open_arrays(path: Path):
    """-> {name: (read, dtype name)} of a committed step, in its order:
    ``read()`` loads that one leaf's numpy array from the file."""
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint {path} not committed")
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        def reader(i, shape, dtype):
            np_dtype = _BITS[_BY_NAME[dtype]][0] if dtype in _BY_NAME \
                else np.dtype(dtype)
            return lambda: data[f"a{i}"].view(np_dtype).reshape(shape)
        yield {name: (reader(i, shape, dtype), dtype)
               for i, (name, shape, dtype) in enumerate(zip(
                   manifest["names"], manifest["shapes"],
                   manifest["dtypes"]))}


def _load_arrays(path: Path):
    """-> ``[(name, numpy array, dtype name)]`` of a committed step."""
    with _open_arrays(path) as leaves:
        return [(name, read(), dtype)
                for name, (read, dtype) in leaves.items()]


def _local_block(arr: np.ndarray, dt) -> np.ndarray:
    """The block of the full array ``arr`` that this rank's DTensor
    ``dt`` holds: each ``Shard(d)`` of its placements an even split of
    dim d over that mesh axis, major first in mesh order."""
    mesh = dt.device_mesh
    for i, plc in enumerate(dt.placements):
        if isinstance(plc, Shard):
            step = arr.shape[plc.dim] // mesh.size(i)
            lo = mesh.get_local_rank(i) * step
            arr = arr[(slice(None),) * plc.dim + (slice(lo, lo + step),)]
    return arr


def _fill(template, values: dict, prefix: str = ""):
    """``template`` with every leaf taken from ``values`` (name -> (read,
    dtype), ``_open_arrays``): tensors are overwritten in place and
    returned, numbers and arrays are replaced."""
    if isinstance(template, torch.nn.Module):
        for n, p in template.named_parameters():
            _fill(p, values, f"{prefix}{n}/")
        return template
    if isinstance(template, dict):
        return {k: _fill(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_fill(v, values, f"{prefix}{k}/")
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, values, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    name = prefix.rstrip("/")
    if name not in values:
        raise KeyError(f"checkpoint has no leaf {name!r}")
    read, dtype = values[name]
    arr = read()
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"shape mismatch at {name}: {arr.shape} vs "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            if isinstance(template, DTensor):
                local = template.to_local()
                block = np.ascontiguousarray(_local_block(arr, template))
                del arr
                local.copy_(_from_host(block, dtype))
            else:
                template.copy_(_from_host(arr, dtype))
        return template
    if isinstance(template, np.ndarray):
        return arr.astype(template.dtype)
    return type(template)(arr.item()) if arr.shape == () else arr


def restore_pytree(template, path):
    """Load the tree at ``path`` into the structure of ``template``: its
    tensors are overwritten in place (``copy_``, on their device and in
    their dtype)."""
    with _open_arrays(Path(path)) as values:
        return _fill(template, values)


class CheckpointManager:
    """Async, atomic, retention-managed checkpointing."""

    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # the latest save's step, bytes, host-copy and write seconds
        self.last_save: dict = {}

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix != ".tmp" and (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def wait(self):
        """Join the write in flight; re-raise its failure here.  In a
        process group every rank calls it and leaves once rank 0's write
        has committed, so every rank then reads the same steps on disk
        (a resume on another rank must not miss the latest)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Copy ``tree`` to host memory NOW, write it in the background
        (or before returning, with ``async_write`` False).  ``last_save``
        holds the step, the bytes, the copy's seconds and, once the write
        has ended, its seconds.  In a process group every rank calls it
        (a DTensor leaf is gathered) and rank 0 alone copies and writes:
        another rank's ``bytes`` are 0."""
        t0 = time.perf_counter()
        keep = _rank() == 0
        leaves = _host_leaves(tree, "state/", keep) \
            + _host_leaves(extra or {}, "extra/", keep)
        info = {"step": step, "bytes": sum(a.nbytes for _, a, _ in leaves),
                "copy_s": time.perf_counter() - t0}

        def write():
            try:
                t1 = time.perf_counter()
                _write(leaves, self._step_dir(step))
                info["write_s"] = time.perf_counter() - t1
                self._gc()
            except Exception as e:      # re-raised by wait()
                self._error = e

        self.wait()
        self.last_save = info
        if keep and self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        elif keep:
            write()
        if not self.async_write:
            self.wait()

    def restore(self, step: int, template: Any):
        """-> (``template`` with the step's state copied into it, the
        ``extra`` dict saved beside it)."""
        with _open_arrays(self._step_dir(step)) as leaves:
            values, extra = {}, {}
            for name, (read, dtype) in leaves.items():
                if name.startswith("state/"):
                    values[name[len("state/"):]] = (read, dtype)
                elif name.startswith("extra/"):
                    arr = read()
                    extra[name[len("extra/"):]] = \
                        arr.item() if arr.shape == () else arr
            return _fill(template, values), extra

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
