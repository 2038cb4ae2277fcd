"""A module's parameters as DTensors placed by their specs, gathered where
the forward reads them (the sharded trainer's runtime,
``launch/train.py::build_sharded_train``).

``shard_module`` replaces every parameter of a module by a DTensor
parameter with the placements of its spec (``sharding.placements``), so
the state's memory is sharded over every axis its spec names.  Reading
such a parameter as a module attribute gathers it: redistributed to
``Replicate`` over every axis of more than one rank (an expert's
``model`` shard stays, under the all-to-all), cast to the compute
dtype, and handed to the forward as a plain tensor.  Its gradient
returns into the parameter's own placements: ``Partial("avg")`` on each
gathered axis, so the data ranks' gradients are averaged and
reduce-scattered, and the model ranks, which compute the dense blocks
alike, agree.

On a two-pod mesh ``("pod", "data", "model")`` every spec shards a dim
over ``pod`` and ``data`` together (``Shard(d)`` on both), and DTensor
plans the gradient of such a dim axis by axis: for an expert, whose
``model`` shard stays, that plan all-reduces over one axis where one
reduce-scatter over both would do.  So a parameter is gathered on a view
of its mesh with ``pod`` and ``data`` as one axis, ``pod_data``
(``_flat_view``): one all-gather and one reduce-scatter over the data
ranks, pod-major as the specs order them.  A parameter sharded over
neither (a norm, replicated) keeps DTensor's plan on its own mesh.

Inside ``gathered_forward`` the autograd graph does not keep a gathered
tensor: each is saved as its parameter and gathered again when the
backward needs it, so a parameter's full copy lives from its read to
the end of the op that read it.  A gathered tensor is known by its
storage (``StorageWeakRef``), not by its data pointer, which is 0 for
every fake tensor (``launch/dryrun.py`` traces this scope over fake
tensors).
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, Iterable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.parallel.sharding import placements


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _flat_view(mesh):
    """``mesh`` with its ``pod`` and ``data`` axes as one ``pod_data``
    axis (pod-major, the order of a spec's ``("pod", "data")`` entry),
    or ``mesh`` itself when it has not both."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh
    names = list(mesh.mesh_dim_names)
    if "pod" not in names or "data" not in names:
        return mesh
    i = names.index("pod")
    if names.index("data") != i + 1:
        raise ValueError(f"mesh axes {names}: 'data' must follow 'pod'")
    # the rank table is host data, real even where the state is placed
    # under a fake mode (the dry run)
    with unset_fake_temporarily():
        return DeviceMesh(mesh.device_type, mesh.mesh.flatten(i, i + 1),
                          mesh_dim_names=tuple(names[:i] + ["pod_data"]
                                               + names[i + 2:]))


def _gather(p, grad: bool = True) -> torch.Tensor:
    """The full (or model-sharded) tensor of DTensor parameter ``p`` in
    its compute dtype; with ``grad``, differentiable into ``p``."""
    from torch.distributed.tensor import DTensor
    view, plc, target, grad_placements, dtype = p._gather
    dt = p if grad else p.detach()
    if view is not dt.device_mesh:
        # the same local shard on the flattened view; its gradient comes
        # back into ``p``'s placements through ``to_local``
        dt = DTensor.from_local(dt.to_local(), view, plc, run_check=False,
                                shape=p.shape, stride=p.stride())
    if tuple(dt.placements) != grad_placements:
        # the redistribute's backward takes the gradient from
        # ``grad_placements`` to the parameter's (a reduction)
        dt = dt.redistribute(dt.device_mesh, target)
    full = dt.to_local(grad_placements=grad_placements if grad else None)
    if dtype is not None and full.is_floating_point() and full.dtype != dtype:
        full = full.to(dtype)
    return full


# inside ``gathered_forward``: a gathered tensor's storage (a weak
# reference, which also keeps its address from naming a later storage)
# -> (weakref to the tensor, its parameter)
_SCOPE: ContextVar[Optional[dict]] = ContextVar("gathered_forward",
                                               default=None)


def _read(self, name):
    """``__getattr__`` of a sharded module: a DTensor parameter is read
    gathered (``_gather``), anything else as ``nn.Module`` reads it."""
    params = self.__dict__.get("_parameters")
    if params is not None and _is_dtensor(params.get(name)):
        full = _gather(params[name])
        live = _SCOPE.get()
        if live is not None:
            with torch.no_grad():
                local = params[name].to_local()
            key = StorageWeakRef(full.untyped_storage())
            if key != StorageWeakRef(local.untyped_storage()):  # a copy
                live[key] = (weakref.ref(full), params[name])
        return full
    return torch.nn.Module.__getattr__(self, name)


_CLASSES: Dict[type, type] = {}


def _sharded_class(cls: type) -> type:
    if cls not in _CLASSES:
        _CLASSES[cls] = type(f"Sharded{cls.__name__}", (cls,),
                             {"__getattr__": _read})
    return _CLASSES[cls]


def shard_module(model: torch.nn.Module, specs: Dict[str, tuple], mesh, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 model_sharded: Iterable[str] = ()) -> torch.nn.Module:
    """Place every parameter of ``model`` (whole and equal on every rank)
    on ``mesh`` by ``specs`` {name: spec}, in place -> ``model``.  A
    parameter named in ``model_sharded`` keeps its ``model`` shard when
    read (the all-to-all's experts); every other axis is gathered."""
    from torch.distributed.tensor import (Partial, Replicate,
                                          distribute_tensor)
    view = _flat_view(mesh)
    keep = set(model_sharded)
    for mod_name, mod in list(model.named_modules()):
        own = [(n, p) for n, p in mod._parameters.items() if p is not None]
        for pname, p in own:
            full_name = f"{mod_name}.{pname}" if mod_name else pname
            plc = placements(specs[full_name], mesh)
            on, flat = _on_view(plc, mesh, view)
            # gathered over every axis of more than one rank (a one-rank
            # axis holds the whole dim already: no collective there)
            gather = [on.size(i) > 1 and not (full_name in keep
                                              and a == "model")
                      for i, a in enumerate(on.mesh_dim_names)]
            target = [Replicate() if g else flat[i]
                      for i, g in enumerate(gather)]
            grads = [Partial("avg") if g else flat[i]
                     for i, g in enumerate(gather)]
            dt = distribute_tensor(p.detach(), mesh, plc, src_data_rank=None)
            new = torch.nn.Parameter(dt, requires_grad=p.requires_grad)
            new._gather = (on, flat, tuple(target), tuple(grads),
                           compute_dtype)
            mod._parameters[pname] = new
        if own:
            mod.__class__ = _sharded_class(type(mod))
    return model


def _on_view(plc, mesh, view) -> tuple:
    """-> (the mesh a parameter of placements ``plc`` on ``mesh`` is
    gathered on, its placements there): ``view`` (``_flat_view(mesh)``)
    where ``plc`` shards a dim over ``pod`` and ``data``, else ``mesh``
    (a replicated parameter keeps DTensor's plan)."""
    from torch.distributed.tensor import Shard
    if view is mesh:
        return mesh, tuple(plc)
    i = list(mesh.mesh_dim_names).index("pod")
    if not (isinstance(plc[i], Shard) and plc[i] == plc[i + 1]):
        return mesh, tuple(plc)
    return view, tuple(plc[:i + 1]) + tuple(plc[i + 2:])


class _Saved:
    __slots__ = ("param", "size", "stride", "offset")

    def __init__(self, param, t):
        self.param = param
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


@contextmanager
def gathered_forward():
    """The scope of a sharded forward and backward: the graph saves each
    gathered parameter as the parameter, gathered again on use."""
    live: Dict[StorageWeakRef, tuple] = {}
    # the backward's gathers, alive while the graph holds them
    regathered = weakref.WeakValueDictionary()

    def pack(t):
        try:
            key = StorageWeakRef(t.untyped_storage())
        except (RuntimeError, NotImplementedError):
            return t
        entry = live.get(key)
        if entry is None:
            return t
        full = entry[0]()
        if full is None or full.dtype != t.dtype:
            live.pop(key, None)         # stale: the gathered tensor is gone
            return t
        return _Saved(entry[1], t)

    def unpack(x):
        if not isinstance(x, _Saved):
            return x
        full = regathered.get(id(x.param))
        if full is None:
            with torch.no_grad():
                full = _gather(x.param, grad=False)
            regathered[id(x.param)] = full
        return full.as_strided(x.size, x.stride, x.offset)

    token = _SCOPE.set(live)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
    finally:
        _SCOPE.reset(token)


def replication(p) -> int:
    """How many ranks hold each element of DTensor ``p``."""
    from torch.distributed.tensor import Replicate
    n = 1
    for plc, size in zip(p.placements, p.device_mesh.shape):
        if isinstance(plc, Replicate):
            n *= size
    return n
