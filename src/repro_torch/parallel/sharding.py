"""Sharding rules: parameter name -> spec for every family (counterpart of
``repro/parallel/sharding.py``), and the one helper that turns a spec
into DTensor placements on a ``DeviceMesh``.

Scheme (the reference's MaxText-style 2.5D):
  * ``model`` axis — attention heads / FFN width / vocab / the expert dim
    (EP when the expert count divides the axis).
  * ``data`` (+ ``pod``) axes — FSDP: the batch of activations, and the
    non-``model`` dim of every weight (ZeRO-3).

A spec is a tuple with one entry per dimension of the port's tensor: a
mesh axis name, a tuple of names (major first, in mesh order) or None.
The rules are the reference's, applied to the port's names and layouts:
an ``nn.Linear`` weight is (out, in), the transpose of the reference's
array, so its two entries are swapped (``attn.wq.weight`` is ``(tp,
fsdp)`` where the reference has ``P(fsdp, tp)``), and the reference's
leading ``None`` of a stacked layer disappears, as the port holds one
module per layer.  A mesh is a ``DeviceMesh`` or a dict of axis name ->
size in mesh order (what the rules read of a mesh).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(sizes):
    fsdp = tuple(a for a in sizes if a in ("pod", "data"))
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    return fsdp, ("model" if "model" in sizes else None)


def _ep_on_model(cfg: ModelConfig, sizes) -> bool:
    if cfg.moe is None:
        return False
    return cfg.moe.n_experts % sizes.get("model", 1) == 0


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sanitize(spec, shape, mesh) -> tuple:
    """Null out spec entries whose dim is not divisible by the axis size,
    and pad to the tensor's rank."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        size = int(np.prod([sizes[a] for a in _entry_axes(entry)]))
        out.append(entry if entry is not None and shape[d] % size == 0
                   else None)
    return tuple(out) + (None,) * (len(shape) - len(out))


def _reference_rule(name: str, shape, fsdp, tp, ep_model) -> tuple:
    """The reference's ``_rule`` for one unstacked array of its layout."""
    nd = len(shape)
    if name in ("embed", "lm_head"):
        # (V, D) / (D, V): shard the big vocab dim by model, other by fsdp
        big = int(np.argmax(shape))
        spec = [None, None]
        spec[big] = tp
        spec[1 - big] = fsdp
        return tuple(spec)
    if name == "pos_embed":
        return ()
    if name in ("wq", "wk", "wv", "in_proj"):
        return (fsdp, tp)
    if name in ("wo", "out_proj"):
        return (tp, fsdp)
    if name in ("w1", "w3"):
        if nd == 3:                 # MoE experts (E, D, F)
            return (tp, fsdp, None) if ep_model else (None, fsdp, tp)
        return (fsdp, tp)
    if name == "w2":
        if nd == 3:                 # (E, F, D)
            return (tp, None, fsdp) if ep_model else (None, tp, fsdp)
        return (tp, fsdp)
    if name == "router":
        return (fsdp, None)
    if name == "conv_w":
        return (None, tp)
    if name == "conv_b":
        return (tp,)
    # norms, biases, per-head scalars: replicate
    return ()


def param_spec(cfg: ModelConfig, name: str, shape, mesh) -> tuple:
    """The spec of the port's parameter ``name`` of ``shape``."""
    sizes = axis_sizes(mesh)
    fsdp, tp = _axes(sizes)
    parts = name.split(".")
    linear = parts[-1] == "weight"      # an nn.Linear's (out, in) weight
    leaf = parts[-2] if linear else parts[-1]
    ref_shape = tuple(shape)[::-1] if linear else tuple(shape)
    spec = _reference_rule(leaf, ref_shape, fsdp, tp, _ep_on_model(cfg,
                                                                   sizes))
    spec = spec + (None,) * (len(shape) - len(spec))
    return _sanitize(spec[::-1] if linear else spec, tuple(shape), sizes)


def param_specs(cfg: ModelConfig, params, mesh) -> Dict[str, tuple]:
    """{name: spec} of every parameter: ``params`` is a module or a dict
    of name -> tensor."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {n: param_spec(cfg, n, tuple(p.shape), mesh)
            for n, p in params.items()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, kind=None):
    """-> spec_for(key): the spec of a train/prefill batch's entry."""
    fsdp, _ = _axes(axis_sizes(mesh))
    kind = kind or shape.kind

    def spec_for(key):
        if key in ("tokens", "labels", "loss_mask"):
            return (fsdp, None) if kind != "decode" else (fsdp,)
        if key in ("prefix_embeds", "encoder_embeds"):
            return (fsdp, None, None)
        if key == "pos":
            return ()
        raise KeyError(key)

    return spec_for


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """-> rule(name, leaf shape): the spec of a decode cache's entry.

    decode (B large): batch over fsdp, kv-heads over model.  B=1 long
    context: the KV cache's SEQUENCE dim shards over the fsdp axes and
    heads over model."""
    sizes = axis_sizes(mesh)
    fsdp, tp = _axes(sizes)
    fsdp_size = int(np.prod([sizes[a] for a in _entry_axes(fsdp)]))
    tp_size = sizes.get("model", 1)
    batch_sharded = shape.global_batch % fsdp_size == 0 \
        and shape.global_batch >= fsdp_size

    def _tp_if(dim_size):
        return tp if (tp and dim_size % tp_size == 0) else None

    def _fsdp_if(dim_size):
        return fsdp if dim_size % fsdp_size == 0 else None

    def rule(name: str, leaf_shape) -> tuple:
        nd = len(leaf_shape)
        if name in ("k", "v", "xk", "xv"):
            # (L|napps, B, Hkv, S, hd)
            if batch_sharded:
                return (None, _fsdp_if(leaf_shape[1]),
                        _tp_if(leaf_shape[2]), None, None)
            return (None, None, _tp_if(leaf_shape[2]),
                    _fsdp_if(leaf_shape[3]), None)
        if name == "conv":              # (L, B, W, C)
            return (None, _fsdp_if(leaf_shape[1]) if batch_sharded
                    else None, None, _tp_if(leaf_shape[3]))
        if name == "ssm":               # (L, B, H, P, N)
            return (None, _fsdp_if(leaf_shape[1]) if batch_sharded
                    else None, _tp_if(leaf_shape[2]), None, None)
        return (None,) * nd

    return rule


def placements(spec, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    axis, ``Shard(d)`` where dim d's entry names it, else
    ``Replicate()``.  A dim over several axes shards over them major
    first, in mesh order, as the reference's tuple entries do."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d}'s axes {axes} are not "
                             f"in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_slice(t, spec, mesh, coords: Dict[str, int]):
    """The block of ``t`` that the rank at mesh ``coords`` ({axis: index})
    holds under ``spec`` (the batch's and the tests' slicer)."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:                  # major first
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t
