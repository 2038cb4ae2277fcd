"""A traced step's collective bytes, HBM bytes and roofline terms
(counterpart of ``repro/launch/hlo.py``).

The reference parses the post-SPMD HLO text of a compiled step.  The
port has no HLO: ``collectives_from_trace`` is a ``TorchDispatchMode``
that sees every op of an eager step (fake tensors on a fake process
group, ``launch/dryrun.py``) and does the same job.  It reads each
``_c10d_functional.*`` and ``c10d.*`` collective's result size and its
group's size (``wait_tensor`` moves no bytes), and sums the bytes every
other op that makes a tensor reads and writes (each tensor argument read
once, each output written once; views, ``empty`` and metadata move
none), the counterpart of ``cost_analysis``'s "bytes accessed".  It also
keeps the peak of the bytes of the live storages that ops made, beside
those ``track`` is given (``memory_analysis``'s counterpart): a storage
counts from the op that makes it until it is freed.

Two aggregates are reported per op kind, with the reference's formulas:
  * result_bytes — sum of output-shape bytes (raw),
  * wire_bytes   — ring-algorithm per-device traffic:
        all-reduce:       2 * size * (n-1)/n
        all-gather:       size * (n-1)/n          (size = result)
        reduce-scatter:   in_size * (n-1)/n  = result * (n-1)
        all-to-all:       size * (n-1)/n
        collective-permute: size

The hand kernels' fake branches (``kernels/ops.py``) launch nothing, so
no op of theirs shows the work: each adds its kernel's nominal
operations and bytes (``kernels/cost.py``) to the ``KernelCounts`` that
``counting_kernels`` makes active.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)

# collective op (namespace.name) -> (kind, its result's argument or
# None for the op's output): DTensor's redistributions (functional) and
# the ``dist`` calls of the all-to-all MoE and the optimizer; any other
# collective raises
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional.all_reduce": ("all-reduce", None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None),
    "_c10d_functional.all_to_all_single": ("all-to-all", None),
    "c10d.allgather_": ("all-gather", "output_tensors"),
    "c10d.allreduce_": ("all-reduce", "tensors"),
    "c10d.alltoall_base_": ("all-to-all", "output"),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
# ops that move no bytes of their own
_NO_BYTES = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.new_empty", "aten.new_empty_strided", "aten.detach",
             "aten.lift_fresh", "aten._local_scalar_dense",
             "_c10d_functional.wait_tensor"}


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Ring per-device traffic of one collective of result ``size`` bytes
    over a group of ``n`` (the reference's ``parse_collectives``)."""
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return size * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "all-to-all":
        return size * (n - 1) / max(n, 1)
    return size                         # collective-permute


@dataclass
class CollectiveStats:
    result_bytes: Dict[str, float] = field(default_factory=dict)
    wire_bytes: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def total_wire(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_result(self) -> float:
        return sum(self.result_bytes.values())

    def add(self, kind: str, size: float, n: int) -> None:
        self.result_bytes[kind] = self.result_bytes.get(kind, 0.0) + size
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0.0) \
            + wire_bytes(kind, size, n)
        self.counts[kind] = self.counts.get(kind, 0) + 1


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def tensor_bytes(x) -> float:
    """Bytes of the tensors in ``x`` (a tensor, or lists and tuples of
    them)."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _group_size(named: dict) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    return dist.ProcessGroup.unbox(named["process_group"]).size()


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


_DEVICE = torch.ops.prim.device.default


def _storages(t):
    """The storages under ``t``: a wrapper subclass's (a DTensor's local
    shard) or its own."""
    if is_traceable_wrapper_subclass(t):
        for attr in t.__tensor_flatten__()[0]:
            inner = getattr(t, attr)
            if isinstance(inner, torch.Tensor):
                yield from _storages(inner)
    else:
        yield t.untyped_storage()


class _Trace(TorchDispatchMode):
    """The mode ``collectives_from_trace`` enters: ``stats``
    (``CollectiveStats``), ``hbm_bytes``, and the live storages' bytes
    (``live_bytes``, ``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        self.hbm_bytes = 0.0
        self.live_bytes = self.peak_bytes = 0
        self._live: set = set()
        # each storage: [made at, freed at (None: alive), bytes, the op
        # that made it, its tensor's shape and dtype]; a clock of storages
        self._storages: list = []
        self._clock = self._peak_at = 0

    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` (made before the trace) as
        live until they are freed."""
        for t in _tensors(list(tensors)):
            self._add(t, "before the step")

    def _add(self, t, op: str) -> None:
        for st in _storages(t):
            key = StorageWeakRef(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live.add(key)
            self._clock += 1
            rec = [self._clock, None, n, op, tuple(t.shape),
                   str(t.dtype).replace("torch.", "")]
            self._storages.append(rec)
            weakref.finalize(st, self._free, key, n, rec)
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes, self._peak_at = self.live_bytes, self._clock

    def _free(self, key, n, rec) -> None:
        self._live.discard(key)
        self.live_bytes -= n
        self._clock += 1
        rec[1] = self._clock

    def peak_breakdown(self, top: int = 10) -> tuple:
        """The storages live at the peak -> ({op that made them: bytes},
        the ``top`` largest groups of (op, shape, dtype) as [op, shape,
        dtype, count, bytes])."""
        by_op, groups = {}, {}
        for made, freed, n, op, shape, dtype in self._storages:
            if made <= self._peak_at and (freed is None
                                          or freed > self._peak_at):
                by_op[op] = by_op.get(op, 0) + n
                g = groups.setdefault((op, shape, dtype), [0, 0])
                g[0] += 1
                g[1] += n
        ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
        return by_op, [[op, list(shape), dtype, c, n]
                       for (op, shape, dtype), (c, n) in ranked]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:             # a wrapper's .device: metadata
            return out
        name = _op_name(func)
        for t in _tensors(out):
            self._add(t, name)
        if name in _COLLECTIVE_OPS:
            kind, arg = _COLLECTIVE_OPS[name]
            named = dict(zip((a.name for a in func._schema.arguments), args))
            named.update(kwargs)
            size = tensor_bytes(out if arg is None else named[arg])
            self.stats.add(kind, size, _group_size(named))
        elif func.namespace in _COLLECTIVE_NAMESPACES \
                and name not in _NO_BYTES:
            raise NotImplementedError(f"collective {name}: no wire formula")
        elif name not in _NO_BYTES and not func.is_view:
            written = tensor_bytes(out)
            if written:
                seen = {id(t): t for t in _tensors(list(args)
                                                  + list(kwargs.values()))}
                self.hbm_bytes += written + tensor_bytes(list(seen.values()))
        return out


@contextmanager
def collectives_from_trace():
    """Count the collectives, the bytes of every op run inside and the
    peak of the live storages: yields the mode, whose ``stats``,
    ``hbm_bytes`` and ``peak_bytes`` hold them (``track`` adds what
    exists before)."""
    mode = _Trace()
    with mode:
        yield mode


class _NoModules:
    """Stands in for ``FlopCounterMode``'s per-module tracker: every op
    counts under "Global" alone, and no module or gradient hook is
    registered (the tracker's hooks make reference cycles that hold the
    traced tensors until the cyclic collector runs, so the live
    storages' peak would move with its timing)."""
    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def counting_flops():
    """A ``FlopCounterMode`` (its registry's FLOPs of every torch op,
    ``get_total_flops``) that tracks no module."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    mode.mod_tracker = _NoModules()
    return mode


@dataclass
class KernelCounts:
    """The nominal work of the hand kernels' fake calls: operations,
    bytes, and calls by kernel."""
    flops: float = 0.0
    bytes: float = 0.0
    calls: Dict[str, int] = field(default_factory=dict)

    def add(self, kernel: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.calls[kernel] = self.calls.get(kernel, 0) + 1


_KERNELS: ContextVar[Optional[KernelCounts]] = ContextVar("kernel_counts",
                                                          default=None)


def active_kernel_counts() -> Optional[KernelCounts]:
    """The counts ``counting_kernels`` made active here, or None."""
    return _KERNELS.get()


@contextmanager
def counting_kernels():
    """Make a fresh ``KernelCounts`` active for the hand kernels' fake
    calls inside; yields it.  A context variable of this thread: a
    backward counts only where it runs here (``launch/dryrun.py`` keeps
    the autograd engine off its device threads)."""
    counts = KernelCounts()
    token = _KERNELS.set(counts)
    try:
        yield counts
    finally:
        _KERNELS.reset(token)


# ---------------------------------------------------------------------------
# Roofline terms (one H100 SXM: NVIDIA's data sheet)
# ---------------------------------------------------------------------------
# dense bf16 tensor-core rate, HBM3 bandwidth and NVLink 4 bandwidth a
# direction (900 GB/s both ways) of the H100 SXM5 data sheet
H100_SXM_BF16_FLOPS = 989e12
H100_SXM_HBM3_BYTES_PER_S = 3.35e12
H100_SXM_NVLINK_BYTES_PER_S = 450e9


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   n_chips: int, *, peak_flops=H100_SXM_BF16_FLOPS,
                   hbm_bw=H100_SXM_HBM3_BYTES_PER_S,
                   link_bw=H100_SXM_NVLINK_BYTES_PER_S) -> Dict[str, float]:
    """All three terms in SECONDS.  flops, hbm_bytes and wire_bytes are
    per device (the traced step is one rank's), so each divides by one
    card's rate; ``n_chips`` is kept for the reference's signature."""
    return {
        "compute_s": flops / peak_flops,
        "memory_s": hbm_bytes / hbm_bw,
        "collective_s": wire_bytes / link_bw,
    }
