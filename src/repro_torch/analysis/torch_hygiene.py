"""torch-hygiene — host syncs on the card's call graph (takes the place of
the reference's ``repro/analysis/jax_hygiene.py``).

A CUDA kernel is queued, not run, when its op returns; the host waits for
the card only where it reads tensor DATA.  Such a wait empties the queue
and leaves the card idle while the host catches up.  From each registered
device entry point this rule walks the in-repo call graph and flags, in
every reachable function:

* ``host-sync``            — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` or ``.to("cpu")`` on tensor data, or ``float()``,
  ``int()``, ``bool()``, ``complex()`` or ``range()`` of it: the value
  is copied to the host, which waits for every kernel queued before it;
  and ``torch.tensor``/``torch.as_tensor`` of host values with a
  ``device=`` other than the CPU: a copy from pageable host memory,
  which waits for the stream;
* ``branch-on-tensor``     — an ``if``, ``while``, ``assert``,
  conditional expression or comprehension ``if`` whose test reads tensor
  data: Python asks the tensor's truth, a ``bool()`` in disguise;
* ``data-dependent-shape`` — boolean-mask indexing (load or store),
  ``.nonzero()``/``torch.nonzero``/``torch.argwhere``/one-argument
  ``torch.where``, ``masked_select``, ``unique``/``unique_consecutive``,
  ``bincount`` and ``repeat_interleave`` with tensor repeats and no
  ``output_size=``: the result's size is data, which the host reads
  before it can allocate the result;
* ``unhashable-default``   — mutable default arguments (list/dict/set
  displays or constructor calls) on reachable functions, kept from the
  reference: one object shared by every call of a hot function.

Tensor data is: the entry's registered tensor parameters; ``.saved_tensors``
(an autograd context's); what a top-level ``torch.X(...)`` call returns,
bar the host-side ones (``_TORCH_HOST``); and what is computed from tensor
data — an operand, an element, a subscript, a method's result, an unknown
callee's result over a data argument, an in-repo callee's return
(summarised per call by which of its parameters receive data).

Not tensor data: metadata (``.shape``, ``.size()``, ``.dim()``,
``.dtype``, ``.device``, ``.is_cuda``, ``.numel()``, ``.stride()``,
``.is_contiguous()``, ``.data_ptr()``, ... and ``len``/``isinstance``/
``type``), identity tests (``x is None``), Python values (ints, strings,
what a sync already returned) and what an unknown call returns from
none of these (a ctypes launch's return code).

The dataflow is flow-insensitive within a function (a name once bound to
tensor data stays so) and context-sensitive across calls: a callee is
checked once for each set of its parameters that receive data.  A nested
function called by name sees its parent's data names; a lambda's
parameters are data.  The ``torch.cuda.set_sync_debug_mode("error")``
phase of ``chip_smoke.py`` holds these verdicts against the card.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (Module, ModuleCache, attr_chain,
                                          walk_functions)
from repro_torch.analysis.findings import Finding

RULE = "torch-hygiene"

# reads of tensor metadata: attributes and no-argument methods
_META_ATTRS = frozenset({
    "shape", "dtype", "device", "is_cuda", "is_cpu", "ndim", "layout",
    "requires_grad", "is_leaf", "grad_fn", "is_sparse", "is_quantized",
    "is_meta", "itemsize", "nbytes", "names",
})
_META_METHODS = frozenset({
    "size", "dim", "ndimension", "numel", "nelement", "stride",
    "is_contiguous", "data_ptr", "element_size", "storage_offset",
    "get_device", "is_floating_point", "is_complex",
})
# builtins whose result describes, not reads, their argument
_META_BUILTINS = frozenset({"len", "isinstance", "issubclass", "type", "id",
                            "hasattr", "callable"})
# attributes that hold tensors whatever their object is
_DATA_ATTRS = frozenset({"saved_tensors"})
# builtins that copy a value to the host
_CONCRETIZERS = frozenset({"float", "int", "bool", "complex", "range"})
# methods that copy a tensor to the host
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# torch.X calls whose result is a host value (not a tensor on the card)
_TORCH_HOST = frozenset({
    "is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
    "is_inference_mode_enabled", "get_default_dtype", "device", "dtype",
    "finfo", "iinfo", "Size", "promote_types", "result_type", "can_cast",
    "enable_grad", "no_grad", "inference_mode", "set_grad_enabled",
    "Generator", "get_num_threads",
})
# calls whose result's size is the data's: (torch function, method) names
_SHAPE_FNS = frozenset({"nonzero", "argwhere", "masked_select", "unique",
                        "unique_consecutive", "bincount"})
# calls that make a boolean tensor of their (data) arguments
_MASK_FNS = frozenset({"isnan", "isinf", "isfinite", "isposinf", "isneginf",
                       "logical_and", "logical_or", "logical_not",
                       "logical_xor", "isclose", "eq", "ne", "lt", "le",
                       "gt", "ge", "bool", "isin"})


@dataclass(frozen=True)
class TorchEntry:
    """A function that runs with its tensors on the card, and which of its
    parameters hold tensors (the others are Python values: configs,
    shapes, flags)."""

    path: str
    qualname: str
    tensor_params: Tuple[str, ...] = ()


_OPS = "src/repro_torch/kernels/ops.py"

DEFAULT_TORCH_ENTRIES: Tuple[TorchEntry, ...] = (
    # the study's cost terms on the card: ``a`` holds per-point tensors;
    # the workload's scalars, the fabric and the hardware are Python
    TorchEntry(path="src/repro_torch/dse/batched_sim.py",
               qualname="_terms_core", tensor_params=("a",)),
    # the event re-rank's wavefront kernel
    TorchEntry(path="src/repro_torch/kernels/wavefront.py",
               qualname="wavefront",
               tensor_params=("ldir", "ldep_s", "ldep_l", "key_rows",
                              "rows")),
    # the four autograd Functions of the kernels: forward and backward
    TorchEntry(path=_OPS, qualname="_FlashAttention.forward",
               tensor_params=("q", "k", "v")),
    TorchEntry(path=_OPS, qualname="_FlashAttention.backward",
               tensor_params=("do",)),
    TorchEntry(path=_OPS, qualname="_RMSNorm.forward",
               tensor_params=("x", "w")),
    TorchEntry(path=_OPS, qualname="_RMSNorm.backward",
               tensor_params=("dy",)),
    TorchEntry(path=_OPS, qualname="_SSD.forward",
               tensor_params=("x", "dt", "A", "B", "C")),
    TorchEntry(path=_OPS, qualname="_SSD.backward",
               tensor_params=("dy", "dstate")),
    TorchEntry(path=_OPS, qualname="_MoEGMM.forward",
               tensor_params=("x", "w", "block_group_ids")),
    TorchEntry(path=_OPS, qualname="_MoEGMM.backward",
               tensor_params=("dy",)),
    # serving's decode step (torch ops on every device)
    TorchEntry(path=_OPS, qualname="decode_attention",
               tensor_params=("q", "k_cache", "v_cache")),
)


# ---------------------------------------------------------------------------
# per-function dataflow
# ---------------------------------------------------------------------------
@dataclass
class _Facts:
    """A function's data names under one context."""

    data: Set[str] = field(default_factory=set)
    masks: Set[str] = field(default_factory=set)


Context = Tuple[FrozenSet[str], FrozenSet[str]]   # (params, parent's names)
_COMPS = (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)


def _params(fn) -> List[str]:
    a = fn.args
    out = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        out.append(a.vararg.arg)
    if a.kwarg:
        out.append(a.kwarg.arg)
    return out


def _is_identity(node: ast.Compare) -> bool:
    return all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)


def _is_cpu_target(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")`` or
    ``.to(torch.device("cpu"))``."""
    vals = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg in ("device", None)]
    for v in vals:
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.split(":")[0] == "cpu":
            return True
    return False


class _Analysis:
    """The call graph below the entries, its per-context facts and
    return summaries."""

    def __init__(self, cache: ModuleCache):
        self.cache = cache
        self.facts: Dict[Tuple[str, str, Context], _Facts] = {}
        self.returns: Dict[Tuple[str, str, Context], bool] = {}
        self._scopes: Dict[Tuple[str, str, Context], Dict[int, _Facts]] = {}

    # ---------------- name resolution ----------------
    def torch_aliases(self, mod: Module) -> Set[str]:
        return {a for a, d in mod.module_aliases.items() if d == "torch"}

    def resolve(self, mod: Module, qual: str, call: ast.Call
                ) -> Optional[Tuple[Module, str]]:
        """The in-repo function a call names: a nested def of ``qual`` or
        of its parents, a method of ``qual``'s class through ``self``/
        ``cls``, a function of this module, a from-import or a module
        alias whose file is in the tree."""
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            parts = qual.split(".")
            for i in range(len(parts), -1, -1):
                scope = ".".join(parts[:i])
                if i and scope not in mod.functions:
                    continue                     # a class body: no scope
                cand = f"{scope}.{name}" if i else name
                if cand in mod.functions:
                    return mod, cand
            return self.resolve_global(mod, name)
        chain = attr_chain(func)
        if chain and len(chain) == 2:
            if chain[0] in ("self", "cls") and "." in qual:
                cand = f"{qual.rsplit('.', 1)[0]}.{chain[1]}"
                if cand in mod.functions:
                    return mod, cand
            dotted = mod.module_aliases.get(chain[0])
            if dotted:
                target = self.cache.get_by_dotted(dotted)
                if target is not None:
                    return self.resolve_global(target, chain[1])
        return None

    def resolve_global(self, mod: Module, name: str, hops: int = 4
                       ) -> Optional[Tuple[Module, str]]:
        """A module-level ``name`` of ``mod`` as an in-repo function,
        through from-imports and ``name = other`` aliases."""
        if name in mod.functions:
            return mod, name
        if hops == 0:
            return None
        imp = mod.from_imports.get(name)
        if imp:
            target = self.cache.get_by_dotted(imp[0])
            return None if target is None \
                else self.resolve_global(target, imp[1], hops - 1)
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name \
                    and isinstance(node.value, ast.Name):
                return self.resolve_global(mod, node.value.id, hops - 1)
        return None

    def call_context(self, mod: Module, qual: str, call: ast.Call,
                     facts: _Facts, callee_mod: Module, callee: str
                     ) -> Context:
        """Which of the callee's parameters receive data at this call."""
        fn = callee_mod.functions[callee]
        a = fn.args
        positional = [p.arg for p in a.posonlyargs + a.args]
        if callee_mod is mod and "." in callee \
                and isinstance(call.func, ast.Attribute) \
                and positional and positional[0] in ("self", "cls"):
            positional = positional[1:]          # bound through self/cls
        hot: Set[str] = set()
        for i, arg in enumerate(call.args):
            is_data = self.reads(mod, qual, arg, facts)
            if isinstance(arg, ast.Starred):
                if is_data:
                    hot.update(positional[i:])
                    if a.vararg:
                        hot.add(a.vararg.arg)
                break
            if not is_data:
                continue
            if i < len(positional):
                hot.add(positional[i])
            elif a.vararg:
                hot.add(a.vararg.arg)
        names = set(_params(fn))
        for kw in call.keywords:
            if not self.reads(mod, qual, kw.value, facts):
                continue
            if kw.arg is None:                   # **kw: any of them
                hot.update(names)
            elif kw.arg in names:
                hot.add(kw.arg)
            elif a.kwarg:
                hot.add(a.kwarg.arg)
        parent = frozenset()
        if callee_mod is mod and callee.startswith(qual + "."):
            parent = frozenset(facts.data)       # a closure's free names
        return frozenset(hot), parent

    # ---------------- the data predicate ----------------
    def reads(self, mod: Module, qual: str, node: ast.AST,
              facts: _Facts) -> bool:
        """Whether evaluating ``node`` yields (or reads) tensor data."""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in facts.data
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            if node.attr in _DATA_ATTRS:
                return True
            return self.reads(mod, qual, node.value, facts)
        if isinstance(node, ast.Compare) and _is_identity(node):
            return False
        if isinstance(node, ast.Call):
            return self.call_reads(mod, qual, node, facts)
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, _COMPS):
            inner = self.comprehension_facts(mod, qual, node, facts)
            elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
                else [node.elt]
            return any(self.reads(mod, qual, e, inner) for e in elts)
        return any(self.reads(mod, qual, c, facts)
                   for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.expr_context, ast.operator,
                                         ast.cmpop, ast.boolop,
                                         ast.unaryop)))

    def comprehension_facts(self, mod, qual, node, facts) -> _Facts:
        inner = _Facts(set(facts.data), set(facts.masks))
        for gen in node.generators:
            if self.reads(mod, qual, gen.iter, inner):
                inner.data.update(n.id for n in ast.walk(gen.target)
                                  if isinstance(n, ast.Name))
        return inner

    def call_reads(self, mod: Module, qual: str, call: ast.Call,
                   facts: _Facts) -> bool:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in _META_BUILTINS or func.id in _CONCRETIZERS:
                return False
        elif isinstance(func, ast.Attribute):
            if func.attr in _META_METHODS or func.attr in _SYNC_METHODS \
                    or (func.attr == "to" and _is_cpu_target(call)):
                return False
            chain = attr_chain(func)
            if chain and len(chain) == 2 \
                    and chain[0] in self.torch_aliases(mod):
                return chain[1] not in _TORCH_HOST
        resolved = self.resolve(mod, qual, call)
        if resolved is not None:
            cmod, cqual = resolved
            ctx = self.call_context(mod, qual, call, facts, cmod, cqual)
            return self.returns_data(cmod, cqual, ctx)
        parts = list(call.args) + [kw.value for kw in call.keywords]
        if isinstance(func, ast.Attribute):
            parts.append(func.value)
        return any(self.reads(mod, qual, p, facts) for p in parts)

    def is_mask(self, mod, qual, node, facts) -> bool:
        """Whether ``node`` is a boolean tensor made from data."""
        if isinstance(node, ast.Name):
            return node.id in facts.masks
        if isinstance(node, ast.Compare):
            return not _is_identity(node) \
                and self.reads(mod, qual, node, facts)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(mod, qual, node.left, facts) \
                or self.is_mask(mod, qual, node.right, facts)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(mod, qual, node.operand, facts)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            return node.func.attr in _MASK_FNS \
                and self.reads(mod, qual, node, facts)
        return False

    # ---------------- facts and summaries ----------------
    def facts_of(self, mod: Module, qual: str, ctx: Context) -> _Facts:
        key = (mod.rel, qual, ctx)
        if key in self.facts:
            return self.facts[key]
        fn = mod.functions[qual]
        facts = _Facts(set(ctx[0]) | set(ctx[1]), set())
        self.facts[key] = facts          # a recursive call sees the seed
        changed = True
        while changed:                   # to a fixed point (loops)
            changed = False
            for node in self.body_nodes(fn):
                for tgt, value in _bindings(node):
                    names = _target_names(tgt)
                    if names - facts.data \
                            and self.reads(mod, qual, value, facts):
                        facts.data |= names
                        changed = True
                    if isinstance(tgt, ast.Name) \
                            and tgt.id not in facts.masks \
                            and self.is_mask(mod, qual, value, facts):
                        facts.masks.add(tgt.id)
                        changed = True
        return facts

    def body_nodes(self, fn) -> Iterable[ast.AST]:
        for node in walk_functions(fn):
            yield node
            if isinstance(node, ast.Lambda):
                yield from ast.walk(node.body)

    def scopes(self, mod: Module, qual: str, ctx: Context
               ) -> Dict[int, _Facts]:
        """id(node) -> the facts inside a comprehension or a lambda, whose
        names are their own (a lambda's parameters are data)."""
        key = (mod.rel, qual, ctx)
        if key not in self._scopes:
            facts = self.facts_of(mod, qual, ctx)
            at: Dict[int, _Facts] = {}
            for node in self.body_nodes(mod.functions[qual]):
                outer = at.get(id(node), facts)
                if isinstance(node, _COMPS):
                    inner = self.comprehension_facts(mod, qual, node, outer)
                elif isinstance(node, ast.Lambda):
                    inner = _Facts(outer.data | set(_params(node)),
                                   set(outer.masks))
                else:
                    continue
                for sub in ast.walk(node):
                    if sub is not node:
                        at[id(sub)] = inner
            self._scopes[key] = at
        return self._scopes[key]

    def returns_data(self, mod: Module, qual: str, ctx: Context) -> bool:
        key = (mod.rel, qual, ctx)
        if key in self.returns:
            return self.returns[key]
        self.returns[key] = True         # recursion: assume data
        facts = self.facts_of(mod, qual, ctx)
        fn = mod.functions[qual]
        out = any(isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom))
                  and self.reads(mod, qual, n.value, facts)
                  for n in walk_functions(fn))
        self.returns[key] = out
        return out


def _target_names(tgt: ast.AST) -> Set[str]:
    """The names a store rebinds or fills: ``a`` and ``b`` of ``a, *b``;
    the root ``a`` of ``a[i] = ...`` or ``a.f = ...`` (not ``i``)."""
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return set().union(*(_target_names(e) for e in tgt.elts))
    if isinstance(tgt, ast.Starred):
        return _target_names(tgt.value)
    while isinstance(tgt, (ast.Subscript, ast.Attribute)):
        tgt = tgt.value
    return {tgt.id} if isinstance(tgt, ast.Name) else set()


def _bindings(node: ast.AST):
    """(target, value) pairs a statement or comprehension binds; tuple
    targets over tuple values pair element by element."""
    if isinstance(node, ast.Assign):
        pairs = [(t, node.value) for t in node.targets]
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        pairs = [(node.target, node.value)] if node.value is not None \
            else []
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        pairs = [(node.target, node.iter)]
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        pairs = [(i.optional_vars, i.context_expr) for i in node.items
                 if i.optional_vars is not None]
    else:
        return []
    out = []
    for tgt, value in pairs:
        if isinstance(tgt, (ast.Tuple, ast.List)) \
                and isinstance(value, (ast.Tuple, ast.List)) \
                and len(tgt.elts) == len(value.elts) \
                and not any(isinstance(e, ast.Starred)
                            for e in tgt.elts + value.elts):
            for t, v in zip(tgt.elts, value.elts):
                out.extend(_bindings(ast.Assign(targets=[t], value=v)))
        else:
            out.append((tgt, value))
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
def _check_function(an: _Analysis, mod: Module, qual: str, ctx: Context,
                    out: List[Finding]) -> None:
    fn = mod.functions[qual]
    top = an.facts_of(mod, qual, ctx)
    at = an.scopes(mod, qual, ctx)
    torch_names = an.torch_aliases(mod)

    def flag(node, message):
        out.append(Finding(path=mod.rel, line=node.lineno, rule=RULE,
                           symbol=qual, message=message))

    for d in fn.args.defaults + [d for d in fn.args.kw_defaults if d]:
        mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
            and d.func.id in ("list", "dict", "set"))
        if mutable:
            flag(d, "unhashable-default: mutable default argument on a "
                    "function the card's entry points reach is one object "
                    "shared by every call")

    for node in an.body_nodes(fn):
        facts = at.get(id(node), top)

        def reads(expr) -> bool:
            return an.reads(mod, qual, expr, facts)

        def hot(expr) -> str:
            names = sorted({n.id for n in ast.walk(expr)
                            if isinstance(n, ast.Name)
                            and n.id in facts.data})
            return ", ".join(names) or "a torch call's result"

        test, kind = None, None
        if isinstance(node, (ast.If, ast.While)):
            test = node.test
            kind = "if" if isinstance(node, ast.If) else "while"
        elif isinstance(node, ast.Assert):
            test, kind = node.test, "assert"
        elif isinstance(node, ast.IfExp):
            test, kind = node.test, "conditional expression"
        elif isinstance(node, ast.comprehension):
            inner = at.get(id(node.target), facts)
            for cond in node.ifs:
                if an.reads(mod, qual, cond, inner):
                    flag(cond, "branch-on-tensor: comprehension `if` tests "
                               "tensor data — Python reads the value on "
                               "the host, which waits for the card")
        if test is not None and reads(test):
            flag(test, f"branch-on-tensor: `{kind}` tests tensor data "
                       f"({hot(test)}) — Python reads the value on the "
                       f"host, which waits for the card")

        if isinstance(node, ast.Subscript):
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(an.is_mask(mod, qual, p, facts) for p in parts):
                flag(node, f"data-dependent-shape: boolean-mask indexing "
                           f"({hot(idx)}) sizes its result by the data, "
                           f"which the host reads first")

        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name) and func.id in _CONCRETIZERS:
            if any(reads(a) for a in node.args):
                flag(node, f"host-sync: `{func.id}()` of tensor data "
                           f"({hot(node)}) copies it to the host and waits "
                           f"for the card")
            continue
        if not isinstance(func, ast.Attribute):
            continue
        chain = attr_chain(func)
        is_torch_fn = bool(chain) and len(chain) == 2 \
            and chain[0] in torch_names
        receiver = None if is_torch_fn else func.value
        if is_torch_fn and func.attr in ("tensor", "as_tensor"):
            dev = next((kw.value for kw in node.keywords
                        if kw.arg == "device"), None)
            on_host = isinstance(dev, ast.Constant) \
                and str(dev.value).split(":")[0] == "cpu"
            if dev is not None and not on_host and node.args \
                    and not reads(node.args[0]):
                flag(node, f"host-sync: `torch.{func.attr}(..., device=)` "
                           f"of host values copies them to the device and "
                           f"waits for the copy")
            continue
        if receiver is not None and reads(receiver) and (
                func.attr in _SYNC_METHODS
                or (func.attr == "to" and _is_cpu_target(node))):
            what = "to(\"cpu\")" if func.attr == "to" else f"{func.attr}()"
            flag(node, f"host-sync: `.{what}` on tensor data "
                       f"({hot(receiver)}) copies it to the host and waits "
                       f"for the card")
            continue
        args = list(node.args)
        operand = args[0] if is_torch_fn and args else receiver
        if operand is None or not reads(operand):
            continue
        shape_fn = func.attr in _SHAPE_FNS or (
            is_torch_fn and func.attr == "where" and len(args) == 1
            and not node.keywords)
        if func.attr == "repeat_interleave":
            reps = args[1:2] if is_torch_fn else args[:1]
            reps += [kw.value for kw in node.keywords
                     if kw.arg == "repeats"]
            shape_fn = any(reads(r) for r in reps) and not any(
                kw.arg == "output_size" for kw in node.keywords)
        if shape_fn:
            flag(node, f"data-dependent-shape: `{func.attr}` on tensor "
                       f"data ({hot(operand)}) sizes its result by the "
                       f"data, which the host reads first")


def check_torch_hygiene(cache: ModuleCache,
                        entries: Tuple[TorchEntry, ...]) -> List[Finding]:
    an = _Analysis(cache)
    out: List[Finding] = []
    seen: Set[Tuple[str, str, Context]] = set()
    todo: List[Tuple[Module, str, Context]] = []
    for e in entries:
        mod = cache.get(e.path)
        if mod is None or e.qualname not in mod.functions:
            out.append(Finding(
                path=e.path, line=1, rule=RULE, symbol=e.qualname,
                message="registered device entry point not found"))
            continue
        todo.append((mod, e.qualname,
                     (frozenset(e.tensor_params), frozenset())))
    while todo:
        mod, qual, ctx = todo.pop()
        if (mod.rel, qual, ctx) in seen:
            continue
        seen.add((mod.rel, qual, ctx))
        _check_function(an, mod, qual, ctx, out)
        top, at = an.facts_of(mod, qual, ctx), an.scopes(mod, qual, ctx)
        for node in an.body_nodes(mod.functions[qual]):
            if isinstance(node, ast.Call):
                resolved = an.resolve(mod, qual, node)
                if resolved is not None:
                    cmod, cqual = resolved
                    todo.append((cmod, cqual, an.call_context(
                        mod, qual, node, at.get(id(node), top), cmod,
                        cqual)))
    return sorted(set(out))
