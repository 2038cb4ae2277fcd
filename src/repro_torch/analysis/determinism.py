"""determinism/schema — reproducibility and frozen-schema invariants
(counterpart of ``repro/analysis/determinism.py``).

Three checks, all repo-wide over ``src/repro_torch``:

* ``global-rng``      — use of the process-global RNG state (stdlib
  ``random.x(...)``, legacy ``np.random.x(...)``, or torch's global
  generator: a draw — ``torch.rand``/``randn``/``randint``/``randperm``/
  ``normal``/``bernoulli``/``multinomial``, their ``_like`` forms, or an
  in-place ``t.normal_(...)``-style fill — without a ``generator=``
  keyword, and ``torch.manual_seed``/``torch.seed``): studies and models
  must thread a seeded ``np.random.default_rng`` / ``random.Random`` /
  ``torch.Generator`` so two runs of the same config are bit-identical
  (a call that forwards ``**kwargs`` may pass the generator, and is not
  flagged);
* ``frozen-mutation`` — attribute assignment on an instance of a
  ``@dataclass(frozen=True)`` class (raises ``FrozenInstanceError`` at
  runtime; these only hide in dormant code paths);
* ``unknown-metric``  — a literal metric name passed to
  ``obs.metrics.inc``/``gauge`` that is not declared in the
  ``KNOWN_COUNTERS`` / ``KNOWN_GAUGES`` registries of
  ``repro_torch/obs/metrics.py`` (the registries are read via AST, not
  imported, so the linter works on a broken tree too).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (Module, ModuleCache, attr_chain,
                                    walk_functions)
from repro_torch.analysis.findings import Finding

RULE = "determinism"

METRICS_DECL_PATH = "src/repro_torch/obs/metrics.py"

# random.X spellings that are fine without a seeded generator object
_RANDOM_OK = frozenset({"Random", "SystemRandom"})
# np.random.X spellings that construct/describe generators, not draws
_NP_RANDOM_OK = frozenset({"default_rng", "Generator", "SeedSequence",
                           "BitGenerator", "PCG64", "Philox", "MT19937",
                           "RandomState"})
# torch.X draws from the global generator unless given ``generator=``
_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "normal",
                          "bernoulli", "multinomial", "rand_like",
                          "randn_like", "randint_like", "poisson"})
# torch.X calls that (re)seed the global generator
_TORCH_SEEDS = frozenset({"manual_seed", "seed"})
# in-place tensor fills that draw from the global generator unless given
# ``generator=``
_INPLACE_DRAWS = frozenset({"normal_", "uniform_", "bernoulli_", "random_",
                            "exponential_", "geometric_", "cauchy_",
                            "log_normal_"})


# ---------------------------------------------------------------------------
# metric-name registries (read statically from the metrics module)
# ---------------------------------------------------------------------------
def load_declared_metrics(cache: ModuleCache,
                          decl_path: str = METRICS_DECL_PATH
                          ) -> Optional[Tuple[Set[str], Set[str]]]:
    mod = cache.get(decl_path)
    if mod is None:
        return None
    decls: Dict[str, Set[str]] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name) or target.id not in (
                "KNOWN_COUNTERS", "KNOWN_GAUGES"):
            continue
        names: Set[str] = set()
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                names.add(sub.value)
        decls[target.id] = names
    if "KNOWN_COUNTERS" not in decls or "KNOWN_GAUGES" not in decls:
        return None
    return decls["KNOWN_COUNTERS"], decls["KNOWN_GAUGES"]


def _metrics_aliases(mod: Module) -> Set[str]:
    """Local names that refer to the ``repro_torch.obs.metrics`` module
    (or the reference's)."""
    out = set()
    for alias, dotted in mod.module_aliases.items():
        if dotted in ("repro_torch.obs.metrics", "repro.obs.metrics",
                      "obs.metrics", "metrics"):
            out.add(alias)
    for alias, (src, name) in mod.from_imports.items():
        if name == "metrics" and src.endswith("obs"):
            out.add(alias)
    return out


# ---------------------------------------------------------------------------
# frozen dataclass registry
# ---------------------------------------------------------------------------
def _frozen_classes(mod: Module) -> Set[str]:
    frozen: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            if not (isinstance(dec, ast.Call)
                    and (chain := attr_chain(dec.func)) is not None
                    and chain[-1] == "dataclass"):
                continue
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    frozen.add(node.name)
    return frozen


def collect_frozen_classes(cache: ModuleCache, rels: List[str]) -> Set[str]:
    """Names of all @dataclass(frozen=True) classes across the tree.
    Names are collected unqualified: the repo keeps dataclass names
    unique, and a rare collision only widens the check."""
    out: Set[str] = set()
    for rel in rels:
        mod = cache.get(rel)
        if mod is not None:
            out |= _frozen_classes(mod)
    return out


def _frozen_locals(fn: ast.FunctionDef, frozen: Set[str]) -> Set[str]:
    """Local names bound to a construction of a frozen class, or
    annotated/defaulted as one (parameters with a frozen-class
    annotation count)."""
    names: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if ann is not None:
            for sub in ast.walk(ann):
                if isinstance(sub, ast.Name) and sub.id in frozen:
                    names.add(a.arg)
                elif isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str) \
                        and sub.value in frozen:
                    names.add(a.arg)
    for node in walk_functions(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = node.value.func
            cname = callee.id if isinstance(callee, ast.Name) else (
                callee.attr if isinstance(callee, ast.Attribute) else None)
            if cname in frozen:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
def check_determinism(cache: ModuleCache, rels: List[str],
                      decl_path: str = METRICS_DECL_PATH) -> List[Finding]:
    out: List[Finding] = []
    declared = load_declared_metrics(cache, decl_path)
    frozen = collect_frozen_classes(cache, rels)

    for rel in rels:
        mod = cache.get(rel)
        if mod is None:
            continue
        m_aliases = _metrics_aliases(mod)
        _check_module(mod, m_aliases, declared, frozen, out,
                      is_decl_module=(rel == decl_path))
    return out


def _check_module(mod: Module, m_aliases: Set[str],
                  declared: Optional[Tuple[Set[str], Set[str]]],
                  frozen: Set[str], out: List[Finding],
                  is_decl_module: bool) -> None:
    # resolve aliases for the random modules in this file
    rng_roots: Dict[str, str] = {}   # local alias -> random|numpy|torch
    for alias, dotted in mod.module_aliases.items():
        if dotted in ("random", "torch"):
            rng_roots[alias] = dotted
        elif dotted in ("numpy", "numpy.random") \
                or dotted.startswith("numpy."):
            rng_roots[alias] = dotted

    for node in ast.walk(mod.tree):
        # ---- global-rng ----
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            torch_rng = _torch_global_rng(node, chain, rng_roots)
            if torch_rng is not None:
                out.append(Finding(
                    path=mod.rel, line=node.lineno, rule=RULE,
                    symbol=_enclosing(mod, node),
                    message=f"global-rng: {torch_rng}"))
            elif chain and chain[0] in rng_roots \
                    and rng_roots[chain[0]] != "torch":
                dotted = rng_roots[chain[0]]
                full = dotted.split(".") + chain[1:] if dotted != "random" \
                    else chain
                if dotted == "random" and len(chain) == 2 \
                        and chain[1] not in _RANDOM_OK:
                    out.append(Finding(
                        path=mod.rel, line=node.lineno, rule=RULE,
                        symbol=_enclosing(mod, node),
                        message=f"global-rng: `random.{chain[1]}(...)` "
                                f"draws from the process-global RNG; "
                                f"thread a seeded `random.Random`"))
                elif ".".join(full[:2]) == "numpy.random" \
                        and len(full) >= 3 \
                        and full[2] not in _NP_RANDOM_OK:
                    out.append(Finding(
                        path=mod.rel, line=node.lineno, rule=RULE,
                        symbol=_enclosing(mod, node),
                        message=f"global-rng: `np.random.{full[2]}(...)` "
                                f"uses numpy's legacy global state; use "
                                f"a seeded `np.random.default_rng`"))

            # ---- unknown-metric ----
            if declared is not None and not is_decl_module and chain \
                    and len(chain) >= 2 and chain[-1] in ("inc", "gauge") \
                    and chain[-2] in m_aliases:
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    name = node.args[0].value
                    known = declared[0] if chain[-1] == "inc" \
                        else declared[1]
                    kind = "counter" if chain[-1] == "inc" else "gauge"
                    if name not in known:
                        out.append(Finding(
                            path=mod.rel, line=node.lineno, rule=RULE,
                            symbol=_enclosing(mod, node),
                            message=f"unknown-metric: {kind} "
                                    f"`{name}` is not declared in "
                                    f"obs.metrics.KNOWN_"
                                    f"{'COUNTERS' if kind == 'counter' else 'GAUGES'}"))

    # ---- frozen-mutation ----
    for qual, fn in mod.functions.items():
        local_frozen = _frozen_locals(fn, frozen)
        # methods of a frozen class may not assign to self outside
        # object.__setattr__ — find the owning class
        cls = qual.split(".")[0] if "." in qual else None
        if cls in frozen and fn.name != "__new__":
            local_frozen = local_frozen | {"self"}
        if not local_frozen:
            continue
        for node in walk_functions(fn):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in local_frozen:
                    out.append(Finding(
                        path=mod.rel, line=t.lineno, rule=RULE,
                        symbol=qual,
                        message=f"frozen-mutation: assignment to "
                                f"`{t.value.id}.{t.attr}` on a frozen "
                                f"dataclass instance raises "
                                f"FrozenInstanceError at runtime"))


def _torch_global_rng(node: ast.Call, chain: Optional[List[str]],
                      rng_roots: Dict[str, str]) -> Optional[str]:
    """What a call does with torch's global generator, or None."""
    kws = {kw.arg for kw in node.keywords}
    if "generator" in kws or None in kws:      # given, or maybe via **kw
        return None
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _INPLACE_DRAWS:
        return (f"`.{func.attr}(...)` fills from torch's global "
                f"generator; pass `generator=` a seeded `torch.Generator`")
    if not chain or rng_roots.get(chain[0]) != "torch" or len(chain) < 2:
        return None
    name, where = chain[-1], ".".join(["torch"] + chain[1:])
    if len(chain) == 2 and name in _TORCH_DRAWS:
        return (f"`{where}(...)` draws from torch's global generator; "
                f"pass `generator=` a seeded `torch.Generator`")
    if name in _TORCH_SEEDS or name == "manual_seed_all":
        return (f"`{where}(...)` seeds torch's process-global generator; "
                f"thread a seeded `torch.Generator`")
    return None


def _enclosing(mod: Module, node: ast.AST) -> str:
    """Best-effort enclosing function qualname for a node (by line
    range); '<module>' when at top level."""
    best = "<module>"
    best_span = None
    for qual, fn in mod.functions.items():
        end = getattr(fn, "end_lineno", None) or fn.lineno
        if fn.lineno <= node.lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = qual, span
    return best
