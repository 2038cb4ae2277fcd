"""units — physical-unit inference from the repo's naming convention
(counterpart of ``repro/analysis/units.py``).

Quantities carry their unit as a name suffix (``mem_bytes``,
``ocs_switch_latency_s``, ``hbm_cap_gbps``, ``die_flops``...).  This
rule infers units for names and attribute reads from those suffixes,
propagates them through local assignments (simple last-writer-wins
dataflow per function), and flags

* ``+`` / ``-`` (and ``+=`` / ``-=``) between two known, different
  units — ``_bytes + _s`` is always a bug, and ``_gb + _bytes`` /
  ``_ms + _s`` are scale bugs the float math cannot catch;
* comparisons between two known, different units;
* assigning a value of one known unit to a name whose suffix declares
  another.

Multiplication/division yields an unknown unit (deriving compound
units is out of scope — ``bytes / s`` legitimately produces bandwidth),
so the rule only fires where the suffix convention makes intent
unambiguous.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import Module, ModuleCache, walk_functions
from repro_torch.analysis.findings import Finding

RULE = "units"

# suffix -> unit label (longest suffix wins: ``_gbps`` before ``_s``)
UNIT_SUFFIXES: Tuple[Tuple[str, str], ...] = (
    ("_gbps", "GB/s"),
    ("_bytes", "bytes"),
    ("_flops", "FLOPs"),
    ("_gb", "GB"),
    ("_ms", "ms"),
    ("_us", "us"),
    ("_s", "s"),
    ("_w", "W"),
)


def unit_of_name(name: str) -> Optional[str]:
    low = name.lower()
    for suffix, unit in UNIT_SUFFIXES:
        if low.endswith(suffix) and len(low) > len(suffix):
            return unit
    return None


class _UnitChecker:
    """Per-function unit inference and check pass."""

    def __init__(self, mod: Module, symbol: str, out: List[Finding]):
        self.mod = mod
        self.symbol = symbol
        self.out = out
        self.env: Dict[str, Optional[str]] = {}

    # ---------------- inference ----------------
    def unit_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return unit_of_name(node.id)
        if isinstance(node, ast.Attribute):
            return unit_of_name(node.attr)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, (ast.Add, ast.Sub)):
                lu = self.unit_of(node.left)
                ru = self.unit_of(node.right)
                if lu is not None and ru is not None and lu == ru:
                    return lu
                return lu if ru is None else ru if lu is None else None
            return None            # * / // % ** — compound units: unknown
        if isinstance(node, ast.UnaryOp):
            return self.unit_of(node.operand)
        if isinstance(node, ast.Call):
            # unit-transparent wrappers: min/max/abs/sum/float and the
            # numpy spellings reached through any module alias
            fname = None
            if isinstance(node.func, ast.Name):
                fname = node.func.id
            elif isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            if fname in ("min", "max", "abs", "sum", "float", "minimum",
                         "maximum", "where", "asarray", "broadcast_to"):
                args = [a for a in node.args
                        if not isinstance(a, ast.Starred)]
                if fname == "where" and len(args) == 3:
                    args = args[1:]       # the condition carries no unit
                units = {u for u in (self.unit_of(a) for a in args)
                         if u is not None}
                if len(units) == 1:
                    return units.pop()
            return None
        if isinstance(node, ast.IfExp):
            bu = self.unit_of(node.body)
            ou = self.unit_of(node.orelse)
            if bu == ou:
                return bu
            return None
        return None

    # ---------------- checks ----------------
    def _flag(self, node: ast.AST, what: str, lu: str, ru: str):
        self.out.append(Finding(
            path=self.mod.rel, line=node.lineno, rule=RULE,
            symbol=self.symbol,
            message=f"unit mismatch: {what} between `{lu}` and `{ru}`"))

    def check_stmt(self, node: ast.AST):
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            lu = self.unit_of(node.left)
            ru = self.unit_of(node.right)
            if lu is not None and ru is not None and lu != ru:
                op = "+" if isinstance(node.op, ast.Add) else "-"
                self._flag(node, f"`{op}`", lu, ru)
        elif isinstance(node, ast.Compare):
            units = [self.unit_of(c) for c in
                     [node.left] + list(node.comparators)]
            known = [u for u in units if u is not None]
            if len(set(known)) > 1:
                self._flag(node, "comparison", known[0],
                           next(u for u in known if u != known[0]))
        elif isinstance(node, ast.AugAssign) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            lu = self.unit_of(node.target)
            ru = self.unit_of(node.value)
            if lu is not None and ru is not None and lu != ru:
                op = "+=" if isinstance(node.op, ast.Add) else "-="
                self._flag(node, f"`{op}`", lu, ru)
        elif isinstance(node, ast.Assign):
            vu = self.unit_of(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    declared = unit_of_name(t.id)
                    if declared is not None and vu is not None \
                            and declared != vu:
                        self._flag(node, f"assignment to `{t.id}`",
                                   declared, vu)
                    self.env[t.id] = vu if declared is None else declared

    def run(self, body) -> None:
        for node in body:
            self.check_stmt(node)


def check_units(cache: ModuleCache, paths: Tuple[str, ...]) -> List[Finding]:
    out: List[Finding] = []
    for rel in paths:
        mod = cache.get(rel)
        if mod is None:
            continue
        # module level (constants etc.)
        top = _UnitChecker(mod, "<module>", out)
        top.run(list(_module_level_nodes(mod.tree)))
        # each function, statement order, with local propagation
        for qual, fn in mod.functions.items():
            checker = _UnitChecker(mod, qual, out)
            checker.run(list(walk_functions(fn)))
    return out


def _module_level_nodes(tree: ast.Module):
    """Module statements in source order, excluding function/class
    bodies (those are checked with their own local environments)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(tree))[::-1]
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(list(ast.iter_child_nodes(node))[::-1])
