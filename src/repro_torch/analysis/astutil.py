"""Shared AST plumbing for the chiplint rule families (counterpart of
``repro/analysis/astutil.py``).

One parsed view per file (``Module``), dotted-attribute-chain
extraction, per-module import maps (so ``obs_metrics.inc`` resolves to
``repro_torch.obs.metrics.inc``), a qualname -> FunctionDef table (nested
functions and methods as ``outer.inner`` / ``Class.method``), and the
``# chiplint: ignore[rule]`` suppression scanner.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Module:
    """Parsed source file plus the derived tables every rule needs."""

    path: Path                    # absolute
    rel: str                      # root-relative posix path
    tree: ast.Module
    lines: List[str]
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    # alias -> dotted module name, for ``import numpy as np`` and
    # ``from repro_torch.obs import metrics as obs_metrics``
    module_aliases: Dict[str, str] = field(default_factory=dict)
    # name -> (module, original name), for ``from x import y [as z]``
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)


class _FunctionIndexer(ast.NodeVisitor):
    def __init__(self, mod: Module):
        self.mod = mod
        self.stack: List[str] = []

    def _visit_scope(self, node):
        self.stack.append(node.name)
        qual = ".".join(self.stack)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.mod.functions[qual] = node
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope


def load_module(path: Path, root: Path) -> Module:
    src = path.read_text()
    tree = ast.parse(src, filename=str(path))
    mod = Module(path=path, rel=path.relative_to(root).as_posix(),
                 tree=tree, lines=src.splitlines())
    _FunctionIndexer(mod).visit(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.module_aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                # an imported submodule acts as a module alias too
                mod.module_aliases.setdefault(
                    a.asname or a.name, f"{node.module}.{a.name}")
                mod.from_imports[a.asname or a.name] = (node.module, a.name)
    return mod


class ModuleCache:
    """Parse each file once per lint run (rules share the parses)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._mods: Dict[str, Module] = {}

    def get(self, rel: str) -> Optional[Module]:
        rel = Path(rel).as_posix()
        if rel not in self._mods:
            path = self.root / rel
            if not path.is_file():
                return None
            self._mods[rel] = load_module(path, self.root)
        return self._mods[rel]

    def get_by_dotted(self, dotted: str) -> Optional[Module]:
        """Resolve ``repro_torch.obs.metrics`` to its source file under
        ``src/`` (or a bare top-level layout)."""
        for prefix in ("src/", ""):
            for suffix in (".py", "/__init__.py"):
                mod = self.get(prefix + dotted.replace(".", "/") + suffix)
                if mod is not None:
                    return mod
        return None


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name-rooted chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def walk_functions(fn: ast.FunctionDef):
    """All nodes of ``fn`` excluding nested function bodies, yielded in
    source (pre)order so single-forward-pass dataflow is sound."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))[::-1]
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(list(ast.iter_child_nodes(node))[::-1])


def names_in(node: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


# ---------------------------------------------------------------------------
# Inline suppressions
# ---------------------------------------------------------------------------
_IGNORE_RE = re.compile(
    r"#\s*chiplint:\s*ignore(?:\[(?P<rules>[\w\-, ]+)\])?")


def suppressed_rules(mod: Module, line: int) -> Optional[set]:
    """Rules suppressed on source line ``line`` (1-based).

    Returns None when the line carries no chiplint comment, the empty
    set for a bare ``# chiplint: ignore`` (suppresses every rule), or
    the named rule set for ``# chiplint: ignore[rule1,rule2]``.
    """
    if not 1 <= line <= len(mod.lines):
        return None
    m = _IGNORE_RE.search(mod.lines[line - 1])
    if m is None:
        return None
    if m.group("rules") is None:
        return set()
    return {r.strip() for r in m.group("rules").split(",") if r.strip()}


def is_suppressed(mod: Module, line: int, rule: str) -> bool:
    rules = suppressed_rules(mod, line)
    if rules is None:
        return False
    return not rules or rule in rules
