"""parity-drift — diff mirrored implementations of the cost model
(counterpart of ``repro/analysis/parity.py``, over the port's files).

The repo's three engines (scalar oracle, batched SoA port, event-DAG
compiler) replicate each other's cost terms operation-for-operation.
This rule makes that correspondence a STATIC invariant: for each
registered pair of mirrored function groups it extracts

* every hardware/workload/MCM/strategy attribute the group reads —
  dotted chains rooted at role-mapped parameter names (one level of
  local aliasing is followed, so ``model = w.model; model.attn.n_heads``
  records ``workload.model.attn.n_heads``), and
* every numeric literal in the group body (as a float),

then symmetric-diffs the two sides.  A model term edited on one side
without the other — a new ``hw.`` field read, a changed ``12`` -> ``13``
— is a finding AT THE LINE of the unmatched read/constant.

Known-legitimate asymmetries (vectorization plumbing like column counts
and pad fills, scalar-only conveniences like ``mcm.hw`` fallbacks) are
declared per side in the registry below, next to a reason.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import Module, ModuleCache, attr_chain
from repro_torch.analysis.findings import Finding

RULE = "parity-drift"

# literals too generic to diff (loop floors, sign flips, identity terms)
GENERIC_CONSTS = frozenset({0.0, 1.0, -1.0})

# trailing chain segments that are array/container plumbing, not model
# terms — ``batch.tp.astype(...)`` and ``s.tp`` read the same quantity
_ARRAY_METHODS = frozenset({
    "astype", "reshape", "sum", "take", "copy", "item", "tolist",
    "clip", "max", "min", "mean", "any", "all", "nonzero", "shape",
    "dtype",
})


@dataclass(frozen=True)
class ParitySide:
    """One side of a mirrored pair: a file plus the function group that
    implements the shared cost terms there."""

    path: str                              # root-relative source file
    functions: Tuple[str, ...]             # qualnames within the file
    # parameter/local name -> role ("hw", "workload", "mcm", "strategy")
    roles: Tuple[Tuple[str, str], ...] = ()
    # "role.dotted.path" reads that legitimately have no counterpart
    ignore_attrs: Tuple[str, ...] = ()
    # numeric literals that legitimately have no counterpart
    ignore_consts: Tuple[float, ...] = ()
    # descend into nested defs (closure-heavy sides like the DAG
    # compiler put model terms inside local helpers)
    include_nested: bool = False

    def role_map(self) -> Dict[str, str]:
        return dict(self.roles)


@dataclass(frozen=True)
class ParityPair:
    name: str
    a: ParitySide
    b: ParitySide
    check_attrs: bool = True
    check_consts: bool = True


@dataclass
class SideFacts:
    """Extraction result: first-occurrence site per attr chain/const."""

    attrs: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    consts: Dict[float, Tuple[str, int]] = field(default_factory=dict)
    missing: List[str] = field(default_factory=list)   # unresolved funcs


class _SideVisitor(ast.NodeVisitor):
    """Collects maximal role-rooted attribute chains and numeric
    literals from one function body, following one level of pure-chain
    local aliases (``moe = model.moe``)."""

    def __init__(self, mod: Module, facts: SideFacts, roles: Dict[str, str],
                 descend_nested: bool = False):
        self.descend_nested = descend_nested
        self.mod = mod
        self.facts = facts
        # name -> role-rooted dotted prefix, e.g. {"w": "workload",
        # "model": "workload.model"}
        self.env: Dict[str, str] = dict(roles)
        # declared role names are sticky: ``mb = _mcm_params(mcm)`` and
        # ``hw = mcm.hw`` REFRESH the role, they don't retire it
        self.declared = set(roles)

    def _record_chain(self, node: ast.Attribute) -> bool:
        chain = attr_chain(node)
        if chain is None or chain[0] not in self.env:
            return False
        parts = [self.env[chain[0]]] + chain[1:]
        while len(parts) > 1 and parts[-1] in _ARRAY_METHODS:
            parts.pop()
        if len(parts) > 1:
            dotted = ".".join(parts)
            self.facts.attrs.setdefault(dotted, (self.mod.rel, node.lineno))
        return True

    def visit_Attribute(self, node: ast.Attribute):
        if not self._record_chain(node):
            # not role-rooted: descend (there may be a rooted chain
            # inside, e.g. ``f(mcm.hbm_bw).x``)
            self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        # alias tracking: single Name target bound to a pure role chain
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            if tgt in self.declared:
                return          # declared roles are never rebound
            chain = attr_chain(node.value)
            if chain is not None and chain[0] in self.env:
                self.env[tgt] = ".".join([self.env[chain[0]]] + chain[1:])
            elif tgt in self.env and not (
                    isinstance(node.value, ast.Name)
                    and node.value.id == tgt):
                # a derived alias rebound to something non-role-rooted
                # goes stale
                del self.env[tgt]
        else:
            for t in node.targets:
                self.visit(t)

    def visit_Constant(self, node: ast.Constant):
        v = node.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return
        v = float(v)
        if v in GENERIC_CONSTS:
            return
        self.facts.consts.setdefault(v, (self.mod.rel, node.lineno))

    def visit_FunctionDef(self, node):
        if self.descend_nested:           # closures share the role names
            for stmt in node.body:
                self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef


def extract_side(cache: ModuleCache, side: ParitySide) -> SideFacts:
    facts = SideFacts()
    mod = cache.get(side.path)
    if mod is None:
        facts.missing.append(f"{side.path} (file not found)")
        return facts
    for qual in side.functions:
        fn = mod.functions.get(qual)
        if fn is None:
            facts.missing.append(f"{side.path}::{qual}")
            continue
        v = _SideVisitor(mod, facts, side.role_map(),
                         descend_nested=side.include_nested)
        for stmt in fn.body:
            v.visit(stmt)
    return facts


def _fmt_const(v: float) -> str:
    return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)


def check_pair(cache: ModuleCache, pair: ParityPair) -> List[Finding]:
    fa = extract_side(cache, pair.a)
    fb = extract_side(cache, pair.b)
    out: List[Finding] = []
    for side, facts in ((pair.a, fa), (pair.b, fb)):
        for miss in facts.missing:
            out.append(Finding(
                path=side.path, line=1, rule=RULE, symbol=pair.name,
                message=f"registered parity function not found: {miss}"))
    if fa.missing or fb.missing:
        return out

    def one_way(facts_have: SideFacts, side_have: ParitySide,
                side_lack: ParitySide, facts_lack: SideFacts):
        if pair.check_attrs:
            for dotted, (rel, line) in sorted(facts_have.attrs.items()):
                if dotted in side_have.ignore_attrs:
                    continue
                if dotted not in facts_lack.attrs:
                    out.append(Finding(
                        path=rel, line=line, rule=RULE, symbol=pair.name,
                        message=f"model term drift: attribute `{dotted}` "
                                f"is read here but not by the mirrored "
                                f"side ({side_lack.path})"))
        if pair.check_consts:
            ignore = set(side_have.ignore_consts)
            for v, (rel, line) in sorted(facts_have.consts.items()):
                if v in ignore:
                    continue
                if v not in facts_lack.consts:
                    out.append(Finding(
                        path=rel, line=line, rule=RULE, symbol=pair.name,
                        message=f"model term drift: constant "
                                f"`{_fmt_const(v)}` appears here but not "
                                f"on the mirrored side ({side_lack.path})"))

    one_way(fa, pair.a, pair.b, fb)
    one_way(fb, pair.b, pair.a, fa)
    return out


def check_parity(cache: ModuleCache, pairs: Tuple[ParityPair, ...]
                 ) -> List[Finding]:
    out: List[Finding] = []
    for pair in pairs:
        out.extend(check_pair(cache, pair))
    return out


# ---------------------------------------------------------------------------
# The repository's mirrored-pair registry
# ---------------------------------------------------------------------------
# Roles shared by the scalar oracle side
_SCAL_SIM = (("w", "workload"), ("s", "strategy"), ("mcm", "mcm"),
             ("hw", "hw"))
_BATCH_ROLES = (("w", "workload"), ("batch", "strategy"), ("mb", "mcm"),
                ("mcm", "mcm"), ("hw", "hw"))

DEFAULT_PARITY_PAIRS: Tuple[ParityPair, ...] = (
    # ---- traffic model: scalar dict vs SoA columns ---------------------
    ParityPair(
        name="traffic_volumes",
        a=ParitySide(
            path="src/repro_torch/core/traffic.py",
            functions=("traffic_volumes",),
            roles=(("w", "workload"), ("s", "strategy")),
        ),
        b=ParitySide(
            path="src/repro_torch/dse/batched_sim.py",
            functions=("traffic_volumes_batch",),
            roles=(("w", "workload"), ("batch", "strategy")),
            # SoA plumbing: the (B, 5) column count
            ignore_consts=(5.0,),
        ),
    ),
    # ---- intra-MCM packing --------------------------------------------
    ParityPair(
        name="map_intra",
        a=ParitySide(
            path="src/repro_torch/core/simulator.py",
            functions=("map_intra",),
            roles=(("mcm", "mcm"),),
        ),
        b=ParitySide(
            path="src/repro_torch/dse/batched_sim.py",
            functions=("map_intra_batch",),
            roles=(("mcm", "mcm"),),
        ),
        # degrees flow through dicts on one side and P_IDX columns on the
        # other; only the mcm reads and the literals are comparable
    ),
    # ---- GEMM shape efficiency ----------------------------------------
    ParityPair(
        name="gemm_eff",
        a=ParitySide(
            path="src/repro_torch/core/simulator.py",
            functions=("_gemm_eff",),
            roles=(("w", "workload"), ("s", "strategy"), ("hw", "hw")),
        ),
        b=ParitySide(
            path="src/repro_torch/dse/batched_sim.py",
            functions=("gemm_eff_batch",),
            roles=(("w", "workload"), ("batch", "strategy"), ("hw", "hw")),
        ),
    ),
    # ---- OI link allocation -------------------------------------------
    ParityPair(
        name="allocate_links",
        a=ParitySide(
            path="src/repro_torch/core/network.py",
            functions=("allocate_links",),
        ),
        b=ParitySide(
            path="src/repro_torch/dse/batched_sim.py",
            functions=("allocate_links_batch", "_trim_over_budget"),
            # 8: bounded trim-pass count (scalar side loops unbounded)
            ignore_consts=(8.0,),
        ),
    ),
    # ---- the full step-time model: scalar oracle vs batched SoA -------
    ParityPair(
        name="simulate~batched",
        a=ParitySide(
            path="src/repro_torch/core/simulator.py",
            functions=("simulate", "_bank_swap_reuse_ok"),
            roles=_SCAL_SIM,
            ignore_attrs=(
                # scalar conveniences with no batched counterpart:
                "mcm.hw",                  # hw fallback (explicit in batch)
                "mcm.intra_ring_bw",       # inlined as nop_bw/dilution
                "strategy.n_devices",      # precomputed batch column
                "strategy.degree",         # per-point dict lookup
            ),
            ignore_consts=(
                1e9,                       # GB formatting in reason strings
            ),
        ),
        b=ParitySide(
            path="src/repro_torch/dse/batched_sim.py",
            functions=("batched_simulate", "_terms_core",
                       "hbm_demand_batch", "pick_reuse_pairs",
                       "_ceil_log2_int"),
            roles=_BATCH_ROLES,
            ignore_attrs=(
                # batched-only surfaces (board power, railx, SoA access)
                "mcm.m", "mcm.n_mcm",      # board-power model (scalar
                                           # twin lives in board_power())
                "hw.ocs_ports",            # railx alloc_mode only
                "strategy.n_devices", "strategy.tp", "strategy.dp",
                "strategy.pp", "strategy.cp", "strategy.ep",
                "strategy.n_micro", "strategy.take",
                "workload.step_flops",     # also read via scalar's w
                # the scalar twin is the mcm.intra_ring_bw(deg) method
                # (ignored on the a side); the SoA carries it as nop_bw
                "mcm.nop_bw",
            ),
            ignore_consts=(
                5.0,                       # (B, 5) parallelism columns
                8.0,                       # also _bucket floor; real 8 is
                                           # matched via inv["TP"]
                3.0,                       # _bucket floor exponent
                64.0,                      # frexp mantissa bits plumbing
            ),
        ),
    ),
    # ---- event-DAG unit costs vs the scalar oracle --------------------
    ParityPair(
        name="simulate~events_dag",
        a=ParitySide(
            path="src/repro_torch/core/simulator.py",
            functions=("simulate",),
            roles=_SCAL_SIM,
            ignore_attrs=(
                "mcm.hw",
                "strategy.n_devices",
                # the DAG replays points simulate() already gated; the
                # capacity check has no replay-side twin
                "mcm.hbm_capacity",
            ),
            ignore_consts=(1e9,),
        ),
        b=ParitySide(
            path="src/repro_torch/events/dag.py",
            functions=("compile_step",),
            roles=_SCAL_SIM,
            ignore_attrs=(
                "mcm.hw",
                "strategy.degree",
                "workload.step_flops",
            ),
            # model terms live in compile_step's local closures
            include_nested=True,
        ),
        # the DAG side splits tiles/shares with schedule-only constants;
        # constants are checked via the dedicated ignore lists below
        check_consts=False,
    ),
    # ---- vectorized record->program compiler vs the scalar DAG walk ---
    # compile_batch replicates compile_step's spans/collectives in SoA
    # form (runtime twins: tests/test_torch_events.py holds each against
    # the reference's); a unit cost edited on one side without the other
    # drifts here
    ParityPair(
        name="compile_step~compile_batch",
        a=ParitySide(
            path="src/repro_torch/events/dag.py",
            functions=("compile_step",),
            roles=_SCAL_SIM,
            ignore_attrs=(
                "mcm.hw",
                "strategy.degree",          # per-point dict lookup
                # the batch reads these via hbm_demand_batch's
                # local_params column
                "workload.nonexpert_params",
                "workload.expert_params",
                # the scalar twin is the mcm.intra_ring_bw(deg) method;
                # the SoA carries it as nop_bw + explicit dilution
                "mcm.intra_ring_bw",
            ),
            include_nested=True,
        ),
        b=ParitySide(
            path="src/repro_torch/events/compile_batch.py",
            functions=("compile_batch", "_compile_group"),
            roles=_BATCH_ROLES,
            ignore_attrs=(
                "mcm.hw",
                # feasibility gating: compile_step only sees points
                # simulate() already gated and raises otherwise; the
                # batch marks the row infeasible instead
                "strategy.n_devices",
                "mcm.hbm_capacity",
                "mcm.nop_bw",               # intra_ring_bw twin (above)
            ),
            # closed-form spans live in the node_span local closure
            include_nested=True,
        ),
        # schedule constants (tile splits, shares) differ structurally:
        # the DAG walk builds per-op tasks, the batch the closed form
        check_consts=False,
    ),
)
