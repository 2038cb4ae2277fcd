"""Lint runner: configuration, rule dispatch, suppression, reporting
(counterpart of ``repro/analysis/runner.py``, over the port's tree).

``run_lint(root, config)`` parses each target file once (shared
``ModuleCache``), runs the four rule families, drops findings whose
source line carries a matching ``# chiplint: ignore[rule]`` comment,
and returns a ``LintReport``.  Baseline diffing lives in
``repro_torch.analysis.findings``; the CLI front-end in
``repro_torch.cli``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Tuple

from repro_torch.analysis.astutil import ModuleCache, is_suppressed
from repro_torch.analysis.determinism import (METRICS_DECL_PATH,
                                              check_determinism)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.parity import (DEFAULT_PARITY_PAIRS, ParityPair,
                                         check_parity)
from repro_torch.analysis.torch_hygiene import (DEFAULT_TORCH_ENTRIES,
                                                TorchEntry,
                                                check_torch_hygiene)
from repro_torch.analysis.units import check_units

# units inference is scoped to the cost/performance model files where
# the suffix convention is the contract, not incidental naming
DEFAULT_UNITS_PATHS: Tuple[str, ...] = (
    "src/repro_torch/core/cost.py",
    "src/repro_torch/core/simulator.py",
    "src/repro_torch/core/network.py",
    "src/repro_torch/events/dag.py",
    "src/repro_torch/events/engine.py",
    "src/repro_torch/events/validate.py",
    "src/repro_torch/events/batch.py",
)

# determinism/schema scans the whole package
DEFAULT_SCAN_GLOB = "src/repro_torch/**/*.py"


@dataclass(frozen=True)
class LintConfig:
    parity_pairs: Tuple[ParityPair, ...] = DEFAULT_PARITY_PAIRS
    torch_entries: Tuple[TorchEntry, ...] = DEFAULT_TORCH_ENTRIES
    units_paths: Tuple[str, ...] = DEFAULT_UNITS_PATHS
    scan_glob: str = DEFAULT_SCAN_GLOB
    metrics_decl_path: str = METRICS_DECL_PATH


DEFAULT_CONFIG = LintConfig()


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    n_suppressed: int = 0
    n_files: int = 0


def run_lint(root, config: LintConfig = DEFAULT_CONFIG) -> LintReport:
    root = Path(root)
    cache = ModuleCache(root)
    scan_rels = sorted(
        p.relative_to(root).as_posix()
        for p in root.glob(config.scan_glob) if p.is_file())

    raw: List[Finding] = []
    raw += check_parity(cache, config.parity_pairs)
    raw += check_torch_hygiene(cache, config.torch_entries)
    raw += check_units(cache, config.units_paths)
    raw += check_determinism(cache, scan_rels, config.metrics_decl_path)

    report = LintReport(n_files=len(scan_rels))
    for f in sorted(raw):
        mod = cache.get(f.path)
        if mod is not None and is_suppressed(mod, f.line, f.rule):
            report.n_suppressed += 1
        else:
            report.findings.append(f)
    return report
