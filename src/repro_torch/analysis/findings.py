"""Finding model, JSON report shape, and the grandfathered baseline
(counterpart of ``repro/analysis/findings.py``).

A finding's FINGERPRINT deliberately excludes the line number: baselined
findings stay matched while unrelated edits shift code around, and a
duplicate message in the same file counts per occurrence (the baseline
is a multiset of fingerprints).  Each baseline entry carries the reason
it is grandfathered: ``{"fingerprint": ..., "reason": ...}`` (a bare
fingerprint string, the reference's form, reads as one without a
reason).
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

REPORT_SCHEMA = 1
BASELINE_SCHEMA = 1
DEFAULT_BASELINE = "chiplint_torch_baseline.json"


@dataclass(frozen=True, order=True)
class Finding:
    path: str          # root-relative posix path
    line: int          # 1-based
    rule: str          # "parity-drift" | "torch-hygiene" | "units" | ...
    message: str
    symbol: str = ""   # enclosing function / parity-pair name

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}::{self.message}"

    def render(self) -> str:
        sym = f" ({self.symbol})" if self.symbol else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{sym}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message, "symbol": self.symbol}


def report_dict(findings: List[Finding], new: List[Finding],
                stale: List[str], n_suppressed: int,
                n_files: int) -> dict:
    """The machine-readable report ``cli lint --json`` writes."""
    return {
        "schema": REPORT_SCHEMA,
        "tool": "chiplint",
        "n_files": n_files,
        "n_findings": len(findings),
        "n_suppressed": n_suppressed,
        "n_new": len(new),
        "n_stale_baseline": len(stale),
        "findings": [f.to_dict() for f in sorted(findings)],
        "new": [f.to_dict() for f in sorted(new)],
        "stale_baseline": sorted(stale),
    }


# ---------------------------------------------------------------------------
# Baseline I/O + diff
# ---------------------------------------------------------------------------
def _entries(path) -> List[dict]:
    p = Path(path)
    if not p.is_file():
        return []
    data = json.loads(p.read_text())
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"unsupported baseline schema in {p}: "
                         f"{data.get('schema')!r}")
    return [e if isinstance(e, dict) else {"fingerprint": e, "reason": ""}
            for e in data.get("findings", [])]


def load_baseline(path) -> Counter:
    """Multiset of grandfathered fingerprints ({} when absent)."""
    return Counter(e["fingerprint"] for e in _entries(path))


def load_baseline_reasons(path) -> Dict[str, str]:
    """fingerprint -> the reason its entry gives ("" for none)."""
    return {e["fingerprint"]: e.get("reason", "") for e in _entries(path)}


def save_baseline(path, findings: List[Finding],
                  reasons: Optional[Dict[str, str]] = None) -> Path:
    """Write ``findings`` as the baseline, each entry with its reason from
    ``reasons`` ("" where it names none: whoever grandfathers a finding
    writes why)."""
    p = Path(path)
    reasons = reasons or {}
    entries = [{"fingerprint": fp, "reason": reasons.get(fp, "")}
               for fp in sorted(f.fingerprint for f in findings)]
    p.write_text(json.dumps({"schema": BASELINE_SCHEMA, "tool": "chiplint",
                             "findings": entries}, indent=1) + "\n")
    return p


def diff_baseline(findings: List[Finding], baseline: Counter
                  ) -> Tuple[List[Finding], List[str]]:
    """(new findings not covered by the baseline, stale baseline
    fingerprints with no matching finding).  Both must be empty for the
    tree to be baseline-exact."""
    current: Dict[str, List[Finding]] = {}
    for f in findings:
        current.setdefault(f.fingerprint, []).append(f)
    new: List[Finding] = []
    for fp, fs in current.items():
        allowed = baseline.get(fp, 0)
        if len(fs) > allowed:
            new.extend(sorted(fs)[allowed:])
    stale: List[str] = []
    for fp, n in baseline.items():
        have = len(current.get(fp, []))
        stale.extend([fp] * max(n - have, 0))
    return sorted(new), sorted(stale)
