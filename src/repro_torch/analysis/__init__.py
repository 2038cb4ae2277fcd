"""chiplint on the port (counterpart of ``repro/analysis``) — AST-based
invariant analyzer for ``src/repro_torch``.

Four rule families guard the invariants the runtime parity tests can
only sample:

* ``parity-drift``   — mirrored scalar/batched/event implementations of
                       the cost model must read the same hardware /
                       workload attributes and use the same numeric
                       constants (``repro_torch.analysis.parity``);
* ``torch-hygiene``  — functions reachable from the entry points that
                       run on the card must not make the host wait for
                       it: no ``.item()``/``.tolist()``/``float()`` of
                       tensor data, no Python branch on it, no result
                       sized by it, no unhashable defaults
                       (``repro_torch.analysis.torch_hygiene``; it takes
                       the place of the reference's ``jax-hygiene``);
* ``units``          — physical quantities named by the repo's suffix
                       convention (``_bytes``/``_s``/``_flops``/...)
                       must not be added, subtracted, or compared
                       across units (``repro_torch.analysis.units``);
* ``determinism``    — no unseeded global RNG use (torch's global
                       generator included), no mutation of frozen
                       dataclasses, and every metrics key must be
                       declared in the frozen ``obs.metrics`` schema
                       (``repro_torch.analysis.determinism``).

Run via ``python -m repro_torch.cli lint`` (no card needed); the
grandfathered findings, each with its reason, are in
``chiplint_torch_baseline.json``.
"""
from repro_torch.analysis.findings import (Finding, diff_baseline,
                                           load_baseline,
                                           load_baseline_reasons,
                                           save_baseline)
from repro_torch.analysis.parity import (DEFAULT_PARITY_PAIRS, ParityPair,
                                         ParitySide)
from repro_torch.analysis.runner import (DEFAULT_CONFIG, LintConfig,
                                         LintReport, run_lint)
from repro_torch.analysis.torch_hygiene import (DEFAULT_TORCH_ENTRIES,
                                                TorchEntry)

__all__ = [
    "Finding", "load_baseline", "load_baseline_reasons", "save_baseline",
    "diff_baseline", "ParityPair", "ParitySide", "DEFAULT_PARITY_PAIRS",
    "TorchEntry", "DEFAULT_TORCH_ENTRIES",
    "LintConfig", "LintReport", "DEFAULT_CONFIG", "run_lint",
]
