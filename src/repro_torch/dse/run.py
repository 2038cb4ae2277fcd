"""DEPRECATED CLI shim — use ``python -m repro_torch.cli`` instead.

The old batched-DSE CLI (``python -m repro_torch.dse.run --model ...
--C ...``) is subsumed by the scenario CLI; every flag it accepted is
still accepted there.  This shim keeps old invocations working: it emits
a ``DeprecationWarning`` and forwards the argv unchanged, so it produces
exactly what ``repro_torch.cli.main`` produces for the same argv.
"""
from __future__ import annotations

import sys
import warnings


def main(argv=None) -> int:
    warnings.warn(
        "repro_torch.dse.run is deprecated; use `python -m "
        "repro_torch.cli` (same flags, plus scenario JSON files)",
        DeprecationWarning, stacklevel=2)
    from repro_torch import cli
    return cli.main(argv)


if __name__ == "__main__":
    sys.exit(main())
