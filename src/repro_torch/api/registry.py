"""Registries for search drivers and study objectives (DESIGN.md §repro_torch.api).

New scenarios plug in new drivers/objectives by registering here — engine
code (``repro_torch.core``, ``repro_torch.dse``) is never touched.  Lookup errors name
the unknown key and the registered alternatives, so a typo in a scenario
JSON fails with one clear line instead of a deep traceback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List


class Registry:
    """Name -> entry mapping with decorator registration + clear errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, object] = {}

    def register(self, name: str) -> Callable:
        if name in self._items:
            raise ValueError(f"{self.kind} {name!r} already registered")

        def deco(obj):
            self._items[name] = obj
            return obj
        return deco

    def get(self, name: str):
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{sorted(self._items)}") from None

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))


# ---------------------------------------------------------------------------
# Objectives — a named metric of a DesignRecord plus its direction
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Objective:
    metric: str            # key into DesignRecord.metrics
    maximize: bool
    units: str = ""


OBJECTIVES = Registry("objective")
OBJECTIVES.register("throughput")(Objective("throughput", True, "tok/s"))
OBJECTIVES.register("cost")(Objective("cost", False, "$"))
OBJECTIVES.register("power")(Objective("power", False, "W"))
OBJECTIVES.register("step_time")(Objective("step_time", False, "s"))
OBJECTIVES.register("mfu")(Objective("mfu", True))


# ---------------------------------------------------------------------------
# Drivers — a runner ``(Scenario, device) -> StudyResult`` per search
# engine.  Runners live in repro_torch.api.study; lazy imports keep
# registration free of import cycles (scenario validation needs the names
# at class-build time).
# ---------------------------------------------------------------------------
DRIVERS = Registry("driver")


def _batched(name: str):
    def run(scenario, device):
        from repro_torch.api.study import _run_batched
        return _run_batched(scenario, name, device)
    run.__name__ = f"run_{name}"
    return run


for _name in ("exhaustive", "random", "prf", "nsga2"):
    DRIVERS.register(_name)(_batched(_name))


@DRIVERS.register("chiplight-outer")
def _run_chiplight_outer(scenario, device):
    from repro_torch.api.study import _run_outer
    return _run_outer(scenario, device)


@DRIVERS.register("railx")
def _run_railx_driver(scenario, device):
    from repro_torch.api.study import _run_railx
    return _run_railx(scenario, device)
