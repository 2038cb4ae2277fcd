"""``Scenario`` — the one declarative, serializable study spec.

A scenario composes everything a cross-layer study needs: workload (model
name + shape + ``Workload`` byte-format overrides), compute budget C, the
MCM variant grid (dies/m/cpo), fabrics, ``HW`` constant overrides,
objectives, the search driver and its knobs, and a seed.  It is frozen,
validated at construction, and round-trips exactly through
``to_dict``/``from_dict`` (and JSON files under ``scenarios/``), so a
study definition is a first-class artifact that can be swept, stored and
compared — see DESIGN.md §repro_torch.api.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Tuple

from repro_torch.api.registry import DRIVERS, OBJECTIVES
from repro_torch.core.hardware import DEFAULT_HW, HW
from repro_torch.core.workload import Workload
from repro_torch.dse.space import FABRICS, DesignSpace

SCENARIO_SCHEMA = 1

_HW_FIELDS = {f.name for f in dataclasses.fields(HW)}
_WORKLOAD_OVERRIDES = {"bytes_act", "bytes_grad", "bytes_param"}


def _grid(name: str, values, conv) -> Tuple:
    """Validated grid axis: non-empty, converted, duplicate-free."""
    if isinstance(values, (str, bytes)) or not hasattr(values, "__iter__"):
        raise ValueError(f"{name} must be a list/tuple, got {values!r}")
    vals = tuple(conv(v) for v in values)
    if not vals:
        raise ValueError(f"{name} must not be empty")
    if len(set(vals)) != len(vals):
        raise ValueError(f"{name} has duplicate entries: {list(vals)}")
    return vals


@dataclass(frozen=True, eq=True)
class Scenario:
    """Declarative spec of one design-space study (frozen, validated)."""

    # -- workload --------------------------------------------------------
    model: str                                  # arch id (repro_torch.configs)
    total_tflops: float                         # cluster compute C
    seq_len: int = 10240
    global_batch: int = 512
    workload: Dict[str, Any] = field(default_factory=dict)  # byte formats

    # -- hardware grid ---------------------------------------------------
    dies_per_mcm: Tuple[int, ...] = (8, 16, 32)
    m: Tuple[int, ...] = (2, 4, 6, 8, 12)
    cpo_ratio: Tuple[float, ...] = (0.3, 0.6, 0.9)
    fabrics: Tuple[str, ...] = ("oi",)
    reuse: bool = True
    hw: Dict[str, Any] = field(default_factory=dict)        # HW overrides
    # path to a CALIB.json artifact (repro_torch.calib): ``build_hw``
    # starts from ``HW.calibrated(...)`` — the measured effective
    # constants — instead of DEFAULT_HW ("" = off).  Explicit ``hw``
    # overrides still win on top; ``Study.run`` stamps the constants
    # into ``StudyResult.provenance["calibration"]``.
    calibration: str = ""

    # -- search ----------------------------------------------------------
    objectives: Tuple[str, ...] = ("throughput", "cost", "power")
    driver: str = "exhaustive"
    driver_kw: Dict[str, Any] = field(default_factory=dict)
    refine_top: int = 8            # scalar-oracle refinement of winners
    keep_top: int = 256            # records kept in StudyResult (0 = all)
    # event-driven validation (repro_torch.events): replay the top-K records
    # and stamp validated_step_time / fidelity_err (0 = off)
    validate_top: int = 0
    # pipeline schedule(s) the event engine uses: one schedule name, a
    # comma list ("1f1b,interleaved"), or "search" (all schedules).
    # More than one candidate turns on Study.run()'s event re-rank
    # stage; the ONE source of truth for every event-engine consumer
    # (validate_top stamping, the outer driver's event_replay hook).
    schedule: str = "gpipe"
    # the reference's array backend (numpy|jax|auto): validated so that
    # its scenario files load unchanged, recorded in provenance, and
    # chooses nothing here — the port runs torch on the device that
    # ``Study.run(device=...)`` names
    backend: str = "numpy"
    seed: int = 0
    name: str = ""                 # study label (defaults to model)

    # ------------------------------------------------------------------
    def __post_init__(self):
        from repro_torch.configs import canonical_arch
        set_ = lambda k, v: object.__setattr__(self, k, v)
        set_("model", canonical_arch(self.model))
        set_("name", self.name or self.model)
        set_("total_tflops", float(self.total_tflops))
        if self.total_tflops <= 0:
            raise ValueError(f"total_tflops must be > 0, "
                             f"got {self.total_tflops}")
        for k in ("seq_len", "global_batch"):
            if int(getattr(self, k)) < 1:
                raise ValueError(f"{k} must be >= 1, got {getattr(self, k)}")

        set_("dies_per_mcm", _grid("dies_per_mcm", self.dies_per_mcm, int))
        set_("m", _grid("m", self.m, int))
        set_("cpo_ratio", _grid("cpo_ratio", self.cpo_ratio, float))
        if min(self.dies_per_mcm) < 1 or min(self.m) < 1:
            raise ValueError("dies_per_mcm and m entries must be >= 1")
        if not all(0.0 < r <= 1.0 for r in self.cpo_ratio):
            raise ValueError(f"cpo_ratio entries must be in (0, 1], "
                             f"got {list(self.cpo_ratio)}")

        set_("fabrics", _grid("fabrics", self.fabrics, str))
        bad = [f for f in self.fabrics if f not in FABRICS]
        if bad:
            raise ValueError(f"unknown fabrics {bad}; known: {list(FABRICS)}")

        set_("objectives", _grid("objectives", self.objectives, str))
        for o in self.objectives:
            OBJECTIVES.get(o)               # KeyError lists known names
        DRIVERS.get(self.driver)

        set_("workload", dict(self.workload))
        bad = sorted(set(self.workload) - _WORKLOAD_OVERRIDES)
        if bad:
            raise ValueError(f"unknown workload overrides {bad}; "
                             f"allowed: {sorted(_WORKLOAD_OVERRIDES)}")
        set_("hw", dict(self.hw))
        bad = sorted(set(self.hw) - _HW_FIELDS)
        if bad:
            raise ValueError(f"unknown hw overrides {bad}; "
                             f"allowed: {sorted(_HW_FIELDS)}")
        if not isinstance(self.calibration, str):
            raise ValueError(f"calibration must be a CALIB.json path "
                             f"string, got {self.calibration!r}")
        set_("driver_kw", dict(self.driver_kw))

        if self.backend not in ("numpy", "jax", "auto"):
            raise ValueError(f"backend must be numpy|jax|auto, "
                             f"got {self.backend!r}")
        if self.refine_top < 0 or self.keep_top < 0 or self.validate_top < 0:
            raise ValueError("refine_top, keep_top and validate_top must "
                             "be >= 0")
        from repro_torch.events.dag import SCHEDULES  # core-only dep, no cycle
        for sched in self.schedule_list():
            if sched not in SCHEDULES:
                raise ValueError(f"unknown schedule {sched!r}; known: "
                                 f"{list(SCHEDULES)} or 'search'")

    # ------------------------------------------------------------------
    # Engine-object builders
    # ------------------------------------------------------------------
    def schedule_list(self) -> Tuple[str, ...]:
        """Candidate pipeline schedules: ``"search"`` expands to every
        known schedule, a comma list to its entries, a plain name to a
        1-tuple.  len > 1 means schedule is a search dimension."""
        if self.schedule == "search":
            from repro_torch.events.dag import SCHEDULES
            return tuple(SCHEDULES)
        return tuple(s.strip() for s in self.schedule.split(","))

    def build_workload(self) -> Workload:
        from repro_torch.configs import get_config
        return Workload(model=get_config(self.model), seq_len=self.seq_len,
                        global_batch=self.global_batch, **self.workload)

    def build_hw(self) -> HW:
        base = DEFAULT_HW
        if self.calibration:
            from repro_torch.calib import load_calibration
            base = HW.calibrated(load_calibration(self.calibration))
        return dataclasses.replace(base, **self.hw) if self.hw else base

    def design_space(self, alloc_mode: str = "chiplight") -> DesignSpace:
        return DesignSpace.from_compute(
            self.build_workload(), self.total_tflops, fabrics=self.fabrics,
            reuse=self.reuse, hw=self.build_hw(),
            dies_per_mcm=self.dies_per_mcm, m=self.m,
            cpo_ratio=self.cpo_ratio, alloc_mode=alloc_mode)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {"schema": SCENARIO_SCHEMA}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        d = dict(d)
        schema = d.pop("schema", SCENARIO_SCHEMA)
        if schema != SCENARIO_SCHEMA:
            raise ValueError(f"unsupported scenario schema {schema!r} "
                             f"(this build reads {SCENARIO_SCHEMA})")
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - known)
        if bad:
            raise ValueError(f"unknown scenario keys {bad}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "Scenario":
        return cls.from_json(Path(path).read_text())

    def scenario_hash(self) -> str:
        """Content hash over the canonical JSON form (provenance key)."""
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:16]

    # the generated dataclass __hash__ would choke on the dict fields;
    # hash by content so scenarios work in sets / as cache keys
    def __hash__(self) -> int:
        return hash(self.scenario_hash())
