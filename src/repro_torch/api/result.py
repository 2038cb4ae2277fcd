"""Unified study results: ``DesignRecord`` + ``StudyResult``.

One record shape for every engine: the batched sweep (``SweepResult``),
per-cell driver runs (``SearchResult``), the scalar oracle
(``DesignPoint``) and the nested optimiser (``DSEResult``) are all folded
into ``DesignRecord`` rows by the adapters below — no caller outside
``repro_torch.core``/``repro_torch.dse`` constructs the legacy result types.

``StudyResult`` is the versioned, JSON-round-trippable artifact a study
writes: records, best/Pareto indices, traces, timings, and provenance
(scenario + content hash).  Refined records additionally keep the live
``DesignPoint`` (topology, JAX plan hand-off) in the runtime-only
``points`` list.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.registry import OBJECTIVES
from repro_torch.api.scenario import Scenario

RESULT_SCHEMA = 1

METRIC_KEYS = ("feasible", "throughput", "step_time", "mfu", "cost",
               "power")


# ---------------------------------------------------------------------------
# DesignRecord
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DesignRecord:
    """One evaluated design point, engine-independent."""

    strategy: Dict[str, int]       # TP/DP/PP/CP/EP + n_micro
    mcm: Dict[str, float]          # n_mcm/x/y/m/cpo_ratio
    fabric: str
    metrics: Dict[str, float]      # METRIC_KEYS
    source: str                    # "batched" | "refined" | "scalar"
    topo: Optional[Dict[str, Any]] = None   # refined OI points only

    @property
    def feasible(self) -> bool:
        return bool(self.metrics.get("feasible"))

    @property
    def throughput(self) -> float:
        return float(self.metrics.get("throughput", 0.0))

    def to_dict(self) -> Dict[str, Any]:
        return {"strategy": dict(self.strategy), "mcm": dict(self.mcm),
                "fabric": self.fabric,
                "metrics": {k: _jsonable(v)
                            for k, v in self.metrics.items()},
                "source": self.source, "topo": self.topo}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DesignRecord":
        return cls(strategy=dict(d["strategy"]), mcm=dict(d["mcm"]),
                   fabric=d["fabric"],
                   metrics={k: _unjsonable(v)
                            for k, v in d["metrics"].items()},
                   source=d["source"], topo=d.get("topo"))


def _jsonable(v):
    v = float(v) if isinstance(v, (np.floating, np.integer)) else v
    if isinstance(v, float) and math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return v


def _unjsonable(v):
    if v in ("inf", "-inf"):
        return math.inf if v == "inf" else -math.inf
    return v


# ---------------------------------------------------------------------------
# Adapters over the legacy result types
# ---------------------------------------------------------------------------
def _mcm_dict(mcm) -> Dict[str, float]:
    return {"n_mcm": int(mcm.n_mcm), "x": int(mcm.x), "y": int(mcm.y),
            "m": int(mcm.m), "cpo_ratio": float(mcm.cpo_ratio)}


def record_from_sweep(sweep, i: int) -> DesignRecord:
    """Adapter: one row of a ``repro_torch.dse.search.SweepResult``."""
    return records_from_sweep(sweep, np.array([i], np.int64))[0]


def records_from_sweep(sweep, idx) -> List[DesignRecord]:
    """Columnar adapter: many ``SweepResult`` rows at once.

    The numpy -> Python conversion happens once per COLUMN (one
    ``tolist`` each), not once per element, and the mcm dict is built
    once per unique MCM variant — keeping thousands of Pareto rows
    costs array ops plus one cheap constructor per record."""
    idx = np.asarray(idx, np.int64)
    if not len(idx):
        return []
    b, met = sweep.batch, sweep.metrics
    tp, dp, pp = b.tp[idx].tolist(), b.dp[idx].tolist(), b.pp[idx].tolist()
    cp, ep = b.cp[idx].tolist(), b.ep[idx].tolist()
    nm = b.n_micro[idx].tolist()
    feas = np.asarray(met["feasible"], bool)[idx].tolist()
    thpt = np.asarray(met["throughput"], np.float64)[idx].tolist()
    stime = np.asarray(met["step_time"], np.float64)[idx].tolist()
    mfu = np.asarray(met["mfu"], np.float64)[idx].tolist()
    cost = np.asarray(met["cost"], np.float64)[idx].tolist()
    power = np.asarray(met["power"], np.float64)[idx].tolist()
    mis = np.asarray(sweep.mcm_idx, np.int64)[idx]
    mcm_dicts = {int(m): _mcm_dict(sweep.space.mcms[int(m)])
                 for m in np.unique(mis)}
    mi = mis.tolist()
    fabric = [str(f) for f in np.asarray(sweep.fabric)[idx].tolist()]
    return [DesignRecord(
        strategy={"TP": tp[i], "DP": dp[i], "PP": pp[i], "CP": cp[i],
                  "EP": ep[i], "n_micro": nm[i]},
        mcm=dict(mcm_dicts[mi[i]]), fabric=fabric[i],
        metrics={"feasible": feas[i], "throughput": thpt[i],
                 "step_time": stime[i], "mfu": mfu[i], "cost": cost[i],
                 "power": power[i]},
        source="batched") for i in range(len(idx))]


def record_from_search(res, mcm, fabric: str, i: int) -> DesignRecord:
    """Adapter: one row of a per-cell ``SearchResult`` (single MCM)."""
    b, met = res.batch, res.metrics
    strategy = {"TP": int(b.tp[i]), "DP": int(b.dp[i]), "PP": int(b.pp[i]),
                "CP": int(b.cp[i]), "EP": int(b.ep[i]),
                "n_micro": int(b.n_micro[i])}
    metrics = {k: (bool if k == "feasible" else float)(met[k][i])
               for k in METRIC_KEYS}
    return DesignRecord(strategy=strategy, mcm=_mcm_dict(mcm),
                        fabric=fabric, metrics=metrics, source="batched")


def record_from_point(pt, source: str = "refined",
                      fabric: Optional[str] = None) -> DesignRecord:
    """Adapter: a scalar-oracle ``core.optimizer.DesignPoint`` — exact
    (OCS-inclusive) cost, derived topology, board power recomputed with
    the same model the batched engine uses."""
    from repro_torch.dse.batched_sim import board_power
    fabric = fabric or pt.fabric
    s, sim = pt.strategy, pt.sim
    strategy = {"TP": s.tp, "DP": s.dp, "PP": s.pp, "CP": s.cp, "EP": s.ep,
                "n_micro": s.n_micro}
    metrics = {"feasible": bool(sim.feasible),
               "throughput": float(sim.throughput),
               "step_time": float(sim.step_time),
               "mfu": float(sim.mfu),
               "cost": float(pt.cost),
               "power": board_power(pt.mcm, fabric,
                                    float(sim.logs.get("compute_util", 0.0)))}
    topo = None
    if pt.topo is not None:
        topo = {"dims": [[d.n, d.r, d.k] for d in pt.topo.dims],
                "mapping": [list(g) for g in pt.topo.mapping],
                "link_alloc": dict(pt.topo.link_alloc),
                "reuse_pair": (list(pt.topo.reuse_pair)
                               if pt.topo.reuse_pair else None),
                "ocs_count": int(pt.topo.ocs_count())}
    return DesignRecord(strategy=strategy, mcm=_mcm_dict(pt.mcm),
                        fabric=fabric, metrics=metrics, source=source,
                        topo=topo)


# ---------------------------------------------------------------------------
# StudyResult
# ---------------------------------------------------------------------------
@dataclass
class StudyResult:
    """Versioned result artifact of one ``Study.run()``."""

    scenario: Scenario
    records: List[DesignRecord]
    best: Optional[int]                    # index into records
    pareto: List[int] = field(default_factory=list)
    traces: List[Dict] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)
    provenance: Dict[str, Any] = field(default_factory=dict)
    # runtime-only: refined DesignPoints (topology / JAX-plan hand-off),
    # parallel to the records whose source == "refined"; NOT serialized.
    points: List = field(default_factory=list, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def best_record(self) -> Optional[DesignRecord]:
        return self.records[self.best] if self.best is not None else None

    @property
    def best_point(self):
        """Best refined ``DesignPoint`` (None when no refinement ran)."""
        return self.points[0] if self.points else None

    def pareto_indices(self, objectives: Optional[Sequence[str]] = None
                       ) -> List[int]:
        """Non-dominated records under the scenario's (or the given)
        objectives, throughput-best first."""
        from repro_torch.dse.pareto import pareto_mask
        names = tuple(objectives or self.scenario.objectives)
        objs = [OBJECTIVES.get(n) for n in names]
        if not self.records:
            return []
        cols = np.stack(
            [[float(r.metrics.get(o.metric, np.nan)) for r in self.records]
             for o in objs], 1)
        feas = np.array([r.feasible for r in self.records])
        cols = np.where(feas[:, None], cols, np.nan)
        idx = np.nonzero(pareto_mask(cols, [o.maximize for o in objs]))[0]
        thpt = np.array([self.records[i].throughput for i in idx])
        return [int(i) for i in idx[np.argsort(-thpt, kind="stable")]]

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"schema": RESULT_SCHEMA,
                "scenario": self.scenario.to_dict(),
                "records": [r.to_dict() for r in self.records],
                "best": self.best, "pareto": list(self.pareto),
                "traces": self.traces, "timings": self.timings,
                "provenance": self.provenance}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StudyResult":
        schema = d.get("schema", RESULT_SCHEMA)
        if schema != RESULT_SCHEMA:
            raise ValueError(f"unsupported StudyResult schema {schema!r} "
                             f"(this build reads {RESULT_SCHEMA})")
        return cls(scenario=Scenario.from_dict(d["scenario"]),
                   records=[DesignRecord.from_dict(r) for r in d["records"]],
                   best=d.get("best"), pareto=list(d.get("pareto", [])),
                   traces=list(d.get("traces", [])),
                   timings=dict(d.get("timings", {})),
                   provenance=dict(d.get("provenance", {})))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "StudyResult":
        return cls.from_dict(json.loads(Path(path).read_text()))
