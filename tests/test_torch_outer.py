"""The port's outer MCM search (``chiplight-outer``) and RailX driver
against the reference's numpy path, on the CPU.

The committed outer scenario (``paper_qwen3_outer``) runs through both
packages' ``Study.run()`` as the population search, as the legacy
single walker (``method="scalar"``) and with the fused event replay
(``event_replay=2``, every schedule a candidate); ``railx`` runs batched
on ``paper_qwen3`` and on the outer scenario's single cell, and scalar on
that cell.  Records must come in the same order with the same strategy,
MCM, fabric and source and every metric within 1e-12 relative; the
``outer_trace`` is held round by round (each walker's next MCM depends
on the last bit of the scan's throughputs) and the engine statistics
key for key.  The port runs on ``device="cpu"``.
"""
import math
import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro.api import Scenario as RefScenario
from repro.api import Study as RefStudy
from repro_torch.api import Scenario, Study

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-12
OUTER = "paper_qwen3_outer"
REPLAY = {"driver_kw": {"inner_budget": 48, "rounds": 8, "walkers": 8,
                        "event_replay": 2}, "schedule": "search"}
CASES = {
    "outer_population": (OUTER, {}),
    "outer_scalar": (OUTER, {"driver_kw": {"method": "scalar",
                                           "walkers": 1}}),
    "outer_event_replay_search": (OUTER, REPLAY),
    "railx_batched": ("paper_qwen3", {"driver": "railx", "driver_kw": {}}),
    "railx_batched_cell": (OUTER, {"driver": "railx", "driver_kw": {}}),
    "railx_scalar": (OUTER, {"driver": "railx",
                             "driver_kw": {"method": "scalar"}}),
}
STATS = ("n_evaluated", "n_unique", "n_kept", "n_sim", "n_requested",
         "n_rounds", "n_variants", "n_cache_hits", "n_refined",
         "n_event_replayed", "grid_evaluated", "n_feasible", "engine")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(name):
    return ROOT / "scenarios" / f"{name}.json"


def _both(name, over):
    ref = RefStudy(RefScenario.load(_path(name)).replace(**over)).run()
    got = Study(Scenario.load(_path(name)).replace(**over)).run(device="cpu")
    return ref, got


def _assert_same_records(ref, got):
    assert len(got.records) == len(ref.records) > 0
    assert got.best == ref.best
    for i, (a, b) in enumerate(zip(ref.records, got.records)):
        assert (a.strategy, a.mcm, a.fabric, a.source, a.topo) == \
            (b.strategy, b.mcm, b.fabric, b.source, b.topo), i
        assert set(a.metrics) == set(b.metrics), i
        for key, x in a.metrics.items():
            y = b.metrics[key]
            if isinstance(x, str):
                assert x == y, (i, key)
            elif not (math.isnan(x) and math.isnan(y)):
                assert y == pytest.approx(x, rel=RTOL, abs=0.0), (i, key)
    assert got.pareto == ref.pareto


@pytest.mark.parametrize("case", sorted(CASES))
def test_study_matches_reference(case):
    name, over = CASES[case]
    ref, got = _both(name, over)
    _assert_same_records(ref, got)
    assert len(got.traces) == len(ref.traces)
    for r, (a, b) in enumerate(zip(ref.traces, got.traces)):
        assert b == a, f"outer_trace round {r}"
    for key in STATS:
        assert got.provenance.get(key) == ref.provenance.get(key), key
    assert got.provenance["device"] == "cpu"


def test_outer_scenario_sizes():
    """The committed outer study at its committed size: 9 rounds of 8
    walkers, every kept record refined, the event hook off."""
    got = Study(Scenario.load(_path(OUTER))).run(device="cpu")
    prov = got.provenance
    assert prov["engine"] == "dse.outer_search[population]"
    assert prov["n_rounds"] == len(got.traces) == 9
    assert all(len(t["walkers"]) == 8 for t in got.traces)
    assert prov["n_kept"] == len(got.records) == 256
    assert prov["n_event_replayed"] == 0
    assert all(r.source == "refined" for r in got.records)


def test_event_replay_stamps_the_outer_walk():
    """With ``event_replay`` the walkers adopt by the event-resolved
    throughput: the trace carries it, and replayed points carry their
    winning schedule."""
    _, got = _both(OUTER, REPLAY)
    assert got.provenance["n_event_replayed"] > 0
    assert all("event_thpt" in w for t in got.traces for w in t["walkers"])
    assert got.traces[-1]["walkers"][0]["event_thpt"] > 0
    assert got.provenance["metrics"]["counters"][
        "batch_replay.device_calls"] > 0


def _error(study_cls, scenario_cls, name, over, **run_kw):
    with pytest.raises(ValueError) as e:
        study_cls(scenario_cls.load(_path(name)).replace(**over)).run(
            **run_kw)
    return str(e.value)


@pytest.mark.parametrize("name,over", [
    (OUTER, {"driver_kw": {"budget": 8}}),
    (OUTER, {"driver_kw": {"method": "scalar", "refine_per_variant": 4}}),
    (OUTER, {"driver_kw": {"inner_method": "scalar"}}),
    (OUTER, {"driver_kw": {"method": "annealing"}}),
    (OUTER, {"driver_kw": {"method": "scalar", "walkers": 4}}),
    (OUTER, {"driver_kw": {"walkers": 0}}),
    (OUTER, {"driver_kw": {"method": "scalar", "event_replay": 2}}),
    (OUTER, {"m": [4, 6]}),
    ("paper_qwen3", {"driver": "chiplight-outer", "driver_kw": {}}),
    ("paper_qwen3", {"driver": "railx", "driver_kw": {"budget": 8}}),
    ("paper_qwen3", {"driver": "railx", "driver_kw": {"method": "fast"}}),
    ("paper_qwen3", {"driver": "railx", "driver_kw": {"method": "scalar"}}),
    (OUTER, {"driver": "railx", "driver_kw": {"method": "scalar",
                                              "walkers": 2}}),
], ids=["outer_unknown_kw", "scalar_refine_per_variant",
        "population_inner_method", "outer_unknown_method",
        "scalar_many_walkers", "no_walkers", "scalar_event_replay",
        "outer_multi_cell", "outer_multi_fabric", "railx_unknown_kw",
        "railx_unknown_method", "railx_scalar_multi_cell",
        "railx_scalar_unknown_kw"])
def test_driver_kw_errors_are_the_reference_s(name, over):
    ref = _error(RefStudy, RefScenario, name, over)
    got = _error(Study, Scenario, name, over, device="cpu")
    assert got == ref


def test_event_schedule_knob_is_deprecated_as_in_the_reference():
    over = {"driver_kw": {"rounds": 1, "walkers": 2, "inner_budget": 8,
                          "event_replay": 1, "event_schedule": ["1f1b"]}}
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = RefStudy(RefScenario.load(_path(OUTER)).replace(**over)).run()
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = Study(Scenario.load(_path(OUTER)).replace(**over)).run(
            device="cpu")
    msgs = lambda ws: [str(w.message) for w in ws
                       if w.category is DeprecationWarning]
    assert msgs(got_w) == msgs(ref_w) and len(msgs(got_w)) == 1
    _assert_same_records(ref, got)


def test_every_reference_driver_is_registered():
    from repro.api.registry import DRIVERS as REF
    from repro_torch.api.registry import DRIVERS
    assert DRIVERS.names() == REF.names()


def test_outer_study_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Study(Scenario.load(_path(OUTER))).run()


def test_cli_runs_the_outer_scenario_on_the_cpu(tmp_path, capsys):
    from repro_torch.cli import main
    out = tmp_path / "outer.json"
    rc = main([str(_path(OUTER)), "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.exists()
    assert "driver=chiplight-outer" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The optimizer's pieces, function by function
# ---------------------------------------------------------------------------
def _workloads():
    from repro.configs import get_config as ref_cfg
    from repro.core.workload import Workload as RefWorkload
    from repro_torch.configs import get_config
    from repro_torch.core.workload import Workload
    out = {}
    for arch, gb in (("tinyllama_1_1b", 256), ("qwen3_moe_235b_a22b", 512)):
        out[arch] = (RefWorkload(model=ref_cfg(arch), seq_len=4096,
                                 global_batch=gb),
                     Workload(model=get_config(arch), seq_len=4096,
                              global_batch=gb))
    return out


def _pt_key(p):
    s = p.strategy
    return (s.tp, s.dp, s.pp, s.cp, s.ep, s.n_micro, p.mcm.n_mcm, p.mcm.x,
            p.mcm.y, p.mcm.m, p.mcm.cpo_ratio, p.fabric, p.cost,
            p.throughput, p.sim.step_time)


@pytest.mark.parametrize("arch,C,dies", [("tinyllama_1_1b", 3e4, 4),
                                         ("qwen3_moe_235b_a22b", 2e5, 8)])
@pytest.mark.parametrize("inner_method", ["batched", "scalar"])
def test_chiplight_optimize_matches_reference(arch, C, dies, inner_method):
    from repro.core.optimizer import chiplight_optimize as ref_opt
    from repro_torch.core.optimizer import chiplight_optimize
    ref_w, w = _workloads()[arch]
    kw = dict(dies_per_mcm=dies, m0=6, outer_iters=2, inner_budget=8,
              seed=7, inner_method=inner_method)
    ref = ref_opt(ref_w, C, **kw)
    got = chiplight_optimize(w, C, device="cpu", **kw)
    assert got.outer_trace == ref.outer_trace
    assert got.stats == ref.stats
    assert [_pt_key(p) for p in got.history] == \
        [_pt_key(p) for p in ref.history]
    assert [_pt_key(p) for p in got.frontier] == \
        [_pt_key(p) for p in ref.frontier]


@pytest.mark.parametrize("seed", [0, 3])
def test_outer_population_matches_reference(seed):
    from repro.dse.outer import outer_search as ref_outer
    from repro_torch.dse.outer import outer_search
    ref_w, w = _workloads()["tinyllama_1_1b"]
    kw = dict(dies_per_mcm=16, m0=6, rounds=3, inner_budget=8, walkers=4,
              seed=seed)
    ref = ref_outer(ref_w, 1e5, **kw)
    got = outer_search(w, 1e5, device="cpu", **kw)
    for r, (a, b) in enumerate(zip(ref.outer_trace, got.outer_trace)):
        assert b == a, f"round {r}"
    assert got.stats == ref.stats
    assert [_pt_key(p) for p in got.history] == \
        [_pt_key(p) for p in ref.history]


def test_propose_moves_match_reference():
    """The planner's moves for every bottleneck the logs can name, and the
    rng consumed in the same order (the jitter move)."""
    from repro.core.mcm import mcm_from_compute as ref_mcm
    from repro.core.optimizer import _rescale_dies as ref_rescale
    from repro.core.optimizer import propose_moves as ref_moves
    from repro_torch.core.mcm import mcm_from_compute
    from repro_torch.core.optimizer import _rescale_dies, propose_moves
    logs = [None, {}, {"mem_pressure": 0.9}, {"hbm_bw_bound": 1.0},
            {"nop_bound": 1.0}, {"oi_bound": 1.0},
            {"nop_bound": 1.0, "oi_bound": 1.0, "mem_pressure": 0.99},
            {"compute_util": 0.8}, {"compute_util": 0.5}]
    key = lambda m: (m.n_mcm, m.x, m.y, m.m, m.cpo_ratio)
    for dies, m, cpo in ((16, 6, 0.6), (8, 2, 0.95), (32, 12, 0.3)):
        ref_cur, cur = ref_mcm(1e5, dies, m, cpo), \
            mcm_from_compute(1e5, dies, m, cpo)
        rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
        for lg in logs:
            a = ref_moves(ref_cur, lg, rng_a)
            b = propose_moves(cur, lg, rng_b)
            assert [key(x) for x in b] == [key(x) for x in a], lg
        for new in (1, 3, dies // 2, dies * 2, 7):
            assert key(_rescale_dies(cur, new)) == \
                key(ref_rescale(ref_cur, new))


def test_inner_search_matches_reference():
    from repro.core.mcm import mcm_from_compute as ref_mcm
    from repro.core.optimizer import inner_search as ref_inner
    from repro_torch.core.mcm import mcm_from_compute
    from repro_torch.core.optimizer import inner_search
    ref_w, w = _workloads()["qwen3_moe_235b_a22b"]
    for method in ("batched", "scalar"):
        rb, rp = ref_inner(ref_w, ref_mcm(2e5, 8, 6), budget=16,
                           method=method)
        gb, gp = inner_search(w, mcm_from_compute(2e5, 8, 6), budget=16,
                              method=method, device="cpu")
        assert [_pt_key(p) for p in gp] == [_pt_key(p) for p in rp]
        assert _pt_key(gb) == _pt_key(rb)
    with pytest.raises(ValueError, match="method"):
        inner_search(w, mcm_from_compute(1e5, 16, 6), method="quantum",
                     device="cpu")


def test_pareto_front_matches_reference():
    from repro.core.optimizer import pareto_front as ref_front
    from repro_torch.core.optimizer import pareto_front
    ref, got = _both(OUTER, {"driver_kw": {"rounds": 2, "walkers": 3,
                                           "inner_budget": 8},
                             "keep_top": 0})
    a, b = ref_front(ref.points), pareto_front(got.points)
    assert [(p.cost, p.throughput) for p in b] == \
        [(p.cost, p.throughput) for p in a] and len(b) > 0
    assert pareto_front([]) == []
