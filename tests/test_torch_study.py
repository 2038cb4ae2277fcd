"""The port's ``Study.run()`` against the reference's numpy path, on the
CPU: every committed scenario the batched drivers run, and two with the
pipeline schedule as a search dimension and validation of the top 8
(the outer search's scenario and the RailX driver are held in
``test_torch_outer.py``).

Records are required in the same order with the same strategy, MCM,
fabric and source, every metric within 1e-9 relative (the bar of
``tests/test_dse.py``), and the same event re-rank winners.  The port
runs on ``device="cpu"`` (its plain paths); the reference's scenario
field ``backend`` stays ``numpy`` (its jax backend is not a reference
here, ROADMAP C1).
"""
import math
import pathlib

import pytest
import torch

from repro.api import Scenario as RefScenario
from repro.api import Study as RefStudy
from repro_torch.api import Scenario, Study

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9
BATCHED = ["gemma3_dense", "llava_vlm", "mixtral_nsga2", "paper_qwen3",
           "paper_qwen3_validate", "tinyllama_quick", "whisper_encdec",
           "zamba2_hybrid"]
SEARCH = {"schedule": "search", "validate_top": 8}
CASES = [(n, {}) for n in BATCHED] + [
    ("tinyllama_quick", SEARCH), ("paper_qwen3_validate", SEARCH)]


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


def test_every_batched_scenario_is_covered():
    """Every committed scenario is held against the reference: the
    batched drivers' here, the outer search's in test_torch_outer.py."""
    from test_torch_outer import CASES as OUTER_CASES
    names = sorted(p.stem for p in (ROOT / "scenarios").glob("*.json"))
    outer = [n for n in names if Scenario.load(_path(n)).driver
             not in ("exhaustive", "random", "prf", "nsga2")]
    assert outer == ["paper_qwen3_outer"]
    assert sorted(set(names) - set(outer)) == BATCHED
    assert set(outer) <= {n for n, over in OUTER_CASES.values()
                          if not over}


@pytest.mark.parametrize("name,over", CASES,
                         ids=[n + ("+search" if o else "") for n, o in CASES])
def test_study_matches_reference(name, over):
    ref = RefStudy(RefScenario.load(_path(name)).replace(**over)).run()
    got = Study(Scenario.load(_path(name)).replace(**over)).run(device="cpu")
    assert len(got.records) == len(ref.records) > 0
    assert got.best == ref.best
    for i, (a, b) in enumerate(zip(ref.records, got.records)):
        assert (a.strategy, a.mcm, a.fabric, a.source) == \
            (b.strategy, b.mcm, b.fabric, b.source), i
        assert set(a.metrics) == set(b.metrics), i
        for key, x in a.metrics.items():
            y = b.metrics[key]
            if isinstance(x, str):
                assert x == y, (i, key)
            elif not (math.isnan(x) and math.isnan(y)):
                assert y == pytest.approx(x, rel=RTOL, abs=0.0), (i, key)
    assert got.pareto == ref.pareto
    rr, gr = ref.provenance.get("event_rerank"), got.provenance.get(
        "event_rerank")
    assert (rr is None) == (gr is None)
    if rr:
        assert gr["winners"] == rr["winners"]
        assert gr["candidates"] == rr["candidates"]
    if name == "paper_qwen3_validate" and over:
        # the README's fidelity table: its search winner is interleaved/v4
        best = got.records[got.best].metrics
        assert (best["event_schedule"], best["event_v"]) == ("interleaved", 4)
    rv, gv = ref.provenance.get("validate"), got.provenance.get("validate")
    assert (rv is None) == (gv is None)
    if rv:
        assert gv["n_validated"] == rv["n_validated"] > 0
        assert gv["max_abs_err"] == pytest.approx(rv["max_abs_err"],
                                                  rel=RTOL)
    assert got.provenance["device"] == "cpu"
    assert got.provenance["backend"] == "numpy"


def test_scenario_validates_backend_as_the_reference():
    with pytest.raises(ValueError, match="backend"):
        Scenario(model="tinyllama_1_1b", total_tflops=1e6, backend="cuda")
    sc = Scenario.load(_path("paper_qwen3_outer"))
    assert sc.driver == "chiplight-outer" and sc.backend == "numpy"


def test_study_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Study(Scenario.load(_path("tinyllama_quick"))).run()


def test_cli_runs_a_study_on_the_cpu(tmp_path, capsys):
    from repro_torch.cli import main
    out = tmp_path / "study.json"
    rc = main([str(_path("tinyllama_quick")), "--device", "cpu",
               "--schedule", "search", "--validate-top", "2",
               "--out", str(out)])
    assert rc == 0 and out.exists()
    text = capsys.readouterr().out
    assert "event re-rank" in text and "event-validated 2 records" in text


def test_metric_names_are_declared():
    """Every counter the port increments by a literal name is in its
    schema (``obs/metrics.py``), and every declared counter is used: the
    device-named counterparts of the reference's ``*.jax_*`` counters
    included."""
    import ast

    from repro_torch.obs.metrics import KNOWN_COUNTERS, KNOWN_GAUGES
    used = {"inc": set(), "gauge": set()}
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                name = getattr(node.func, "attr",
                               getattr(node.func, "id", ""))
                if name in used and "." in node.args[0].value:
                    used[name].add(node.args[0].value)
    assert used["inc"] == set(KNOWN_COUNTERS)
    assert used["gauge"] <= set(KNOWN_GAUGES)
    assert {"batched_sim.device_calls",
            "batch_replay.device_calls"} <= KNOWN_COUNTERS
