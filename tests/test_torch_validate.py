"""The port's fidelity harness, ``cli validate``, ``cli timeline``,
``--trace`` and the ``dse.run`` shim against the reference's, on the CPU.

``validate_scenario`` of each committed scenario (top 4, gpipe, 1f1b and
interleaved) must give the reference's rows field for field: the port's
study runs on ``device="cpu"`` (its plain paths; the reference's scenario
field ``backend`` stays ``numpy``, ROADMAP C1) and its scalar engine is
the reference's, operation for operation.  ``timeline``'s trace must be
the reference's ``chrome_trace_from_event_result`` of the same program.
"""
import json
import pathlib
import shutil

import pytest
import torch

from repro.api import Scenario as RefScenario
from repro.events import replay as ref_replay
from repro.events.validate import validate_scenario as ref_validate
from repro.obs import chrome_trace_from_event_result as ref_trace
from repro.obs.bench import pipelined_programs as ref_pipelined
from repro.obs.bench import top_record_batch as ref_top_record_batch
from repro_torch import cli
from repro_torch.api import Scenario, Study
from repro_torch.events import validate
from repro_torch.obs import track_idle, validate_chrome_trace
from repro_torch.obs.bench import pipelined_records

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = sorted(p.stem for p in (ROOT / "scenarios").glob("*.json"))
SCHEDULES = ("gpipe", "1f1b", "interleaved")


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


def test_nine_committed_scenarios():
    assert len(SCENARIOS) == 9


@pytest.mark.parametrize("name", SCENARIOS)
def test_validate_scenario_matches_reference(name):
    want = ref_validate(RefScenario.load(_path(name)), top=4,
                        schedules=SCHEDULES)
    got = validate.validate_scenario(Scenario.load(_path(name)), top=4,
                                     schedules=SCHEDULES, device="cpu")
    assert set(got) == set(want)
    for key in ("scenario", "scenario_hash", "n_points"):
        assert got[key] == want[key], key
    assert len(got["rows"]) == len(want["rows"]) > 0
    for a, b in zip(want["rows"], got["rows"]):
        assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                           sort_keys=True)
    assert all(r["ok"] for r in got["rows"])


def test_cli_validate_quick_writes_the_ports_report(tmp_path, capsys):
    out = tmp_path / "fidelity.json"
    rc = cli.main(["validate", "--quick", "--device", "cpu", "--out",
                   str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["schema"] == validate.FIDELITY_SCHEMA
    assert report["tolerance"] == validate.DEFAULT_TOLERANCE == 0.15
    assert report["device"] == "cpu"
    assert report["schedules"] == ["gpipe", "1f1b"]
    assert report["n_scenarios"] == 1 and report["n_violations"] == 0
    assert report["n_asserted"] == report["n_rows"] > 0
    assert validate.ASSERTED_SCHEDULES == ("gpipe", "1f1b")
    table = validate.fidelity_table(report)
    assert {r["schedule"] for r in table} == {"gpipe", "1f1b"}
    assert "OK: all" in capsys.readouterr().out
    assert cli.build_validate_parser().get_default("out") == \
        "artifacts/fidelity_report_h100.json"


@pytest.mark.parametrize("artifact", ["FIDELITY.json", "CALIB.json"])
def test_cli_validate_refuses_the_reference_artifacts(artifact, capsys):
    before = (ROOT / artifact).read_bytes()
    with pytest.raises(SystemExit) as e:
        cli.main(["validate", "--quick", "--device", "cpu", "--out",
                  str(ROOT / artifact)])
    assert e.value.code == cli.EXIT_USAGE
    assert "reference package" in capsys.readouterr().err
    assert (ROOT / artifact).read_bytes() == before


def test_execution_anchor_reads_only_the_ports_calibration(tmp_path,
                                                           monkeypatch):
    with pytest.raises(ValueError, match="reference package"):
        validate.execution_anchor(ROOT / "CALIB.json")
    monkeypatch.chdir(tmp_path)
    # a reference artifact in the working directory is not read
    shutil.copy(ROOT / "CALIB.json", tmp_path / "CALIB.json")
    assert validate.execution_anchor() is None
    calib = json.loads((ROOT / "CALIB.json").read_text())
    (tmp_path / "CALIB_h100.json").write_text(json.dumps(calib))
    anchor = validate.execution_anchor()
    assert anchor["source"] == "CALIB_h100.json"
    assert anchor["effective"] == calib["effective"]
    assert set(anchor["kernels"]) == set(calib["kernels"])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_timeline_trace_matches_reference(schedule, tmp_path, capsys):
    out = tmp_path / "timeline.json"
    rc = cli.main(["timeline", str(_path("tinyllama_quick")), "--schedule",
                   schedule, "--device", "cpu", "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    sc = RefScenario.load(_path("tinyllama_quick"))
    prog, _ = ref_pipelined(sc, schedule=schedule)
    want = json.loads(json.dumps(ref_trace(
        ref_replay(prog, record_timeline=True), title=sc.name)))
    assert got == want
    counts = validate_chrome_trace(got)
    assert counts["X"] > 0 and counts["M"] > 0
    idle = track_idle(got)
    assert len(idle) == got["otherData"]["n_stages"] > 1
    assert "device tracks" in capsys.readouterr().out


def _record_key(s, mcm, topo, fabric):
    return (s.tp, s.dp, s.pp, s.cp, s.ep, s.n_micro, mcm.n_mcm, mcm.x,
            mcm.y, mcm.m, mcm.cpo_ratio, topo is None, fabric)


@pytest.mark.parametrize("name", ["tinyllama_quick", "paper_qwen3_validate"])
def test_pipelined_records_match_top_record_batch(name):
    """The records the card's wavefront is checked on are the reference's
    ``top_record_batch`` rows (its cycling to ``k`` aside), deepest top
    record first, as ``timeline`` takes it."""
    sc = Scenario.load(_path(name))
    _, _, recs = pipelined_records(sc, Study(sc).run(device="cpu"), top=8)
    _, _, *cols = ref_top_record_batch(RefScenario.load(_path(name)),
                                       k=len(recs), top=8)
    want = sorted(_record_key(*r) for r in zip(*cols))
    assert sorted(_record_key(*r) for r in recs) == want
    assert all(r[0].pp > 1 for r in recs)
    depth = [r[0].pp * r[0].n_micro for r in recs if r[2] is not None]
    assert depth == sorted(depth, reverse=True)


def _span_names(path):
    trace = json.loads(pathlib.Path(path).read_text())
    validate_chrome_trace(trace)
    return {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}


def test_study_trace_holds_the_stage_spans(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    rc = cli.main([str(_path("tinyllama_quick")), "--device", "cpu",
                   "--schedule", "search", "--validate-top", "2",
                   "--out", str(tmp_path / "study.json"),
                   "--trace", str(trace)])
    assert rc == 0
    names = _span_names(trace)
    assert {"study.run", "study.scan", "study.event_rerank",
            "study.refine", "study.validate_top"} <= names
    assert "wrote host trace" in capsys.readouterr().out


@pytest.mark.parametrize("sub", ["validate", "calibrate"])
def test_trace_on_validate_and_calibrate(sub, tmp_path, capsys):
    trace = tmp_path / "trace.json"
    args = (["validate", "--quick", "--out", str(tmp_path / "f.json")]
            if sub == "validate" else
            ["calibrate", "--quick", "--kernels", "rmsnorm", "--out",
             str(tmp_path / "c.json")])
    rc = cli.main(args + ["--device", "cpu", "--trace", str(trace)])
    assert rc == 0
    want = {"validate": {"validate.scenario", "study.run"},
            "calibrate": {"profile.kernel", "profile.measure"}}[sub]
    assert want <= _span_names(trace)


_CLI_ARGS = ["--model", "tinyllama_1_1b", "--C", "1e6", "--dies", "16",
             "--m", "2,6", "--cpo", "0.3,0.9", "--refine-top", "2",
             "--keep-top", "8", "--device", "cpu"]


def test_dse_run_shim_warns_and_matches_cli(tmp_path, capsys):
    from repro_torch.dse import run as dse_run
    rc_new = cli.main(_CLI_ARGS + ["--out", str(tmp_path / "new.json")])
    with pytest.warns(DeprecationWarning, match="repro_torch.cli"):
        rc_old = dse_run.main(_CLI_ARGS + ["--out",
                                           str(tmp_path / "old.json")])
    capsys.readouterr()
    assert rc_new == rc_old == 0
    new = json.loads((tmp_path / "new.json").read_text())
    old = json.loads((tmp_path / "old.json").read_text())
    assert old["records"] == new["records"]
    assert old["best"] == new["best"] and old["pareto"] == new["pareto"]
    assert old["scenario"] == new["scenario"]
