"""The port's calibration (``repro_torch.obs.profile`` +
``repro_torch.calib``) against the reference's, on the CPU.

The fits are held on the committed ``CALIB.json``'s 33 measurement rows
(read only) against the reference's ``fit_calibration``: per-kernel
curves and the effective constants within 1e-12 relative.  A calibrated
scenario runs through both packages' ``Study.run()`` to the same records
on the same ``HW``.  The profiling harness is held to the reference's
grid and its analytic FLOP and byte counts, row for row, with two more
fields per row (``impl``, ``dtype``).  On the CPU the port times its
plain versions; the card's kernels are timed by ``chip_smoke.py``.
"""
import copy
import dataclasses
import json
import math
import pathlib

import pytest
import torch

from repro.calib import fit_calibration as ref_fit
from repro.calib import fit_saturation as ref_fit_saturation
from repro_torch import cli
from repro_torch.calib import (DEFAULT_CALIB_PATH, calibration_block,
                               check_drift, execution_block,
                               fit_calibration, fit_saturation,
                               load_calibration, stamp_fidelity,
                               write_calibration)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "CALIB.json"
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def committed_rows():
    calib = json.loads(COMMITTED.read_text())
    assert len(calib["measurements"]) == 33
    return calib["measurements"]


@pytest.fixture(scope="module")
def quick_calib():
    from repro_torch.obs.profile import profile_kernels
    ms = profile_kernels(["rmsnorm", "moe_gmm"], quick=True, reps=1,
                         device="cpu")
    return fit_calibration(ms, quick=True, device="cpu"), ms


def _close(a, b):
    """Equal structure; floats within RTOL relative."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=RTOL, abs=0.0)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# The fits on the committed rows
# ---------------------------------------------------------------------------
def test_fits_on_committed_rows_match_reference(committed_rows):
    ref = ref_fit(copy.deepcopy(committed_rows))
    got = fit_calibration(copy.deepcopy(committed_rows), device="cpu")
    _close(ref["kernels"], got["kernels"])
    _close(ref["effective"], got["effective"])
    assert set(got["kernels"]) == {"decode_attention", "flash_attention_bwd",
                                   "flash_attention_fwd", "moe_gmm",
                                   "rmsnorm", "ssd"}
    assert got["check_tolerances"] == ref["check_tolerances"]
    assert got["measurements"] == committed_rows
    rows = check_drift(got, got)
    assert rows and all(r["ok"] for r in rows)


def test_fit_saturation_matches_reference(committed_rows):
    for name in ("moe_gmm", "rmsnorm", "ssd"):
        rows = [r for r in committed_rows
                if r["kernel"] == name and r["axis"] == "m"]
        rate = "bytes_per_s" if rows[0]["kind"] == "memory" \
            else "flops_per_s"
        xs, ys = [r["x"] for r in rows], [r[rate] for r in rows]
        for a, b in zip(ref_fit_saturation(xs, ys), fit_saturation(xs, ys)):
            assert b == pytest.approx(a, rel=RTOL, abs=0.0)
    with pytest.raises(ValueError, match=">= 2 points"):
        fit_saturation([1.0], [1.0])
    with pytest.raises(ValueError, match="positive"):
        fit_saturation([1.0, 0.0], [1.0, 2.0])


def test_provenance_names_torch_and_no_jax(committed_rows):
    prov = fit_calibration(committed_rows, device="cpu")["provenance"]
    assert prov["torch"] == torch.__version__
    assert prov["backend"] == "cpu" and "jax" not in prov
    assert "card" not in prov          # the card's name and limit: cuda
    assert prov["n_measurements"] == 33


# ---------------------------------------------------------------------------
# A calibrated study
# ---------------------------------------------------------------------------
def test_calibrated_study_matches_reference():
    from repro.api import Scenario as RefScenario
    from repro.api import Study as RefStudy
    from repro_torch.api import Scenario, Study
    calib = load_calibration(str(COMMITTED))
    # the cluster is sized as total_tflops / die_tflops: ~64 of the
    # committed (CPU-scale) dies, as the reference's own test sizes it
    over = {"calibration": str(COMMITTED),
            "total_tflops": calib["effective"]["die_tflops"] * 64}
    path = ROOT / "scenarios" / "tinyllama_quick.json"
    ref_sc = RefScenario.load(path).replace(**over)
    sc = Scenario.load(path).replace(**over)
    assert dataclasses.asdict(sc.build_hw()) == \
        dataclasses.asdict(ref_sc.build_hw())
    assert sc.build_hw().die_tflops == calib["effective"]["die_tflops"]
    ref, got = RefStudy(ref_sc).run(), Study(sc).run(device="cpu")
    assert len(got.records) == len(ref.records) > 0
    assert [r.to_dict() for r in got.records] == \
        [r.to_dict() for r in ref.records]
    blk = got.provenance["calibration"]
    assert blk["effective"] == ref.provenance["calibration"]["effective"]
    assert blk["measured_on"]["commit"] == calib["provenance"]["commit"]
    assert json.loads(json.dumps(got.to_dict()))["provenance"][
        "calibration"] == blk


def test_uncalibrated_scenario_is_untouched():
    from repro_torch.api import Scenario
    from repro_torch.core.hardware import DEFAULT_HW
    sc = Scenario(model="tinyllama_1_1b", total_tflops=1e6)
    assert sc.calibration == "" and sc.build_hw() == DEFAULT_HW
    with pytest.raises(ValueError):
        Scenario(model="tinyllama_1_1b", total_tflops=1e6, calibration=123)


# ---------------------------------------------------------------------------
# The profiling harness
# ---------------------------------------------------------------------------
def test_profile_counts_are_the_reference_s():
    """Every grid point of every kernel, quick and full: the same axis,
    x, shape, FLOPs and bytes as the reference's case builders (built,
    not run; the quick grid is a prefix of the full one)."""
    from repro.obs import profile as ref_prof
    from repro_torch.obs import profile as prof
    assert prof.PROFILE_KERNELS == ref_prof.PROFILE_KERNELS
    assert prof.KERNEL_KIND == ref_prof.KERNEL_KIND
    for quick in (True, False):
        assert prof._grids(quick) == ref_prof._grids(quick)
        for name in prof.PROFILE_KERNELS:
            ref_cases = ref_prof._cases(name, quick)
            cases = prof._cases(name, quick, "cpu")
            assert [(a, x) for a, x, _ in cases] == \
                [(a, x) for a, x, _ in ref_cases]
            if quick:
                continue
            for (_, _, build), (_, _, ref_build) in zip(cases, ref_cases):
                _, args, flops, nbytes, shape, kernels = build()
                _, _, r_flops, r_bytes, r_shape = ref_build()
                assert (flops, nbytes, shape) == (r_flops, r_bytes, r_shape)
                assert set(kernels) <= {"flash_attention", "moe_gmm",
                                        "ssd_scan", "rmsnorm"}
                assert all(a.dtype == torch.float32 for a in args
                           if isinstance(a, torch.Tensor)
                           and a.is_floating_point())


def test_card_grids_hold_the_reference_s():
    """On the card every grid is the reference's, then larger points
    (built, not run); quick stays a strict prefix."""
    from repro.obs import profile as ref_prof
    from repro_torch.obs import profile as prof
    full = prof._grids(False, "cuda")
    assert full["ssd"] == ref_prof._grids(False)["ssd"]
    for name, ref in ref_prof._grids(False).items():
        g = full[name]
        assert g[:len(ref)] == ref and g == sorted(set(g))
        assert prof._grids(True, "cuda")[name] == g[:-1]
    n = prof._moe_n_grid(False, "cuda")
    assert n[:len(prof._MOE_N_GRID)] == prof._MOE_N_GRID and n[-1] > 512
    assert [x for a, x, _ in prof._cases("moe_gmm", False, "cuda")] == \
        full["moe_gmm"] + n


def test_card_flash_count_is_the_kernel_s_tiles():
    """On the card flash's FLOPs are the kernel's causal tile pairs
    (query tile qt runs key tiles 0..qt, 4*64*64*d FLOPs a pair); the
    backward's torch ops add the reference's 10*s*s*d a head."""
    from repro_torch.obs.profile import _fa_flops
    b, h, d = 1, 4, 64
    for s in (128, 1024, 16384):
        n = s // 64
        pairs = sum(qt + 1 for qt in range(n))
        fwd = b * h * pairs * 4.0 * 64 * 64 * d
        assert _fa_flops(b, h, s, d, False, True) == fwd
        assert _fa_flops(b, h, s, d, True, True) == \
            fwd + 10.0 * b * h * s * s * d
        assert _fa_flops(b, h, s, d, False, False) == 4.0 * b * h * s * s * d
    with pytest.raises(ValueError, match="whole 64-row tiles"):
        _fa_flops(b, h, 100, d, False, True)


def test_profile_impl_comes_from_launch_counts(monkeypatch):
    """A row names a hand kernel only where that kernel's count moved."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.obs.profile import profile_kernels
    rows = profile_kernels(["rmsnorm"], quick=True, reps=1, device="cpu")
    assert {r["impl"] for r in rows} == {"torch"}
    plain = ops.rmsnorm

    def counted(*a, **kw):
        rms_mod.launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(ops, "rmsnorm", counted)
    rows = profile_kernels(["rmsnorm"], quick=True, reps=1, device="cpu")
    assert {r["impl"] for r in rows} == {"cuda:rmsnorm"}


def _card_calib(rates, kind="memory", xs=(128, 512, 2048, 8192)):
    key = "bytes_per_s" if kind == "memory" else "flops_per_s"
    rows = [{"kernel": "k", "kind": kind, "axis": "m", "x": x, key: y,
             "flops_per_s": y, "bytes_per_s": y, "time_s": 1.0, "reps": 1}
            for x, y in zip(xs, rates)]
    return fit_calibration(rows)


def test_card_fit_faults():
    """A fit over the card's peak, or one whose half sits at the top of
    the search (a rate that never bent), cannot stand; a bent curve
    under the peak can."""
    from repro_torch.calib import CARD_PEAKS, card_fit_faults
    xs = (128, 512, 2048, 8192)
    bent = [2.9e12 * x / (x + 1000.0) for x in xs]
    assert card_fit_faults(_card_calib(bent)) == []
    over = [v * 2 for v in bent]
    assert CARD_PEAKS["memory"] < max(over)
    assert any("over the card's" in f
               for f in card_fit_faults(_card_calib(over)))
    linear = [1e9 * x for x in xs]
    faults = card_fit_faults(_card_calib(linear, "compute"))
    assert any("never bent" in f for f in faults)


def test_card_flash_bwd_top_points_fit_their_median(monkeypatch):
    """ROADMAP C15: on the card the flash backward's grid keeps the
    reference's points first, and its top three points are each timed
    three times (one warm-up) and fitted by their median; every other
    point, kernel and the CPU time once."""
    from repro.obs import profile as ref_prof
    from repro_torch.obs import bench
    from repro_torch.obs import profile as prof
    name = "flash_attention_bwd"
    for quick in (False, True):
        g = prof._grids(quick, "cuda")[name]
        ref = ref_prof._grids(False)[name]
        assert g[:len(ref) - quick] == ref[:len(ref) - quick]
        assert [prof._repeats(name, x, quick, "cuda") for x in g] == \
            [1] * (len(g) - 3) + [3] * 3
        assert all(prof._repeats(name, x, quick, "cpu") == 1 for x in g)
    for other in prof.PROFILE_KERNELS:
        if other != name:
            assert {prof._repeats(other, x, False, "cuda")
                    for x in prof._grids(False, "cuda")[other]} == {1}
    calls, readings = [], iter([3.0e-3, 1.0e-3, 2.0e-3])

    def fake_time_fn(fn, *args, reps, warmup):
        calls.append((reps, warmup))
        return next(readings)

    monkeypatch.setattr(bench, "time_fn", fake_time_fn)
    t, times = prof._time_point(None, (), 3, 3)
    assert t == 2.0e-3 and times == [3.0e-3, 1.0e-3, 2.0e-3]
    assert calls == [(3, 1), (3, 0), (3, 0)]


def test_card_flash_bwd_grid_reaches_m_65536():
    """ROADMAP C15: the card's flash backward grid goes on to m 65536, so
    its three median-fitted top points are 16384, 32768 and 65536, the
    last two timed one call a timing; quick drops 65536; the CPU's and
    the reference's grids, and every other point's reps, are as they
    were."""
    from repro.obs import profile as ref_prof
    from repro_torch.obs import profile as prof
    name = "flash_attention_bwd"
    g = prof._grids(False, "cuda")[name]
    assert g[-4:] == [8192, 16384, 32768, 65536]
    assert [x for x in g if prof._repeats(name, x, False, "cuda") == 3] == \
        [16384, 32768, 65536]
    assert [prof._reps(name, x, 3, "cuda") for x in g[-4:]] == [3, 3, 1, 1]
    assert {prof._reps(name, x, 3, "cpu") for x in g} == {3}
    for other in prof.PROFILE_KERNELS:
        if other != name:
            assert {prof._reps(other, x, 3, "cuda")
                    for x in prof._grids(False, "cuda")[other]} == {3}
    assert prof._grids(True, "cuda")[name] == g[:-1]
    assert prof._grids(False, "cpu")[name] == \
        ref_prof._grids(False)[name] == [128, 256, 512, 1024]


def test_fit_of_median_rows_stays_near_the_rows_level():
    """Rows like the card's flash backward (a rate ``level * x / (x +
    8000)``, PRs 26-28's m_half range, 8% noise a timing): with the top
    three points the medians of three timings, the fitted peak stays
    within 1.4x the level the rows rise to, and extrapolates less than
    single timings do, over 300 draws of the noise."""
    import numpy as np
    from repro_torch.calib import CARD_PEAKS, fit_saturation
    xs = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]
    level = 1.0e13
    worst = {}
    for repeats in (1, 3):
        rng = np.random.default_rng(5)
        worst[repeats] = 0.0
        for _ in range(300):
            rates = [float(np.median(
                level * x / (x + 8000.0) * (1 + 0.08 * rng.standard_normal(
                    repeats if i >= len(xs) - 3 else 1))))
                for i, x in enumerate(xs)]
            peak, _, _ = fit_saturation(xs, rates)
            worst[repeats] = max(worst[repeats], peak / level)
    assert worst[3] < 1.4 and worst[3] < worst[1]
    assert worst[3] * level < CARD_PEAKS["compute"]


def test_cli_calibrate_on_the_card_refuses_faulty_fits(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """``calibrate`` on the card writes nothing and exits 1 when a fit
    cannot stand (the card's rows and provenance stood in for here)."""
    import repro_torch.calib as calib_mod
    from repro_torch.obs import profile as prof
    xs = (128, 512, 2048, 8192)
    rows = [{"kernel": "rmsnorm", "kind": "memory", "axis": "m", "x": x,
             "flops_per_s": 1e9 * x, "bytes_per_s": 1e9 * x,
             "time_s": 1.0, "reps": 1, "impl": "cuda:rmsnorm"} for x in xs]
    monkeypatch.setattr(prof, "profile_kernels", lambda *a, **kw: rows)
    monkeypatch.setattr(calib_mod, "_provenance", lambda *a: {
        "backend": "cuda", "device": "card"})
    out = tmp_path / "calib.json"
    rc = cli.main(["calibrate", "--device", "cuda", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 1 and not out.exists()
    assert "nothing written" in text and "never bent" in text


def test_gmm_case_has_no_padding_rows():
    """The reference's equal groups become whole 16-row tiles at every
    grid point, so 2*t*k*n is exactly the work."""
    from repro_torch.obs import profile as prof
    for axis, x, build in prof._cases("moe_gmm", False, "cpu"):
        _, (xx, w, ids), flops, _, shape, _ = build()
        t = shape["t"]
        assert ids.numel() * prof._GMM_BLOCK_T == t == xx.shape[0]
        assert torch.bincount(ids.long()).tolist() == \
            [t // 4 // prof._GMM_BLOCK_T] * 4
        assert flops == 2.0 * t * shape["k"] * shape["n"]


def test_profile_rows_schema(quick_calib):
    from repro.obs.profile import profile_kernels as ref_profile
    _, ms = quick_calib
    ref = ref_profile(["rmsnorm", "moe_gmm"], quick=True, reps=1)
    assert len(ms) == len(ref)
    for a, b in zip(ref, ms):
        assert set(b) == set(a) | {"impl", "dtype"}
        assert (b["impl"], b["dtype"]) == ("torch", "float32")
        for k in ("kernel", "kind", "axis", "x", "shape", "flops", "bytes",
                  "reps"):
            assert b[k] == a[k], k
        assert b["time_s"] > 0
        assert b["flops_per_s"] == b["flops"] / b["time_s"]
        assert b["bytes_per_s"] == b["bytes"] / b["time_s"]
    assert {r["axis"] for r in ms if r["kernel"] == "moe_gmm"} == {"m", "n"}


def test_profile_rejects_unknown_kernel_and_defaults_to_the_card(
        monkeypatch):
    from repro_torch.obs.profile import profile_kernels
    with pytest.raises(KeyError):
        profile_kernels(["not_a_kernel"], quick=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_kernels(["rmsnorm"], quick=True)


def test_time_fn_is_best_of_reps_after_warmup():
    from repro_torch.obs.bench import time_fn
    calls = []
    t = time_fn(lambda x: calls.append(x), torch.zeros(1), reps=3, warmup=2)
    assert len(calls) == 5 and 0 < t < 1


# ---------------------------------------------------------------------------
# The artifact, the drift gate, the fidelity stamp and the CLI
# ---------------------------------------------------------------------------
def test_artifact_roundtrip_and_blocks(quick_calib, tmp_path):
    calib, _ = quick_calib
    p = write_calibration(calib, tmp_path / "c.json")
    assert load_calibration(str(p)) == json.loads(json.dumps(calib))
    blk = calibration_block(str(p))
    assert blk["measured_on"]["torch"] == torch.__version__
    assert blk["measured_on"]["backend"] == "cpu"
    ex = execution_block(calib)
    assert ex["source"] == DEFAULT_CALIB_PATH == "CALIB_h100.json"
    assert set(ex["kernels"]) == {"moe_gmm", "rmsnorm"}


def test_load_calibration_errors(tmp_path):
    with pytest.raises(ValueError, match="no calibration artifact"):
        load_calibration(str(tmp_path / "absent.json"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError, match="schema"):
        load_calibration(str(bad))


def test_drift_gate_catches_a_perturbed_peak(quick_calib):
    calib, _ = quick_calib
    bad = copy.deepcopy(calib)
    bad["kernels"]["moe_gmm"]["peak"] *= 1e3
    fails = {r["metric"] for r in check_drift(calib, bad) if not r["ok"]}
    assert "moe_gmm.peak" in fails
    bad2 = copy.deepcopy(calib)
    bad2["kernels"]["moe_gmm"]["m_half"] *= 1e3     # halves never gate
    assert all(r["ok"] for r in check_drift(calib, bad2))


def test_reference_artifacts_are_never_written(quick_calib, tmp_path):
    calib, _ = quick_calib
    before = {n: (ROOT / n).read_bytes()
              for n in ("CALIB.json", "FIDELITY.json")}
    with pytest.raises(ValueError, match="reference package"):
        write_calibration(calib, ROOT / "CALIB.json")
    with pytest.raises(ValueError, match="reference package"):
        stamp_fidelity(calib, ROOT / "FIDELITY.json")
    assert before == {n: (ROOT / n).read_bytes() for n in before}
    # a caller's report is stamped, the rest of it intact
    fid = tmp_path / "fidelity.json"
    assert stamp_fidelity(calib, tmp_path / "absent.json") is None
    fid.write_text(json.dumps({"schema": 1, "scenarios": []}))
    stamp_fidelity(calib, fid)
    report = json.loads(fid.read_text())
    assert report["execution"]["effective"] == \
        json.loads(json.dumps(calib["effective"]))
    assert report["scenarios"] == []


def test_cli_calibrate_roundtrip_and_check(tmp_path, capsys):
    out = tmp_path / "calib.json"
    rc = cli.main(["calibrate", "--device", "cpu", "--quick", "--kernels",
                   "rmsnorm,moe_gmm", "--out", str(out)])
    assert rc == 0 and out.exists()
    text = capsys.readouterr().out
    assert text.count("peak") >= 2 and "[torch]" in text
    assert [r["impl"] for r in json.loads(out.read_text())[
        "measurements"]] == ["torch"] * 13
    rc = cli.main(["calibrate", "--device", "cpu", "--quick", "--kernels",
                   "rmsnorm,moe_gmm", "--out", str(out), "--check"])
    assert rc == 0 and "OK: all" in capsys.readouterr().out
    calib = json.loads(out.read_text())
    calib["kernels"]["moe_gmm"]["peak"] *= 1e3
    calib["effective"]["die_tflops"] *= 1e3
    write_calibration(calib, out)
    rc = cli.main(["calibrate", "--device", "cpu", "--quick", "--kernels",
                   "rmsnorm,moe_gmm", "--out", str(out), "--check"])
    assert rc == 1 and "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--kernels", "bogus"],
    ["--kernels", "rmsnorm", "--check", "--out", "missing.json"],
    ["--kernels", "rmsnorm", "--out", "CALIB.json"]],
    ids=["unknown_kernel", "check_missing", "reference_artifact"])
def test_cli_calibrate_usage_errors(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT if "CALIB.json" in argv else tmp_path)
    before = COMMITTED.read_bytes()
    with pytest.raises(SystemExit) as ei:
        cli.main(["calibrate", "--device", "cpu", "--quick", *argv])
    assert ei.value.code == cli.EXIT_USAGE
    assert COMMITTED.read_bytes() == before


def test_fitted_peaks_are_finite(quick_calib):
    calib, _ = quick_calib
    for f in calib["kernels"].values():
        assert math.isfinite(f["peak"]) and f["peak"] > 0
    assert set(calib["effective"]) == {"die_tflops", "mfu_ceiling",
                                       "model_gemm_eff", "gemm_m_half",
                                       "gemm_n_half", "hbm_bw_per_die"}
