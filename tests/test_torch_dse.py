"""The port's batched analytic scan against the reference's numpy path,
on the CPU.

``repro_torch.dse.batched_sim.batched_simulate`` runs its cost terms in
float64 torch (here on CPU tensors, the plain path); the reference runs
them in numpy (``backend="numpy"``; its jax backend is not a reference
here, ROADMAP C1).  Tolerance 1e-9 relative, the bar of
``tests/test_dse.py``; the terms keep numpy's operation order, so step
times are also required to be bit-identical: a one-ulp difference could
swap two tied rows in the study's stable sort.
"""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro.core.mcm as r_mcm
import repro.core.workload as r_workload
import repro.dse.batched_sim as r_bs
import repro.dse.search as r_search
import repro.dse.space as r_space
import repro_torch.configs as t_configs
import repro_torch.core.mcm as t_mcm
import repro_torch.core.workload as t_workload
import repro_torch.dse.batched_sim as t_bs
import repro_torch.dse.search as t_search
import repro_torch.dse.space as t_space
from repro_torch.obs import metrics

RTOL = 1e-9
FLOAT_FIELDS = ("step_time", "throughput", "mfu", "power", "t_comp",
                "t_mem", "t_coll", "exposed", "dp_exposed", "bubble")
EXACT_FIELDS = ("feasible", "reuse_active", "reason_code")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# workload: (model, seq_len, global_batch); the paper's Qwen3-MoE (EP, CP
# groups), TinyLlama (dense) and Zamba2 (hybrid, SSM parameters)
WORKLOADS = {"qwen3": ("qwen3_moe_235b_a22b", 10240, 512),
             "tinyllama": ("tinyllama_1_1b", 4096, 256),
             "zamba2": ("zamba2_7b", 16384, 256)}


def _cell(pkg, name, C=2e6, dies=16, m=6, **hw):
    """(workload, mcm, strategy batch) of one cell from one package."""
    configs, workload, mcm_mod, space = pkg
    model, seq, gb = WORKLOADS[name]
    w = workload.Workload(model=configs.get_config(model), seq_len=seq,
                          global_batch=gb)
    mcm = mcm_mod.mcm_from_compute(C, dies_per_mcm=dies, m=m)
    if hw:
        import dataclasses
        mcm = dataclasses.replace(mcm, hw=dataclasses.replace(mcm.hw, **hw))
    return w, mcm, space.enumerate_strategy_batch(w, mcm)


REF = (r_configs, r_workload, r_mcm, r_space)
PORT = (t_configs, t_workload, t_mcm, t_space)


def _assert_same(rr, rt):
    for f in EXACT_FIELDS:
        assert np.array_equal(getattr(rr, f), getattr(rt, f)), f
    ok = rr.feasible
    for f in FLOAT_FIELDS:
        a, b = getattr(rr, f), getattr(rt, f)
        np.testing.assert_allclose(b[ok], a[ok], rtol=RTOL, err_msg=f)
    assert np.array_equal(rr.step_time, rt.step_time)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no-reuse"])
@pytest.mark.parametrize("fabric", ["oi", "ib", "nvlink"])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_batched_simulate_matches_numpy(name, fabric, reuse):
    w, mcm, batch = _cell(REF, name)
    pw, pmcm, pbatch = _cell(PORT, name)
    assert len(batch) == len(pbatch) > 0
    rr = r_bs.batched_simulate(w, batch, mcm, fabric=fabric, reuse=reuse,
                               backend="numpy")
    rt = t_bs.batched_simulate(pw, pbatch, pmcm, fabric=fabric, reuse=reuse,
                               device="cpu")
    assert rr.feasible.any()
    _assert_same(rr, rt)


@pytest.mark.parametrize("case", ["railx", "paper-reuse-mode", "dies-32"])
def test_batched_simulate_other_paths(case):
    """The RailX link split, the paper's OCS reuse mode (no bank-swap gate)
    and an MCM of 32 dies (intra groups of 8 and more: the dilation's
    square root)."""
    kw, cell = {}, {}
    if case == "railx":
        kw = {"alloc_mode": "railx"}
    elif case == "paper-reuse-mode":
        cell = {"ocs_reuse_mode": "paper"}
    else:
        cell = {"dies": 32, "m": 4}
    w, mcm, batch = _cell(REF, "qwen3", **cell)
    pw, pmcm, pbatch = _cell(PORT, "qwen3", **cell)
    rr = r_bs.batched_simulate(w, batch, mcm, backend="numpy", **kw)
    rt = t_bs.batched_simulate(pw, pbatch, pmcm, device="cpu", **kw)
    _assert_same(rr, rt)


def _fused(space_mod, configs, workload, fabrics=("oi",)):
    w = workload.Workload(model=configs.get_config("tinyllama_1_1b"),
                          seq_len=4096, global_batch=256)
    space = space_mod.DesignSpace.from_compute(
        w, 1e6, fabrics=fabrics, m=(2, 6), cpo_ratio=(0.3, 0.9))
    cells = list(space.batches())
    fused = space_mod.StrategyBatch.concat([g for _, _, g in cells])
    local = np.concatenate([np.full(len(g), i, np.int64)
                            for i, (_, _, g) in enumerate(cells)])
    return w, fused, [m for m, _, _ in cells], local, space


def test_fused_mcm_batch_matches_numpy():
    w, fused, mcms, local, _ = _fused(r_space, r_configs, r_workload)
    pw, pfused, pmcms, plocal, _ = _fused(t_space, t_configs, t_workload)
    rr = r_bs.batched_simulate(w, fused, r_bs.MCMBatch.from_mcms(mcms, local),
                               hw=mcms[0].hw, backend="numpy")
    rt = t_bs.batched_simulate(pw, pfused,
                               t_bs.MCMBatch.from_mcms(pmcms, plocal),
                               hw=pmcms[0].hw, device="cpu")
    _assert_same(rr, rt)


@pytest.mark.parametrize("driver,kw", [
    ("exhaustive", {}), ("random", {"budget": 48}), ("prf", {"budget": 48}),
    ("nsga2", {"pop_size": 16, "generations": 3})],
    ids=["exhaustive", "random", "prf", "nsga2"])
def test_sweep_drivers_match_numpy(driver, kw):
    """Each batched driver over a fused two-fabric space: the same rows in
    the same order, the same metrics, the same refined winners."""
    *_, space = _fused(r_space, r_configs, r_workload, ("oi", "ib"))
    *_, pspace = _fused(t_space, t_configs, t_workload, ("oi", "ib"))
    rs = r_search.sweep_design_space(space, driver=driver, backend="numpy",
                                     seed=1, **kw)
    ts = t_search.sweep_design_space(pspace, driver=driver, device="cpu",
                                     seed=1, **kw)
    assert len(rs) == len(ts) > 0
    assert np.array_equal(rs.mcm_idx, ts.mcm_idx)
    assert np.array_equal(rs.fabric, ts.fabric)
    for f in ("tp", "dp", "pp", "cp", "ep", "n_micro"):
        assert np.array_equal(getattr(rs.batch, f), getattr(ts.batch, f)), f
    assert np.array_equal(rs.metrics["feasible"], ts.metrics["feasible"])
    for f in ("step_time", "throughput", "mfu", "power", "cost"):
        ok = rs.metrics["feasible"]
        np.testing.assert_allclose(ts.metrics[f][ok], rs.metrics[f][ok],
                                   rtol=RTOL, err_msg=f)
    rp = r_search.refine_top_points(rs, top_k=4)
    tp = t_search.refine_top_points(ts, top_k=4, device="cpu")
    assert len(rp) == len(tp) > 0
    for a, b in zip(rp, tp):
        assert astuple(a.strategy) == astuple(b.strategy)
        assert astuple(a.mcm)[:5] == astuple(b.mcm)[:5]
        assert a.fabric == b.fabric
        assert repr(a.topo) == repr(b.topo)
        np.testing.assert_allclose([b.throughput, b.cost],
                                   [a.throughput, a.cost], rtol=RTOL)


def test_scan_counts_and_times_its_device_calls():
    from repro_torch.obs.trace import tracing
    pw, pmcm, pbatch = _cell(PORT, "tinyllama")
    with tracing() as tr, metrics.scope() as m:
        res = t_bs.batched_simulate(pw, pbatch, pmcm, device="cpu")
    assert m.counters["batched_sim.device_calls"] == 1
    spans = [e for e in tr.events if e["name"] == "batched_sim.terms"]
    assert len(spans) == 1
    assert spans[0]["args"] == {"rows": int(res.feasible.sum()),
                                "device": "cpu"}


def test_scan_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pw, pmcm, pbatch = _cell(PORT, "tinyllama")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bs.batched_simulate(pw, pbatch, pmcm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_search.sweep_design_space(
            _fused(t_space, t_configs, t_workload)[-1])
