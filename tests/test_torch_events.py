"""The port's event wavefront and batch compilation against the
reference's numpy path, on the CPU.

``repro_torch.kernels.wavefront.wavefront_plain`` (the plain version of
the CUDA kernel, and what CPU tensors run) is held against
``repro.events.batch._wavefront_numpy`` and ``replay_rows(...,
backend="numpy")``: gpipe, 1f1b and interleaved, mixed shape keys in one
batch.  Interleaved is held against the numpy wavefront, not against the
scalar engine (ROADMAP C8), and nothing against the reference's jax
backend (C1).  Tolerance 1e-12 relative: the same float64 operations in
the same order.
"""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro.core.mcm as r_mcm
import repro.core.optimizer as r_opt
import repro.core.workload as r_workload
import repro.events.batch as r_batch
import repro.events.dag as r_dag
import repro_torch.configs as t_configs
import repro_torch.core.mcm as t_mcm
import repro_torch.core.traffic as t_traffic
import repro_torch.core.workload as t_workload
import repro_torch.events.batch as t_batch
import repro_torch.events.dag as t_dag
from repro.events.compile_batch import compile_batch as r_compile_batch
from repro_torch.events.compile_batch import compile_batch as t_compile_batch
from repro_torch.kernels import wavefront
from repro_torch.launch import wavefront_variants
from repro_torch.obs import metrics

RTOL = 1e-12

# committed shapes: paper_qwen3_validate's event re-rank replays keys up
# to S 16 x L 542 (interleaved, v 4, 64 micro-batches)
KEYS = {
    "gpipe": [("gpipe", 16, 1, 64), ("gpipe", 2, 1, 8)],
    "1f1b": [("1f1b", 16, 1, 64), ("1f1b", 8, 1, 32)],
    "interleaved": [("interleaved", 16, 4, 64), ("interleaved", 2, 2, 8)],
    "mixed": [("gpipe", 8, 1, 32), ("1f1b", 16, 1, 64),
              ("interleaved", 8, 2, 32), ("interleaved", 1, 1, 1)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(keys, k=16, seed=0):
    """Key indices and (6, K) rows like an event re-rank call's: spans of
    1-20 ms, a DP all-reduce on most records, one with none."""
    rng = np.random.default_rng(seed)
    key_rows = rng.integers(0, len(keys), k)
    t_dp = rng.uniform(0.0, 0.05, k) * (rng.random(k) < 0.7)
    rows = np.stack([rng.uniform(1e-3, 1e-2, k), rng.uniform(1e-3, 2e-2, k),
                     t_dp, rng.uniform(0.0, 0.05, k),
                     np.array([keys[i][2] * keys[i][3] for i in key_rows],
                              np.float64),
                     rng.uniform(0.5, 2.0, k)])
    return key_rows, rows


@pytest.mark.parametrize("key", sorted({k for ks in KEYS.values()
                                        for k in ks}),
                         ids=lambda k: "-".join(map(str, k)))
def test_shape_tables_match_reference(key):
    for a, b in zip(r_batch._shape_tables(*key), t_batch._shape_tables(*key)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(KEYS))
def test_wavefront_plain_matches_numpy(case):
    keys = KEYS[case]
    key_rows, rows = _inputs(keys)
    body = r_batch._wavefront_numpy(*r_batch._stack_tables(keys, key_rows),
                                    rows[0], rows[1])
    ref = r_batch.replay_rows(keys, key_rows, rows, backend="numpy")
    tabs = [torch.from_numpy(np.array(t))
            for t in t_batch._key_tables(tuple(keys))]
    out = wavefront.wavefront_plain(*tabs, torch.from_numpy(key_rows),
                                    torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(out[1], body, rtol=RTOL)
    for i, name in enumerate(wavefront.RES_KEYS):
        np.testing.assert_allclose(out[i], ref[name], rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(KEYS))
def test_pack_codes_match_a_loop_over_the_tables(case):
    """The kernel's packed level codes (their plain version): each
    (key, level, stage) cell by a direct loop over the (S, L) tables."""
    ldir, ldep_s, ldep_l = t_batch._key_tables(tuple(KEYS[case]))
    U, S, L = ldir.shape
    code = wavefront.pack_codes(*(torch.from_numpy(np.array(t))
                                  for t in (ldir, ldep_s, ldep_l)))
    assert code.dtype == torch.int32 and tuple(code.shape) == (U, L, S)
    want = np.empty((U, L, S), np.int64)
    for u in range(U):
        for s in range(S):
            for lv in range(L):
                d = int(ldir[u, s, lv])
                ds, dl = int(ldep_s[u, s, lv]), int(ldep_l[u, s, lv])
                dep = dl * S + ds if ds >= 0 else -1
                want[u, lv, s] = -1 if d < 0 else (dep + 1) * 2 + d
    assert np.array_equal(code.numpy(), want)


@pytest.mark.parametrize("case", sorted(KEYS))
def test_the_codes_replay_as_the_plain_wavefront(case):
    """The kernel's level loop, written out over the packed codes (one
    history read, a max, an add a level), gives wavefront_plain's
    makespans bit for bit."""
    keys = KEYS[case]
    key_rows, rows = _inputs(keys, k=6, seed=1)
    tabs = [torch.from_numpy(np.array(t))
            for t in t_batch._key_tables(tuple(keys))]
    code = wavefront.pack_codes(*tabs).numpy()
    _, L, S = code.shape
    body = wavefront.wavefront_plain(*tabs, torch.from_numpy(key_rows),
                                     torch.from_numpy(rows))[1].numpy()
    for k, key in enumerate(key_rows):
        hist = np.zeros(L * S)
        ends = np.zeros(S)
        for lv in range(L):
            for s in range(S):
                c = int(code[key, lv, s])
                dep = (c >> 1) - 1
                v = max(ends[s], hist[dep] if dep >= 0 else 0.0) \
                    + (rows[1, k] if c & 1 else rows[0, k])
                hist[lv * S + s] = v if c >= 0 else 0.0
                ends[s] = v if c >= 0 else ends[s]
        assert ends.max() == body[k]


@pytest.mark.parametrize("name", sorted(wavefront_variants.VARIANTS))
def test_wavefront_variants_patch_the_kernel_source(name):
    """Each timed variant of the wavefront kernel is the source with its
    text replaced once (the probe refuses a patch that no longer
    applies)."""
    src = wavefront_variants.variant_source(wavefront_variants.VARIANTS[name])
    assert "wavefront_kernel" in src
    for old, new in wavefront_variants.VARIANTS[name]:
        assert new in src and old not in src


@pytest.mark.parametrize("case", sorted(KEYS))
def test_replay_rows_matches_numpy(case):
    keys = KEYS[case]
    key_rows, rows = _inputs(keys, seed=1)
    ref = r_batch.replay_rows(keys, key_rows, rows, backend="numpy")
    with metrics.scope() as m:
        got = t_batch.replay_rows(keys, key_rows, rows, device="cpu")
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   err_msg=name)
    assert m.counters["batch_replay.device_calls"] == 1
    assert m.counters["batch_replay.records"] == len(key_rows)


def _cases():
    """(reference, port) workload and MCM pairs: dense, MoE, hybrid."""
    out = []
    for model, seq, gb, C in (("tinyllama_1_1b", 4096, 256, 1e6),
                              ("qwen3_moe_235b_a22b", 10240, 512, 4e6),
                              ("zamba2_7b", 4096, 256, 1e6)):
        pair = []
        for configs, workload, mcm in ((r_configs, r_workload, r_mcm),
                                       (t_configs, t_workload, t_mcm)):
            pair.append((workload.Workload(model=configs.get_config(model),
                                           seq_len=seq, global_batch=gb),
                         mcm.mcm_from_compute(C, 16, 6)))
        out.append((model, pair))
    return out


CASES = _cases()


def _strategies(w, mcm, n=10):
    """The first n feasible strategies with a pipeline (pp > 1) and the
    first few without, from the reference's grid."""
    grid = [s for s in r_opt.enumerate_strategies(w, mcm)
            if r_opt.simulate(w, s, mcm).feasible]
    return [s for s in grid if s.pp > 1][:n] + grid[:3]


def _port_strategy(s):
    return t_traffic.Strategy(*astuple(s))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compile_batch_matches_reference(case, schedule):
    _, ((w, mcm), (pw, pmcm)) = case
    ss = _strategies(w, mcm)
    cb = r_compile_batch(w, ss, mcm, schedule=schedule)
    pcb = t_compile_batch(pw, [_port_strategy(s) for s in ss], pmcm,
                          schedule=schedule, device="cpu")
    assert np.array_equal(cb.feasible, pcb.feasible)
    assert np.array_equal(cb.key_rows, pcb.key_rows)
    assert cb.shape_keys == pcb.shape_keys
    assert np.array_equal(cb.v, pcb.v)
    np.testing.assert_allclose(pcb.rows, cb.rows, rtol=RTOL)
    ref, got = cb.replay(backend="numpy"), pcb.replay(device="cpu")
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   err_msg=name)


def test_replay_batch_of_programs_matches_reference():
    """StepPrograms from each package's compile_step, mixed schedules."""
    _, ((w, mcm), (pw, pmcm)) = CASES[1]
    ss = _strategies(w, mcm, n=4)
    progs, pprogs = [], []
    for i, s in enumerate(ss):
        sched = ("gpipe", "1f1b", "interleaved")[i % 3]
        progs.append(r_dag.compile_step(w, s, mcm, schedule=sched))
        pprogs.append(t_dag.compile_step(pw, _port_strategy(s), pmcm,
                                         schedule=sched))
    ref = r_batch.replay_batch(progs, backend="numpy")
    got = t_batch.replay_batch(pprogs, device="cpu")
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   err_msg=name)


def test_compile_batch_marks_infeasible():
    _, ((w, mcm), (pw, pmcm)) = CASES[0]
    good = _port_strategy(_strategies(w, mcm)[0])
    bad = t_traffic.Strategy(tp=3, dp=1, pp=1, cp=1, ep=1, n_micro=1)
    pcb = t_compile_batch(pw, [good, bad], pmcm, device="cpu")
    assert pcb.feasible.tolist() == [True, False]
    out = pcb.replay(device="cpu")
    assert np.isfinite(out["step_time"][0]) and out["step_time"][1] == np.inf


def test_wavefront_checks_its_inputs():
    keys = KEYS["mixed"]
    key_rows, rows = _inputs(keys, k=4)
    tabs = [torch.from_numpy(np.array(t))
            for t in t_batch._key_tables(tuple(keys))]
    kr, r = torch.from_numpy(key_rows), torch.from_numpy(rows)
    with pytest.raises(IndexError):
        wavefront.wavefront(*tabs, torch.tensor([0, 1, 2, len(keys)]), r)
    with pytest.raises(TypeError):
        wavefront.wavefront(*(t.long() for t in tabs), kr, r)
    with pytest.raises(ValueError):
        wavefront.wavefront(*tabs, kr, r.float())
    with pytest.raises(ValueError):
        wavefront.wavefront(*tabs, kr[:3], r)
    assert wavefront.launches == 0          # CPU tensors run the plain path
    assert torch.equal(wavefront.wavefront(*tabs, kr, r),
                       wavefront.wavefront_plain(*tabs, kr, r))


def test_replay_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = KEYS["gpipe"]
    key_rows, rows = _inputs(keys, k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_batch.replay_rows(keys, key_rows, rows)
