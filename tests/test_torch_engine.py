"""The port's scalar event engine against the reference's, on the CPU.

``repro_torch.events.replay`` is host code (heapq, Python floats) copied
from ``repro.events.replay``: on the same programs (each package's own
``compile_step`` of ``tests/test_events.py``'s dense, MoE and hybrid
cases, every schedule, the timeline recorded and not) every field of the
``EventResult`` must be equal, bit for bit.  Then the engine's own
properties (determinism, byte conservation), and the port's batched
wavefront on the CPU against the port's engine within 5% for gpipe and
1f1b, the bound of the reference's ``test_batch_replay_matches_scalar``
(interleaved is not held to the engine, ROADMAP C8).
"""
import dataclasses
from dataclasses import astuple

import pytest

import repro.configs as r_configs
import repro.core.mcm as r_mcm
import repro.core.optimizer as r_opt
import repro.core.workload as r_workload
import repro.events as r_events
import repro_torch.configs as t_configs
import repro_torch.core.mcm as t_mcm
import repro_torch.core.simulator as t_sim
import repro_torch.core.traffic as t_traffic
import repro_torch.core.workload as t_workload
import repro_torch.events as t_events

SCHEDULES = ("gpipe", "1f1b", "interleaved")
BATCH_RTOL = 0.05

# tests/test_events.py's _CASES: model, seq, global batch, total TFLOPS
MODELS = (("tinyllama_1_1b", 4096, 256, 1e6),
          ("qwen3_moe_235b_a22b", 10240, 512, 4e6),
          ("zamba2_7b", 4096, 256, 1e6))


def _cases():
    """(name, (reference workload, MCM), (port workload, MCM),
    strategies): the two best feasible strategies and the best pipelined
    one of the reference's grid."""
    out = []
    for model, seq, gb, C in MODELS:
        pair = []
        for configs, workload, mcm in ((r_configs, r_workload, r_mcm),
                                       (t_configs, t_workload, t_mcm)):
            pair.append((workload.Workload(model=configs.get_config(model),
                                           seq_len=seq, global_batch=gb),
                         mcm.mcm_from_compute(C, 16, 6)))
        w, mcm = pair[0]
        grid = []
        for s in r_opt.enumerate_strategies(w, mcm):
            r = r_opt.simulate(w, s, mcm)
            if r.feasible:
                grid.append((r.throughput, s))
        grid = [s for _, s in sorted(grid, key=lambda t: -t[0])]
        picks = grid[:2] + [s for s in grid if s.pp > 1][:1]
        out.append((model, pair[0], pair[1], picks))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _port_strategy(s):
    return t_traffic.Strategy(*astuple(s))


def _programs(case, schedule):
    _, (w, mcm), (pw, pmcm), picks = case
    for s in picks:
        yield (r_events.compile_step(w, s, mcm, schedule=schedule),
               t_events.compile_step(pw, _port_strategy(s), pmcm,
                                     schedule=schedule))


@pytest.mark.parametrize("timeline", [False, True], ids=["plain",
                                                         "timeline"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_matches_reference_bit_for_bit(case, schedule, timeline):
    for prog, pprog in _programs(case, schedule):
        want = r_events.replay(prog, record_timeline=timeline)
        got = t_events.replay(pprog, record_timeline=timeline)
        assert type(got).__name__ == "EventResult"
        want_d, got_d = dataclasses.asdict(want), dataclasses.asdict(got)
        assert set(got_d) == set(want_d)
        for field, value in want_d.items():
            # == on floats is bit equality here, NaN aside (err of a
            # program without an analytic time)
            assert repr(got_d[field]) == repr(value), field
        if timeline:
            assert got.device_timeline and got.timeline


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_deterministic(case):
    _, _, (pw, pmcm), picks = case
    s = _port_strategy(next(s for s in picks if s.pp > 1))
    a = t_events.replay(t_events.compile_step(pw, s, pmcm,
                                              schedule="1f1b"),
                        record_timeline=True)
    b = t_events.replay(t_events.compile_step(pw, s, pmcm,
                                              schedule="1f1b"),
                        record_timeline=True)
    assert a == b


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replay_conserves_bytes(case):
    """The representative stage moves each parallelism's volume once per
    segment it crosses (intra- and inter-MCM), as the analytic model's
    traffic volumes say."""
    _, _, (pw, pmcm), picks = case
    for s in map(_port_strategy, picks):
        prog = t_events.compile_step(pw, s, pmcm, schedule="gpipe")
        r = t_events.replay(prog)
        intra, inter = t_sim.map_intra(pw, s, pmcm)
        vols = t_traffic.traffic_volumes(pw, s)
        for p in t_traffic.PARALLELISMS:
            segs = (1 if intra.get(p, 1) > 1 else 0) \
                + (1 if inter.get(p, 1) > 1 else 0)
            want = vols[p] * segs
            got = r.bytes_moved.get(p, 0.0)
            if want == 0.0:
                assert got == 0.0
            else:
                assert got == pytest.approx(want, rel=1e-6), p
                assert prog.bytes_expected[p] == pytest.approx(want,
                                                               rel=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_replay_matches_engine(case):
    progs = [pprog for sched in ("gpipe", "1f1b")
             for _, pprog in _programs(case, sched)]
    out = t_events.replay_batch(progs, device="cpu")
    for j, p in enumerate(progs):
        r = t_events.replay(p)
        assert out["step_time"][j] == pytest.approx(r.step_time,
                                                    rel=BATCH_RTOL)
        assert out["analytic_step_time"][j] == \
            pytest.approx(r.analytic_step_time, rel=1e-12)
