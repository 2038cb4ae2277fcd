"""The port's trainer runtime on the CPU: the data pipeline, checkpoints,
the fault-tolerant loop, gradient compression and ``launch.train``.

The pipeline is held to the reference's contract (keys, shapes, dtypes,
the vlm's loss mask, the marginals), not to its draws: the reference
draws with ``jax.random``, the port from a seeded ``torch.Generator``.
Compression is held to the reference bit for bit (the same float32
operations).  One train step of the port from a reference train state
(``convert.train_state_from_jax``) on the reference pipeline's batch is
held to the reference's step at ``tests/test_torch_train.py``'s
tolerances: the loss within 1e-5 relative, the parameters, m and v
within 1e-5 relative L2.  Crash-restore of reduced TinyLlama and Mamba2
through the port's ``FaultTolerantLoop`` must end bit for bit where an
unbroken run ends, as ``tests/test_substrate.py`` requires of the
reference.
"""
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data import DataPipeline as JaxDataPipeline
from repro.launch.steps import init_train_state as jax_init_train_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.common import ExecConfig as JaxExecConfig
from repro.optim import compress_int8 as jax_compress_int8
from repro.optim import decompress_int8 as jax_decompress_int8
from repro.optim import ef_compress_update as jax_ef_compress_update
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.data import DataPipeline
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models import ExecConfig, build_model
from repro_torch.optim import (AdamWState, compress_int8, decompress_int8,
                               ef_compress_update)
from repro_torch.runtime import FaultTolerantLoop

EX = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
JEX = JaxExecConfig(ssd_chunk=8, attn_block=16)
SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=4)
JSHAPE = JaxShapeConfig("t", "train", seq_len=32, global_batch=4)
FAMILIES = ["tinyllama_1_1b", "mixtral_8x7b", "llava_next_34b",
            "zamba2_7b", "mamba2_780m", "whisper_medium"]
LR = dict(base_lr=5e-3, warmup=5, total=120)
LOSS_RTOL = 1e-5
UPDATE_REL_L2 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _state_arrays(state: TrainState) -> dict:
    """Every tensor of a train state as numpy, and the step."""
    out = {f"p/{n}": p.detach().numpy().copy()
           for n, p in state.model.named_parameters()}
    out.update({f"m/{n}": t.numpy().copy() for n, t in state.opt.m.items()})
    out.update({f"v/{n}": t.numpy().copy() for n, t in state.opt.v.items()})
    out["step"] = np.asarray(state.opt.step)
    return out


def _assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------
def test_pipeline_is_a_pure_function_of_seed_and_step():
    cfg = get_config("tinyllama_1_1b").reduced()
    a = DataPipeline(cfg, SHAPE, seed=3, device="cpu")
    b = DataPipeline(cfg, SHAPE, seed=3, device="cpu")
    for _ in range(2):
        next(b)                       # iteration does not change batch_at
    for k in (0, 5):
        x, y = a.batch_at(k), b.batch_at(k)
        assert all(torch.equal(x[n], y[n]) for n in x)
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    c = DataPipeline(cfg, SHAPE, seed=4, device="cpu")
    assert not torch.equal(a.batch_at(0)["tokens"], c.batch_at(0)["tokens"])


def test_pipeline_checkpoint_and_restore_resume_the_stream():
    cfg = get_config("tinyllama_1_1b").reduced()
    a = DataPipeline(cfg, SHAPE, seed=7, device="cpu")
    for _ in range(3):
        next(a)
    ck = a.checkpoint()
    assert ck == {"seed": 7, "step": 3}
    b = DataPipeline(cfg, SHAPE, seed=0, device="cpu")
    b.restore(json.loads(json.dumps(ck)))
    x, y = next(a), next(b)
    assert all(torch.equal(x[n], y[n]) for n in x)
    assert b.state.step == 4


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_pipeline_batch_matches_reference_contract(arch, compute):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    want = JaxDataPipeline(jcfg, JSHAPE, seed=1, ex=JaxExecConfig(
        compute_dtype=getattr(jnp, compute))).batch_at(2)
    got = DataPipeline(cfg, SHAPE, seed=1, ex=ExecConfig(
        compute_dtype=getattr(torch, compute), device="cpu")).batch_at(2)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert got[k].device.type == "cpu"
    for k in ("tokens", "labels"):
        t = got[k]
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab - 1
        # u**2 * (vocab - 1): mean (vocab - 1) / 3, as the reference's
        mean = float(t.double().mean()) / (cfg.vocab - 1)
        assert abs(mean - 1 / 3) < 0.05
        assert abs(float(np.asarray(want[k]).mean()) / (cfg.vocab - 1)
                   - 1 / 3) < 0.05
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    if "loss_mask" in want:
        assert np.array_equal(got["loss_mask"].float().numpy(),
                              np.asarray(want["loss_mask"], np.float32))
    for k, scale in (("prefix_embeds", 0.02), ("encoder_embeds", 0.1)):
        if k in want:
            assert float(got[k].float().std()) == pytest.approx(scale,
                                                                rel=0.1)


def test_pipeline_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama_1_1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(cfg, SHAPE)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "h": torch.randn(5, generator=g).to(torch.bfloat16),
            "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "opt": AdamWState(step=7, m={"a": torch.ones(2)},
                              v={"a": torch.full((2,), 0.5)}),
            "lst": [np.arange(4, dtype=np.int64), 2.5]}


def _zeros_like(tree):
    return {"w": torch.zeros(3, 4), "h": torch.zeros(5, dtype=torch.bfloat16),
            "i": torch.zeros(2, 3, dtype=torch.int32),
            "opt": AdamWState(step=0, m={"a": torch.zeros(2)},
                              v={"a": torch.zeros(2)}),
            "lst": [np.zeros(4, np.int64), 0.0]}


def _assert_tree_equal(got, want):
    for k in ("w", "h", "i"):
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert got["opt"].step == want["opt"].step
    assert type(got["opt"]) is AdamWState
    assert torch.equal(got["opt"].m["a"], want["opt"].m["a"])
    assert torch.equal(got["opt"].v["a"], want["opt"].v["a"])
    assert np.array_equal(got["lst"][0], want["lst"][0])
    assert got["lst"][1] == want["lst"][1]


def test_save_restore_pytree_round_trip_in_place(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "t")
    assert (tmp_path / "t" / "COMMITTED").exists()
    template = _zeros_like(tree)
    w = template["w"]
    got = restore_pytree(template, tmp_path / "t")
    _assert_tree_equal(got, tree)
    assert got["w"] is w              # the live tensor took the values


def test_bf16_leaves_travel_as_uint16_bits(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "t")
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    dtypes = dict(zip(manifest["names"], manifest["dtypes"]))
    assert dtypes["h"] == "bfloat16" and dtypes["w"] == "float32"
    got = restore_pytree(_zeros_like(tree), tmp_path / "t")
    assert torch.equal(got["h"].view(torch.int16),
                       tree["h"].view(torch.int16))


def test_restore_refuses_a_wrong_shape(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "t")
    bad = _zeros_like(tree)
    bad["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(bad, tmp_path / "t")


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    tree = {"x": torch.zeros(2)}
    for s in (10, 20, 30):
        mgr.save(s, tree)
    assert mgr.all_steps() == [20, 30]
    assert mgr.latest_step() == 30
    assert mgr.last_save["step"] == 30 and mgr.last_save["bytes"] == 8
    assert mgr.last_save["write_s"] >= 0.0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030"]


def test_uncommitted_step_is_invisible(tmp_path):
    """A crash mid-write leaves a directory without COMMITTED (or the
    ``.tmp`` one): it is not listed, cannot be restored, and the previous
    step stays the latest."""
    mgr = CheckpointManager(tmp_path, keep=3, async_write=False)
    mgr.save(4, {"x": torch.ones(2)})
    save_pytree({"x": torch.zeros(2)}, tmp_path / "step_00000008")
    (tmp_path / "step_00000008" / "COMMITTED").unlink()
    (tmp_path / "step_00000012.tmp").mkdir()
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError, match="not committed"):
        mgr.restore(8, {"x": torch.zeros(2)})
    state, extra = mgr.restore(4, {"x": torch.zeros(2)})
    assert torch.equal(state["x"], torch.ones(2)) and extra == {}


def test_async_save_survives_the_next_in_place_step(tmp_path):
    """``save`` copies to the host before it returns: the next step's
    in-place update must not reach the checkpoint being written."""
    mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
    p = torch.arange(1 << 20, dtype=torch.float32)
    m = {"a": torch.ones(1 << 20)}
    state = {"p": p, "opt": AdamWState(step=1, m=m, v=m)}
    want = p.clone()
    mgr.save(1, state, extra={"seed": 5, "step": 1})
    for _ in range(20):               # in place, as adamw_update_
        p.mul_(3.0).add_(1.0)
        m["a"].add_(1.0)
    mgr.wait()
    fresh = {"p": torch.zeros_like(p),
             "opt": AdamWState(step=0, m={"a": torch.zeros(1 << 20)},
                               v={"a": torch.zeros(1 << 20)})}
    got, extra = mgr.restore(1, fresh)
    assert torch.equal(got["p"], want)
    assert torch.equal(got["opt"].m["a"], torch.ones(1 << 20))
    assert got["opt"].step == 1 and extra == {"seed": 5, "step": 1}


def test_a_failed_write_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep=3, async_write=True)
    (tmp_path / "ck" / "step_00000001.tmp").write_text("a file, not a dir")
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                        # raised once
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------
def _cfg(arch):
    return get_config(arch).reduced()


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_780m"])
def test_crash_restore_bitwise_identical(arch, tmp_path):
    cfg = _cfg(arch)
    step = make_train_step(cfg, EX, base_lr=1e-4)
    pipe = DataPipeline(cfg, SHAPE, seed=3, ex=EX)
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    loop = FaultTolerantLoop(step, mgr, pipe, checkpoint_every=4)
    state, last = loop.run(init_train_state(cfg, EX, seed=0), 6)
    assert last == 6 and mgr.all_steps() == [4]

    # uninterrupted reference: 10 steps straight
    pipe_ref = DataPipeline(cfg, SHAPE, seed=3, ex=EX)
    ref = init_train_state(cfg, EX, seed=0)
    for i in range(10):
        ref, _ = step(ref, pipe_ref.batch_at(i))

    # "crash": a fresh state from another seed, resume at 4, run to 10
    pipe2 = DataPipeline(cfg, SHAPE, seed=0, ex=EX)
    loop2 = FaultTolerantLoop(step, mgr, pipe2, checkpoint_every=100)
    fresh = init_train_state(cfg, EX, seed=9)
    restored, start = loop2.resume_or_init(fresh)
    assert start == 4 and restored.model is fresh.model
    assert pipe2.checkpoint() == {"seed": 3, "step": 4}
    assert restored.opt.step == 4
    state2, last2 = loop2.run(restored, 10, start_step=start)
    assert last2 == 10
    _assert_bitwise(_state_arrays(state2), _state_arrays(ref))


def test_resume_or_init_without_checkpoint(tmp_path):
    cfg = _cfg("tinyllama_1_1b")
    loop = FaultTolerantLoop(make_train_step(cfg, EX),
                             CheckpointManager(tmp_path), DataPipeline(
                                 cfg, SHAPE, seed=2, ex=EX))
    state = init_train_state(cfg, EX)
    got, start = loop.resume_or_init(state)
    assert got is state and start == 0


def test_preemption_finishes_the_step_and_checkpoints(tmp_path):
    cfg = _cfg("tinyllama_1_1b")
    mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
    pipe = DataPipeline(cfg, SHAPE, seed=1, ex=EX)
    loop = FaultTolerantLoop(make_train_step(cfg, EX), mgr, pipe,
                             checkpoint_every=100)
    assert threading.current_thread() is threading.main_thread()
    seen = []

    def on_metrics(step, metrics, dt):
        seen.append(step)
        if step == 2:
            # the loop's handler, not the default that ends the process
            assert signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, signal.SIG_IGN, None)
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    state, last = loop.run(init_train_state(cfg, EX), 10,
                           on_metrics=on_metrics)
    assert last == 2 and seen == [1, 2] and loop.preempted
    assert mgr.all_steps() == [2]
    assert (tmp_path / "step_00000002" / "COMMITTED").exists()
    assert signal.getsignal(signal.SIGTERM) == before
    _, extra = mgr.restore(2, init_train_state(cfg, EX))
    assert extra == {"seed": 1, "step": 2}


class _StepClock:
    """A clock that moves only while a step runs, by that step's time: the
    loop's straggler check then reads the step times a test sets, not the
    host's load."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _straggler_loop(tmp_path, first_step=None):
    """A loop whose steps take 10 ms on its clock, the fourth 500 ms;
    ``first_step`` runs before the first step (not on the clock)."""
    cfg = _cfg("tinyllama_1_1b")
    step = make_train_step(cfg, EX)
    clock = _StepClock()
    calls = []

    def slow_step(state, batch):
        calls.append(1)
        if len(calls) == 1 and first_step is not None:
            first_step()
        clock.now += 0.5 if len(calls) == 4 else 0.010
        return step(state, batch)

    loop = FaultTolerantLoop(slow_step, CheckpointManager(tmp_path),
                             DataPipeline(cfg, SHAPE, seed=1, ex=EX),
                             checkpoint_every=100, clock=clock)
    loop.run(init_train_state(cfg, EX), 5)
    return loop


def test_straggler_steps_and_watchdog(tmp_path):
    loop = _straggler_loop(tmp_path)
    assert loop.step_times == pytest.approx([0.010] * 3 + [0.5, 0.010])
    assert [s for s, _, _ in loop.straggler_steps] == [3]
    loop.watchdog.deadline_s = -1.0
    with pytest.raises(TimeoutError):
        loop.watchdog.check()


def test_slow_first_step_does_not_hide_straggler(tmp_path):
    """A first step that is slow on the host (a warm-up, a loaded machine)
    seeds nothing: the EWMA reads the loop's clock, so step 3 is still
    the one straggler."""
    import time
    loop = _straggler_loop(tmp_path, first_step=lambda: time.sleep(0.3))
    assert loop.step_times[0] == pytest.approx(0.010)
    assert [s for s, _, _ in loop.straggler_steps] == [3]


# ---------------------------------------------------------------------------
# Gradient compression, bit for bit against the reference
# ---------------------------------------------------------------------------
SHAPES = [(16,), (4, 8), (3, 5, 7), (2, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_compress_int8_matches_reference(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    g = rng.standard_normal(shape).astype(np.float32) * 3.0
    g.reshape(-1)[0] = 0.0
    jq, js = jax_compress_int8(jnp.asarray(g))
    q, s = compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    jd = jax_decompress_int8(jq, js, shape)
    d = decompress_int8(q, s, shape)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    zq, zs = compress_int8(torch.zeros(shape))
    assert not zq.any() and torch.all(zs == 1e-12)


def test_ef_compress_update_matches_reference_over_steps():
    rng = np.random.default_rng(0)
    err_j = err_t = None
    for _ in range(3):
        g = {"a": rng.standard_normal((6, 9)).astype(np.float32),
             "b": rng.standard_normal(11).astype(np.float32)}
        jd, err_j = jax_ef_compress_update(
            {k: jnp.asarray(v) for k, v in g.items()}, err_j)
        d, err_t = ef_compress_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, err_t)
        for k in g:
            assert np.array_equal(d[k].numpy(), np.asarray(jd[k])), k
            assert np.array_equal(err_t[k].numpy(), np.asarray(err_j[k])), k


# ---------------------------------------------------------------------------
# One step from a reference train state on the reference pipeline's batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_780m"])
def test_step_from_reference_state_matches_reference(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jstep = jax.jit(jax_make_train_step(jcfg, JEX, **LR))
    jpipe = JaxDataPipeline(jcfg, JSHAPE, seed=4)
    # one reference step first, so that m, v and the step are not zero
    jstate, _ = jstep(jax_init_train_state(jcfg, JEX, seed=0),
                      jpipe.batch_at(0))
    jbatch = jpipe.batch_at(1)
    jnew, jmet = jstep(jstate, jbatch)

    params, opt = train_state_from_jax(jstate, cfg)
    model = build_model(cfg).init(1, EX)
    model.load_state_dict(params)
    assert opt.step == 1
    state = TrainState(model=model, opt=opt)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    assert batch["tokens"].dtype == torch.int32
    new, met = make_train_step(cfg, EX, **LR)(state, batch)
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    want_p, want_opt = train_state_from_jax(jnew, cfg)
    assert new.opt.step == want_opt.step == 2
    got_p = dict(new.model.named_parameters())
    for name in want_p:
        for got, want in ((got_p[name].detach(), want_p[name]),
                          (new.opt.m[name], want_opt.m[name]),
                          (new.opt.v[name], want_opt.v[name])):
            assert _rel_l2(got.numpy(), want.numpy()) <= UPDATE_REL_L2, name
    jax.clear_caches()


# ---------------------------------------------------------------------------
# launch.train: checkpoints and --resume
# ---------------------------------------------------------------------------
def test_launch_train_resume_continues_the_unbroken_run(tmp_path, capsys):
    from repro_torch.launch.train import main
    common = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-every", "2"]
    straight = main(common + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")])
    first = main(common + ["--steps", "4", "--ckpt-dir",
                           str(tmp_path / "b")])
    resumed = main(common + ["--steps", "6", "--resume", "--ckpt-dir",
                             str(tmp_path / "b")])
    assert "resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in first] == [0, 1, 2, 3]
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in first + resumed] == \
        [h["loss"] for h in straight]
    assert CheckpointManager(tmp_path / "b").all_steps() == [2, 4, 6]
