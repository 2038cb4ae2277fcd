"""The port's activation checkpointing (``ExecConfig.remat``,
``models/common.py::ExecConfig.wrap_remat``) on the CPU, for the seven
reduced configs of the six families: TinyLlama (dense), Mixtral (moe,
the dense dispatch), Qwen3-MoE (moe), LLaVA (vlm, the loss masked over
the prefix), Mamba2 (ssm), Zamba2 (hybrid) and Whisper (encdec).

* Under "full" and "dots" the train step's loss and every gradient are
  the "none" step's bit for bit in float32 (the recompute repeats the
  same ops on the same inputs), and the layer bodies really ran again
  (more ``ops.rmsnorm`` calls).
* Under "full" the port matches the reference's
  ``JaxExecConfig(remat="full")`` value and grad from the same weights
  (``params_from_jax``) at ``tests/test_torch_train_families.py``'s
  tolerances: the loss within 1e-5 relative, each gradient within 1e-4
  relative L2 (float32 on both sides, sums in other orders).
* An unknown policy raises ``ValueError``, as the reference's does.
* ``launch/train.py``: ``train_exec_config`` takes the policy and
  ``build_sharded_train``'s step runs under it.
* Prefill and three decode steps under "full" are those of "none" bit for
  bit, with the same kernel-op calls: remat applies only while grad is
  enabled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.steps import (make_grad_step, make_prefill_step,
                                      make_serve_step)
from repro_torch.models import ExecConfig, build_model
from test_torch_train_families import (GRAD_REL_L2, JEX, LOSS_RTOL,
                                       _batch, _jax_state, _jit, _rel_l2)

ARCHS = ["tinyllama_1_1b", "mixtral_8x7b", "qwen3_moe_235b_a22b",
         "llava_next_34b", "mamba2_780m", "zamba2_7b", "whisper_medium"]


def _ex(remat):
    return ExecConfig(ssd_chunk=8, attn_block=16, device="cpu", remat=remat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread for PyTorch's CPU ops: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def norm_calls(monkeypatch):
    """Count the ``ops.rmsnorm`` calls (every family's norms)."""
    calls = []
    orig = ops.rmsnorm

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(ops, "rmsnorm", counted)
    return calls


def _grad_step(arch, remat, norm_calls):
    """One ``make_grad_step`` from the seeded weights -> (loss, {name:
    gradient}, the rmsnorm calls it made)."""
    cfg = get_config(arch).reduced()
    ex = _ex(remat)
    model = build_model(cfg).init(0, ex)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    del norm_calls[:]
    loss, _ = make_grad_step(cfg, ex)(model, batch)
    return loss, {n: p.grad for n, p in model.named_parameters()}, \
        len(norm_calls)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit_the_plain_step(arch, remat, norm_calls):
    loss, grads, calls = _grad_step(arch, "none", norm_calls)
    r_loss, r_grads, r_calls = _grad_step(arch, remat, norm_calls)
    assert r_calls > calls, "no layer body ran again in the backward"
    assert torch.equal(r_loss, loss)
    assert set(r_grads) == set(grads)
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_remat_matches_the_reference_s(arch):
    jcfg, jstate = _jax_state(arch)
    cfg = get_config(arch).reduced()
    batch = _batch(cfg)
    jex = JaxExecConfig(backend=JEX.backend, attn_block=JEX.attn_block,
                        ssd_chunk=JEX.ssd_chunk, remat="full")
    jfns = jax_build_model(jcfg)
    (jloss, _), jgrads = _jit(jax.value_and_grad(
        lambda p, b: jfns.loss(p, b, jex), has_aux=True), jstate.params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    ex = _ex("full")
    model = build_model(cfg).init(1, ex)
    model.load_state_dict(params_from_jax(jstate.params, cfg))
    loss, _ = make_grad_step(cfg, ex)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jgrads, cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    errs = {n: _rel_l2(got[n].grad.numpy(), want[n].numpy()) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


def test_an_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        ExecConfig(remat="everything")
    with pytest.raises(ValueError):
        JaxExecConfig(remat="everything").wrap_remat(lambda x: x)
    assert ExecConfig().remat == "none"


@pytest.mark.parametrize("remat", ["none", "full"])
def test_the_sharded_trainer_carries_remat(remat, norm_calls):
    """``train_exec_config`` takes the policy and ``build_sharded_train``
    runs its step under it: one step on a one-rank (1, 1) mesh (a fake
    group: no collective crosses it) recomputes each layer's norms under
    "full", and gives the unsharded step's loss bit for bit."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.train import build_sharded_train, train_exec_config
    cfg = get_config("tinyllama_1_1b").reduced()
    assert train_exec_config(cfg, torch.device("cpu")).remat == "none"
    ex = train_exec_config(cfg, torch.device("cpu"), remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    _, metrics = make_train_step(cfg, ex)(init_train_state(cfg, ex, 0),
                                          batch)
    plain = len(norm_calls)
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        step, place = build_sharded_train(
            cfg, ex, mesh, ShapeConfig("t", "train", *_batch(cfg)[
                "tokens"].shape[::-1]))
        state = place(init_train_state(cfg, ex, 0))
        del norm_calls[:]
        _, sharded = step(state, batch)
    # ln1 and ln2 a layer, the final norm; under "full" each layer's again
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if remat == "full"
                                    else 0)
    assert len(norm_calls) == plain == norms
    assert torch.equal(sharded["loss"], metrics["loss"])


def _serve(arch, remat, norm_calls):
    """Prefill of 16 tokens (a vlm's 8 prefix embeddings among them, an
    encdec's frames beside) into a cache of 19, then 3 greedy decode
    steps -> (every logits, the cache, the rmsnorm calls)."""
    cfg = get_config(arch).reduced()
    ex = _ex(remat)
    fns = build_model(cfg)
    model = fns.init(0, ex)
    batch = fns.make_batch(1, ShapeConfig("s", "prefill", 16, 2), ex)
    cache = fns.init_cache(2, 19, ex)
    del norm_calls[:]
    logits, cache = make_prefill_step(cfg, ex)(model, batch, cache)
    out = [logits]
    decode = make_serve_step(cfg, ex)
    for pos in range(16, 19):
        logits, cache = decode(model, cache, torch.argmax(logits, -1), pos)
        out.append(logits)
    return out, cache, len(norm_calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_is_unchanged_under_remat(arch, norm_calls):
    logits, cache, calls = _serve(arch, "none", norm_calls)
    r_logits, r_cache, r_calls = _serve(arch, "full", norm_calls)
    assert r_calls == calls
    assert all(torch.equal(a, b) for a, b in zip(r_logits, logits))
    assert set(r_cache) == set(cache)
    assert all(torch.equal(r_cache[k], cache[k]) for k in cache)
