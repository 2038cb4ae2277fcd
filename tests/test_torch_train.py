"""The port's train step against the reference's, on the CPU.

TinyLlama-1.1B (dense) and Mamba2-780M (ssm), reduced, in float32 with
``ExecConfig(ssd_chunk=8, attn_block=16)`` as ``tests/test_substrate.py``.
The reference's unsharded ``repro.launch.steps.make_train_step`` (the
sharded one fails, ROADMAP C3) and the port's ``make_train_step`` start
from the same weights (``params_from_jax``) and take the same
numpy-seeded batch.  Tolerances, float32 on both sides with sums in other
orders: the loss within 1e-5 relative; each gradient within 1e-4 relative
L2; the parameters, m and v after one AdamW update within 1e-5 relative
L2 (m and v are linear and quadratic in the clipped gradient, whose
error read ~1e-6; the update moves each parameter by about lr); accum=2
against accum=1 at the reference's own rtol 2e-4 / atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import init_train_state as jax_init_train_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models import ExecConfig, build_model
from repro_torch.optim import adamw_init

ARCHS = ["tinyllama_1_1b", "mamba2_780m"]
BATCH, SEQ = 4, 32
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-5
LR = dict(base_lr=5e-3, warmup=5, total=120)


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


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def _setup(arch):
    """The reference's train state and a port model of the same weights,
    float32, plus the batch in both packages' arrays."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jex = JaxExecConfig(ssd_chunk=8, attn_block=16)
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
    jstate = jax_init_train_state(jcfg, jex, seed=0)
    model = build_model(cfg).init(1, ex)
    model.load_state_dict(params_from_jax(jstate.params, cfg))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jex, ex, jstate, model, jbatch, tbatch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg, jex, ex, jstate, model, jbatch, tbatch = _setup(arch)
    jfns = jax_build_model(jcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jfns.loss(p, jbatch, jex), has_aux=True)(jstate.params)
    loss, metrics = build_model(cfg).loss(model, tbatch, ex)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=LOSS_RTOL)
    want = params_from_jax(jgrads, cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    errs = {n: _rel_l2(got[n].grad.numpy(), want[n].numpy()) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(arch):
    """One train step from the same state: loss, grad norm and lr, then
    the parameters, m and v (mapped by ``train_state_from_jax``)."""
    jcfg, cfg, jex, ex, jstate, model, jbatch, tbatch = _setup(arch)
    jnew, jmet = jax_make_train_step(jcfg, jex, **LR)(jstate, jbatch)
    state = TrainState(model=model,
                       opt=adamw_init(dict(model.named_parameters())))
    new, met = make_train_step(cfg, ex, **LR)(state, tbatch)
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=GRAD_REL_L2)
    np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
    want_p, want_opt = train_state_from_jax(jnew, cfg)
    assert new.opt.step == want_opt.step == 1
    got_p = dict(new.model.named_parameters())
    for name in want_p:
        for got, want in ((got_p[name].detach(), want_p[name]),
                          (new.opt.m[name], want_opt.m[name]),
                          (new.opt.v[name], want_opt.v[name])):
            err = _rel_l2(got.numpy(), want.numpy())
            assert err <= UPDATE_REL_L2, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulation_matches_one_batch(arch):
    """accum=2 over batch 4 == one step over the same 4 sequences (the
    reference's test_grad_accumulation_matches_large_batch)."""
    cfg = get_config(arch).reduced()
    ex = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
    out = []
    for accum in (1, 2):
        state = init_train_state(cfg, ex, seed=0)
        new, met = make_train_step(cfg, ex, base_lr=1e-4, accum=accum)(
            state, tbatch)
        out.append((dict(new.model.named_parameters()), met))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=2e-4)
    assert m2["aux"] == 0.0
    for name, p in p1.items():
        np.testing.assert_allclose(p2[name].detach().numpy(),
                                   p.detach().numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_gives_every_float32_leaf_a_gradient(arch):
    """Through ``_call_cast``'s bf16 copies the gradients land on the
    float32 parameters, every one of them; the step keeps them float32."""
    cfg = get_config(arch).reduced()
    ex = ExecConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                    ssd_chunk=8, attn_block=16, device="cpu")
    state = init_train_state(cfg, ex, seed=0)
    batch = build_model(cfg).make_batch(0, ShapeConfig(
        "t", "train", SEQ, BATCH), ex, kind="train")
    new, met = make_train_step(cfg, ex, **LR)(state, batch)
    for name, p in new.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert np.isfinite(met["loss"].item())


def test_train_batch_adds_labels_and_keeps_the_prompt():
    cfg = get_config("tinyllama_1_1b").reduced()
    ex = ExecConfig(device="cpu")
    fns = build_model(cfg)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    train = fns.make_batch(3, shape, ex, kind="train")
    prefill = fns.make_batch(3, shape, ex)
    assert set(train) == {"tokens", "labels"} and set(prefill) == {"tokens"}
    assert torch.equal(train["tokens"], prefill["tokens"])
    assert train["labels"].shape == (BATCH, SEQ)
    with pytest.raises(ValueError, match="kind"):
        fns.make_batch(3, shape, ex, kind="eval")


def test_train_main_without_gpu_raises(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1"])


def test_train_main_on_cpu_when_asked():
    from repro_torch.launch.train import main
    hist = main(["--reduced", "--device", "cpu", "--steps", "3", "--batch",
                 "2", "--seq", "16", "--accum", "2"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)


def test_clip_and_schedule_match_reference():
    from repro.optim import clip_by_global_norm as jclip
    from repro.optim import cosine_schedule as jcos
    from repro_torch.optim import clip_by_global_norm, cosine_schedule
    rng = np.random.default_rng(7)
    grads = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
    jg, jn = jclip({k: jnp.asarray(v, jnp.float32)
                    for k, v in grads.items()}, 1.0)
    tg, tn = clip_by_global_norm({k: torch.tensor(v, dtype=torch.float32)
                                  for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6)
    j, t = jcos(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(t(step), float(j(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def test_adamw_in_place_matches_the_functional_update():
    """``adamw_update_`` (the train step's, in place) gives the functional
    ``adamw_update``'s parameters, m, v, lr and norm bit for bit over
    three steps, clipped or not, float32 and bf16 parameters; the
    functional form leaves its inputs as they were."""
    from repro_torch.optim import (adamw_update, adamw_update_,
                                   cosine_schedule)
    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": torch.randn(37, 53, generator=gen) * 0.1
              for i in range(3)}
    params["b"] = torch.randn(64, generator=gen).to(torch.bfloat16)
    for size in (0.01, 0.5):    # under, over the clipping norm
        grads = {n: (torch.randn(p.shape, generator=gen) * size).to(p.dtype)
                 for n, p in params.items()}
        sched = cosine_schedule(5e-3, 2, 10)
        fp, fs = dict(params), adamw_init(params)
        ip, ist = ({n: p.clone() for n, p in params.items()},
                   adamw_init(params))
        for _ in range(3):
            fp, fs, finfo = adamw_update(fp, grads, fs, sched)
            ist, iinfo = adamw_update_(ip, grads, ist, sched)
            assert finfo["lr"] == iinfo["lr"] and fs.step == ist.step
            assert torch.equal(finfo["grad_norm"], iinfo["grad_norm"])
            for n in params:
                assert torch.equal(fp[n], ip[n]), n
                assert torch.equal(fs.m[n], ist.m[n]), n
                assert torch.equal(fs.v[n], ist.v[n]), n
        kept = {n: p.clone() for n, p in params.items()}
        state = adamw_init(params)
        adamw_update(params, grads, state, sched)
        assert all(torch.equal(kept[n], params[n]) for n in params)
        assert all(not state.m[n].any() and not state.v[n].any()
                   for n in params)
