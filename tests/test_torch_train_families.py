"""The port's train step for the moe, vlm, hybrid and encdec families
against the reference's, on the CPU.

Qwen3-MoE-235B-A22B and Mixtral-8x7B (moe), LLaVA-NeXT-34B (vlm, the loss
masked over the prefix), Zamba2-7B (hybrid) and Whisper-medium (encdec),
reduced, in float32.  The reference runs ``JaxExecConfig(backend="xla",
attn_block=16, ssd_chunk=8)`` (its xla path: the Pallas kernels' interpret
mode is not differentiated) and its unsharded
``repro.launch.steps.make_train_step``; the port runs
``ExecConfig(attn_block=16, ssd_chunk=8)`` on the CPU from the same
weights (``params_from_jax``) and the same numpy-seeded batch.

Tolerances, float32 on both sides with sums in other orders, as in
``tests/test_torch_train.py``: the loss within 1e-5 relative; each
gradient within 1e-4 relative L2; the parameters, m and v after one AdamW
update within 1e-5 relative L2; accum=2 at the reference's own rtol 2e-4
/ atol 2e-5.  MoE: the router's top-k ids must equal the reference's,
layer by layer, before any number is compared (a flipped choice moves
the loss by more than any tolerance, and is named as the cause); each
layer's aux loss within 1e-6 relative.
"""
import copy
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import init_train_state as jax_init_train_state
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models import ExecConfig, build_model
from repro_torch.models import common as port_common
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_transformer
from repro_torch.models.api import PORTED_FAMILIES
from repro_torch.optim import adamw_init

ARCHS = ["qwen3_moe_235b_a22b", "mixtral_8x7b", "llava_next_34b",
         "zamba2_7b", "whisper_medium"]
MOE_ARCHS = ["qwen3_moe_235b_a22b", "mixtral_8x7b"]
BATCH, SEQ = 4, 32
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-5
AUX_RTOL = 1e-6
LR = dict(base_lr=5e-3, warmup=5, total=120)
JEX = JaxExecConfig(backend="xla", attn_block=16, ssd_chunk=8)
EX = ExecConfig(ssd_chunk=8, attn_block=16, device="cpu")
# XLA:CPU's LLVM at its lowest optimisation level: the reference's
# compiles take half the time, and these small shapes run as fast
XLA_QUICK = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``XLA_QUICK``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_QUICK)(
        *args)


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
    """A train batch as numpy arrays: tokens and labels, a vlm's prefix
    embeddings and loss mask (0 over the prefix), an encdec's frames."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[:, :cfg.n_prefix_tokens] = 0.0
        batch["loss_mask"] = mask
    if cfg.family == "encdec":
        batch["encoder_embeds"] = rng.standard_normal(
            (BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _to_reference(port: dict, jtree, cfg):
    """The inverse of ``params_from_jax``: the port's tensors by name -> a
    tree of ``jtree``'s layout (arrays or shapes).  ``params_from_jax``
    moves every element of the tree once (transposes and layer slices),
    so mapping a tree of element indices through it says where each port
    element came from."""
    leaves, treedef = jax.tree.flatten(jtree)
    sizes = [math.prod(leaf.shape) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    where = params_from_jax(jax.tree.unflatten(treedef, [
        np.arange(o, o + n, dtype=np.float64).reshape(leaf.shape)
        for o, n, leaf in zip(starts, sizes, leaves)]), cfg)
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, idx in where.items():
        flat[idx.numpy().astype(np.int64).ravel()] = \
            port[name].detach().numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree.unflatten(treedef, [
        jnp.asarray(flat[o:o + n].reshape(leaf.shape))
        for o, n, leaf in zip(starts, sizes, leaves)])


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    """The reference's reduced config and its initial train state, of the
    port's seeded weights (the same scales as the reference's init, and no
    compile of it) in the reference's layout."""
    from repro.launch.steps import TrainState as JaxTrainState
    from repro.optim import adamw_init as jax_adamw_init
    jcfg = jax_get_config(arch).reduced()
    layout = jax.eval_shape(
        lambda: jax_init_train_state(jcfg, JEX, seed=0)).params
    model = build_model(get_config(arch).reduced()).init(0, EX)
    params = _to_reference(dict(model.named_parameters()), layout,
                           get_config(arch).reduced())
    return jcfg, JaxTrainState(params=params, opt=jax_adamw_init(params))


def _setup(arch, seed=0):
    """The reference's train state and a port model of the same weights,
    float32, plus the batch in both packages' arrays."""
    jcfg, jstate = _jax_state(arch)
    cfg = get_config(arch).reduced()
    model = build_model(cfg).init(1, EX)
    model.load_state_dict(params_from_jax(jstate.params, cfg))
    batch = _batch(cfg, seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jstate, model, jbatch, tbatch


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    """The reference's (loss, metrics) and gradients on ``_batch(cfg)``,
    and for MoE the top-k ids and aux loss of each layer in layer order
    (a callback from inside its layer scan)."""
    jcfg, jstate = _jax_state(arch)
    jbatch = {k: jnp.asarray(v)
              for k, v in _batch(get_config(arch).reduced()).items()}
    routes = []
    orig = jax_moe.router_topk

    def recording(logits, m):
        w, ids, aux = orig(logits, m)
        jax.debug.callback(
            lambda i, a: routes.append((np.asarray(i), float(a))), ids,
            aux, ordered=True)
        return w, ids, aux

    jfns = jax_build_model(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe, "router_topk", recording)
        out = _jit(jax.value_and_grad(
            lambda p, b: jfns.loss(p, b, JEX), has_aux=True),
            jstate.params, jbatch)
        jax.effects_barrier()
    return out, routes


def _port_routing(monkeypatch):
    """Patch the port's ``aux_loss`` to record (ids, aux) of each router
    call; -> the list it fills."""
    seen = []
    orig = port_moe.aux_loss

    def recording(probs, ids):
        aux = orig(probs, ids)
        seen.append((ids.numpy().copy(), aux.item()))
        return aux

    monkeypatch.setattr(port_moe, "aux_loss", recording)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, monkeypatch):
    jcfg, cfg, jstate, model, jbatch, tbatch = _setup(arch)
    moe = cfg.family == "moe"
    ((jloss, jm), jgrads), want_routes = _jax_loss_and_grads(arch)
    got_routes = _port_routing(monkeypatch)
    loss, metrics = build_model(cfg).loss(model, tbatch, EX)
    assert len(got_routes) == len(want_routes) == (cfg.n_layers if moe
                                                   else 0)
    if moe:
        for i, ((gi, ga), (wi, wa)) in enumerate(zip(got_routes,
                                                     want_routes)):
            np.testing.assert_array_equal(
                gi, wi, err_msg=f"layer {i}: the router picked other "
                "experts than the reference's (a routing flip)")
            np.testing.assert_allclose(ga, wa, rtol=AUX_RTOL,
                                       err_msg=f"layer {i}'s aux loss")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=LOSS_RTOL)
    aux = float(metrics["aux"].detach() if moe else metrics["aux"])
    np.testing.assert_allclose(aux, float(jm["aux"]), rtol=AUX_RTOL)
    assert (aux > 0) == moe
    want = params_from_jax(jgrads, cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    errs = {n: _rel_l2(got[n].grad.numpy(), want[n].numpy()) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_L2, (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(arch):
    """One train step from the same state: loss, grad norm and lr against
    the reference's step; the parameters, m and v against the reference's
    ``adamw_update`` applied to the port's own gradients (mapped by
    ``train_state_from_jax``); the parameters also against the
    reference's step where its gradient is far from zero.  Over every
    element the reference's step would hold its gradients too, which
    ``test_loss_and_every_gradient_match_reference`` holds at 1e-4: at
    the first step the update is about
    lr * sign(g), and an element whose gradient is within the sums'
    rounding of zero (Zamba2's embed: 5e-8 against the reference's 2e-8,
    where the median is 1.5e-4) takes the other sign; v is quadratic in
    g (Zamba2's conv_b: 1.03e-5 from a gradient 5e-6 apart)."""
    from repro.optim import adamw_update as jax_adamw_update
    from repro.optim import cosine_schedule as jax_cosine_schedule
    jcfg, cfg, jstate, model, jbatch, tbatch = _setup(arch)
    jnew, jmet = _jit(jax_make_train_step(jcfg, JEX, **LR), jstate, jbatch)
    state = TrainState(model=model,
                       opt=adamw_init(dict(model.named_parameters())))
    new, met = make_train_step(cfg, EX, **LR)(state, tbatch)
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=GRAD_REL_L2)
    np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
    got_p = dict(new.model.named_parameters())
    grads = _to_reference({n: p.grad for n, p in got_p.items()},
                          jstate.params, cfg)
    upd, opt, _ = _jit(lambda p, g, o: jax_adamw_update(
        p, g, o, jax_cosine_schedule(**LR)), jstate.params, grads,
        jstate.opt)
    want_p, want_opt = train_state_from_jax(jnew._replace(params=upd,
                                                          opt=opt), cfg)
    assert new.opt.step == want_opt.step == int(jnew.opt.step) == 1
    assert set(got_p) == set(want_p) == set(want_opt.m) == set(want_opt.v)
    for name in want_p:
        for what, got, want in (
                ("param", got_p[name].detach(), want_p[name]),
                ("m", new.opt.m[name], want_opt.m[name]),
                ("v", new.opt.v[name], want_opt.v[name])):
            err = _rel_l2(got.numpy(), want.numpy())
            assert err <= UPDATE_REL_L2, (what, name, err)
    # and against the reference's own step, over the elements whose
    # reference gradient is 100x the gradient check's rms error: no
    # rounding of the sums flips their sign
    ((_, _), jgrads), _ = _jax_loss_and_grads(arch)
    ref_g = params_from_jax(jgrads, cfg)
    ref_p = params_from_jax(jnew.params, cfg)
    for name, want in ref_p.items():
        g = ref_g[name].numpy()
        keep = np.abs(g) > 100 * GRAD_REL_L2 * np.sqrt(np.mean(g * g))
        assert keep.any(), name
        err = _rel_l2(got_p[name].detach().numpy()[keep],
                      want.numpy()[keep])
        assert err <= UPDATE_REL_L2, ("param vs the reference's step", name,
                                      err)


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulation(arch):
    """accum=2 over batch 4.  Without experts: one step over the same 4
    sequences (the reference's test_grad_accumulation_matches_large_batch).
    With experts the two differ by design (each microbatch routes with its
    own capacity and its own load-balance loss), so accum=2 is held against
    the reference's accum=2 step instead."""
    jcfg, cfg, jstate, model, jbatch, tbatch = _setup(arch, seed=5)
    if cfg.family == "moe":
        jnew, jmet = _jit(jax_make_train_step(
            jcfg, JEX, base_lr=1e-4, accum=2), jstate, jbatch)
        state = TrainState(model=model,
                           opt=adamw_init(dict(model.named_parameters())))
        new, met = make_train_step(cfg, EX, base_lr=1e-4, accum=2)(
            state, tbatch)
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        want = params_from_jax(jnew.params, cfg)
        for name, p in new.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)
        return
    out = []
    for accum in (1, 2):
        state = init_train_state(cfg, EX, seed=0)
        new, met = make_train_step(cfg, EX, base_lr=1e-4, accum=accum)(
            state, tbatch)
        out.append((dict(new.model.named_parameters()), met))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=2e-4)
    assert m2["aux"] == 0.0
    for name, p in p1.items():
        np.testing.assert_allclose(p2[name].detach().numpy(),
                                   p.detach().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_gives_every_float32_leaf_a_gradient(arch):
    """Through ``_call_cast``'s bf16 copies the gradients land on the
    float32 parameters, every one of them; the step keeps them float32."""
    cfg = get_config(arch).reduced()
    ex = dataclasses.replace(EX, compute_dtype=torch.bfloat16)
    state = init_train_state(cfg, ex, seed=0)
    batch = build_model(cfg).make_batch(0, ShapeConfig(
        "t", "train", SEQ, BATCH), ex, kind="train")
    new, met = make_train_step(cfg, ex, **LR)(state, batch)
    for name, p in new.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert np.isfinite(met["loss"].item())


def _biased_moe_layer(arch):
    """A reduced MoE layer of ``arch`` whose router prefers expert 0 for
    every token (as ``tests/test_torch_moe.py``'s biased_drops case), so
    the capacity drops choices; -> (config, numpy params, x)."""
    m = get_config(arch).reduced().moe
    d, b, s = 64, 2, 24
    params = jax_moe.moe_init(jax.random.PRNGKey(5), d, m, jnp.float32)
    np_params = {k: np.array(v) for k, v in params.items()}
    np_params["router"][:, 0] = 0.5
    x = np.random.default_rng(11).standard_normal((b, s, d)).astype(
        np.float32) + 1.0
    return m, np_params, x


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_gradient_with_dropped_choices(arch):
    """The gradient of <y, g> + aux in x and every parameter, against
    jax.grad of the reference's ``moe_apply``, where the capacity drops
    choices: every dropped choice writes the one row past the buckets, and
    that row's slice-off must give it no gradient."""
    m, np_params, x = _biased_moe_layer(arch)
    d = x.shape[-1]
    g = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    jex = JaxExecConfig(backend="xla")

    def jloss(p, v):
        y, aux = jax_moe.moe_apply(p, v, m, jex)
        return jnp.sum(y * g) + aux, aux

    (jval, jaux), (jgp, jgx) = _jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))

    layer = port_moe.MoE(d, m, device="cpu", dtype=torch.float32)
    layer.load_state_dict({
        "router.weight": torch.from_numpy(np_params["router"].T.copy()),
        **{n: torch.from_numpy(np_params[n]) for n in ("w1", "w2", "w3")}})
    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        *_, keep, cap, _ = port_moe.route(xt.reshape(-1, d), layer, m)
    assert bool((~keep).any()), f"no choice dropped at capacity {cap}"
    y, aux = port_moe.moe_apply(layer, xt, m, with_aux=True)
    val = (y * torch.from_numpy(g)).sum() + aux
    val.backward()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_RTOL)
    np.testing.assert_allclose(val.item(), float(jval), rtol=LOSS_RTOL)
    assert _rel_l2(xt.grad.numpy(), jgx) <= GRAD_REL_L2
    got = {"router": layer.router.weight.grad.T, "w1": layer.w1.grad,
           "w2": layer.w2.grad, "w3": layer.w3.grad}
    for name, grad in got.items():
        assert _rel_l2(grad.numpy(), jgp[name]) <= GRAD_REL_L2, name


def test_moe_aux_gradient_flows_through_the_probabilities_only():
    """The aux loss alone: its gradient in the router logits is autograd
    through E * sum(mean(probs) * fraction routed), the fraction a
    constant (the one-hot of the first choice)."""
    m = get_config("mixtral_8x7b").reduced().moe
    logits = torch.randn(40, m.n_experts, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(3))
    logits.requires_grad_()
    _, ids, probs = port_moe.router_topk(logits, m)
    aux = port_moe.aux_loss(probs, ids)
    (grad,) = torch.autograd.grad(aux, logits)
    frac = torch.nn.functional.one_hot(ids[:, 0], m.n_experts).double() \
        .mean(0)
    lg = logits.detach().requires_grad_()
    want = m.n_experts * (torch.softmax(lg, -1).mean(0) * frac).sum()
    (want_grad,) = torch.autograd.grad(want, lg)
    torch.testing.assert_close(aux.detach(), want.detach())
    torch.testing.assert_close(grad, want_grad)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_computes_no_aux_loss(arch, monkeypatch):
    """Prefill and decode never build the router's aux loss; the train
    forward does, once a layer."""
    cfg = get_config(arch).reduced()
    fns = build_model(cfg)
    model = fns.init(0, EX)
    calls = []
    orig = port_moe.aux_loss
    monkeypatch.setattr(port_moe, "aux_loss",
                        lambda *a: calls.append(1) or orig(*a))
    batch = fns.make_batch(0, ShapeConfig("t", "prefill", 16, 2), EX)
    cache = port_transformer.init_cache(cfg, 2, 17, EX.compute_dtype, "cpu")
    logits, cache = model.prefill(batch["tokens"], EX, cache)
    model.decode_step(cache, logits.argmax(-1), 16, EX)
    assert calls == []
    fns.loss(model, fns.make_batch(0, ShapeConfig("t", "train", 16, 2), EX,
                                   kind="train"), EX)
    assert len(calls) == cfg.n_layers


def test_vlm_loss_mask_matches_reference():
    """make_batch(kind="train") adds the reference's loss mask: float32,
    0 over the prefix positions, 1 elsewhere; it draws nothing, so the
    tokens and prefix embeddings are the prefill batch's."""
    cfg = get_config("llava_next_34b").reduced()
    jcfg = jax_get_config("llava_next_34b").reduced()
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    fns = build_model(cfg)
    train = fns.make_batch(3, shape, EX, kind="train")
    prefill = fns.make_batch(3, shape, EX)
    want = jax_build_model(jcfg).make_batch(jax.random.PRNGKey(3), shape,
                                            JEX, kind="train")["loss_mask"]
    assert set(train) == {"tokens", "labels", "prefix_embeds", "loss_mask"}
    assert train["loss_mask"].dtype == torch.float32
    np.testing.assert_array_equal(train["loss_mask"].numpy(),
                                  np.asarray(want))
    assert train["loss_mask"][:, :cfg.n_prefix_tokens].sum() == 0
    assert "loss_mask" not in prefill
    for k in ("tokens", "prefix_embeds"):
        assert torch.equal(train[k], prefill[k]), k


def test_vlm_loss_ignores_the_prefix_labels():
    """Labels at masked positions move neither the loss nor a gradient."""
    cfg = get_config("llava_next_34b").reduced()
    model = build_model(cfg).init(0, EX)
    batch = build_model(cfg).make_batch(4, ShapeConfig(
        "t", "train", SEQ, BATCH), EX, kind="train")
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :cfg.n_prefix_tokens] = 0
    losses = [build_model(cfg).loss(model, b, EX)[0].item()
              for b in (batch, other)]
    assert losses[0] == losses[1]


def test_hybrid_shared_block_gradient_sums_its_applications():
    """Zamba2 reduced (4 layers, period 2): the shared block's gradient
    equals the sum of the gradients of one copy of it per application
    (the forward run again with the copies swapped in), and every
    application adds to it."""
    cfg = get_config("zamba2_7b").reduced()
    fns = build_model(cfg)
    model = fns.init(0, EX)
    batch = fns.make_batch(2, ShapeConfig("t", "train", SEQ, BATCH), EX,
                           kind="train")
    loss, _ = fns.loss(model, batch, EX)
    loss.backward()
    shared = model.shared
    n_apps = cfg.n_layers // cfg.hybrid_period
    assert n_apps == 2
    copies = [copy.deepcopy(shared) for _ in range(n_apps)]
    for c in copies:
        c.zero_grad(set_to_none=True)
    try:
        model.shared = copies[0]
        x = model.embed[batch["tokens"]].to(EX.compute_dtype)
        for app, x, _ in model._layers(x, EX):
            if app is not None and app + 1 < n_apps:
                model.shared = copies[app + 1]   # the next application's
        x = port_common.norm(x, model.final_norm, cfg.norm_eps)
        again = port_common.cross_entropy(x @ model.embed.T,
                                          batch["labels"])
        again.backward()
    finally:
        model.shared = shared
    assert again.item() == loss.item()
    for name, p in shared.named_parameters():
        parts = [dict(c.named_parameters())[name].grad for c in copies]
        assert all(g is not None and g.abs().sum() > 0 for g in parts), name
        assert _rel_l2(p.grad.numpy(), sum(parts).numpy()) <= 1e-6, name


@pytest.mark.parametrize("family", PORTED_FAMILIES)
def test_every_ported_family_has_a_loss(family):
    arch = {"dense": "tinyllama_1_1b", "moe": "mixtral_8x7b",
            "hybrid": "zamba2_7b", "ssm": "mamba2_780m",
            "vlm": "llava_next_34b", "encdec": "whisper_medium"}[family]
    cfg = get_config(arch).reduced()
    assert cfg.family == family
    fns = build_model(cfg)
    model = fns.init(0, EX)
    batch = fns.make_batch(0, ShapeConfig("t", "train", 16, 2), EX,
                           kind="train")
    loss, metrics = fns.loss(model, batch, EX)
    assert loss.dim() == 0 and np.isfinite(loss.item())
    assert set(metrics) == {"ce", "aux"}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llava-next-34b",
                                  "zamba2-7b", "whisper-medium"])
def test_train_main_on_cpu_trains_each_new_family(arch):
    from repro_torch.launch.train import main
    hist = main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
