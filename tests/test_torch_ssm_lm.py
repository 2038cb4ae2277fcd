"""The port's Mamba2 LM (the ``ssm`` family) and the SSD's final state
against the JAX package, on the CPU.

The same numpy weights (the reference's own init, converted by
``params_from_jax``) and the same prompt go through ``repro``'s
``ssm_lm_prefill`` / ``ssm_lm_decode_step`` (xla path, float32, jitted)
and through ``repro_torch``'s ``SSMLM`` (plain PyTorch path, float32):
prefill logits, every layer's conv window and final SSD state, then
decode.  The port's ``ops.ssd`` final state on the CPU is held against
the reference's ``ssd_chunked_ref``.  Tolerance 1e-4 (rtol and atol):
both compute in float32, but sums run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build_model
from repro.models import ssm_lm as jax_ssm_lm
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.models import ExecConfig, build_model

TOL = 1e-4
N_DECODE = 8
CHUNK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_3_layer(get_config):
    """Three layers, two B/C groups, d_model 32 (8 heads of 8)."""
    cfg = get_config("mamba2_780m").reduced()
    return dataclasses.replace(
        cfg, name="mamba2-3l-narrow", n_layers=3, d_model=32,
        ssm=dataclasses.replace(cfg.ssm, n_groups=2))


# each case builds its config from either package's config module
CASES = {
    "mamba2-reduced": lambda get: get("mamba2_780m").reduced(),
    "mamba2-3l-narrow": _narrow_3_layer,
}


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL,
                               err_msg=msg)


def _port_model(case, seed=5):
    """(cfg, reference params, the port's fns, its model, its ExecConfig),
    the port's model holding the reference's init."""
    cfg = CASES[case](get_config)
    pcfg = CASES[case](torch_get_config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jex = JaxExecConfig(backend="xla", ssd_chunk=CHUNK)
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(seed))
    ex = ExecConfig(device="cpu", ssd_chunk=CHUNK)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), pcfg), strict=True)
    return cfg, jex, params, fns, model, ex


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssm_lm_prefill_decode_match_jax(case):
    cfg, jex, params, fns, model, ex = _port_model(case)
    j_prefill = jax.jit(
        lambda p, t: jax_ssm_lm.ssm_lm_prefill(p, t, cfg, jex))
    j_decode = jax.jit(lambda p, c, t, pos: jax_ssm_lm.ssm_lm_decode_step(
        p, c, t, pos, cfg, jex))

    b, s = 2, 3 * CHUNK
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    j_logits, j_cache = j_prefill(params, jnp.asarray(tokens))
    t_cache = fns.init_cache(b, s + N_DECODE, ex)
    t_logits, t_cache = fns.prefill(
        model, {"tokens": torch.from_numpy(tokens).long()}, ex, t_cache)
    _close(t_logits, j_logits, "prefill logits")
    for name in ("conv", "ssm"):
        assert t_cache[name].shape == j_cache["ssm"][name].shape, name
        _close(t_cache[name], j_cache["ssm"][name], f"prefill {name}")
    # the final states are nonzero: prefill hands decode a real state
    assert float(t_cache["ssm"].abs().max()) > 1e-3

    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    for i in range(N_DECODE):
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok)), i
        j_logits, j_cache = j_decode(params, j_cache, j_tok, jnp.int32(s + i))
        t_logits, t_cache = fns.decode_step(model, t_cache, t_tok, s + i, ex)
        _close(t_logits, j_logits, f"step {i}")
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_logits, -1)
    for name in ("conv", "ssm"):
        _close(t_cache[name], j_cache["ssm"][name], f"decoded {name}")


def test_prefill_then_decode_equals_longer_prefill():
    """What the state means: a prefill of S tokens, then ``chunk`` decode
    steps fed the next tokens, leaves the logits and the state that a
    prefill of all S + ``chunk`` tokens gives (the state after the last
    chunk is the whole history)."""
    cfg = torch_get_config("mamba2_780m").reduced()
    ex = ExecConfig(device="cpu", ssd_chunk=CHUNK)
    fns = build_model(cfg)
    model = fns.init(3, ex)
    b, s = 2, 2 * CHUNK
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (b, s + CHUNK))).long()
    full_logits, full = fns.prefill(model, {"tokens": tokens}, ex)
    _, cache = fns.prefill(model, {"tokens": tokens[:, :s]}, ex)
    for i in range(CHUNK):
        logits, cache = fns.decode_step(model, cache, tokens[:, s + i],
                                        s + i, ex)
    for got, want, msg in ((logits, full_logits, "logits"),
                           (cache["conv"], full["conv"], "conv"),
                           (cache["ssm"], full["ssm"], "ssm")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=msg)


STATE_CASES = {
    # bb, s, h, p, g, n, chunk
    "one_chunk": (2, 16, 4, 8, 1, 16, 16),
    "several_chunks": (2, 64, 4, 8, 1, 16, 16),
    "groups2": (1, 48, 4, 16, 2, 8, 16),
    "chunk12": (1, 36, 2, 8, 1, 16, 12),   # not a power of two
}


def _ssd_inputs(bb, s, h, p, g, n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bb, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((bb, s, h))))   # softplus
    a = -np.exp(rng.standard_normal(h) * 0.5)
    b = rng.standard_normal((bb, s, g, n)) * 0.3
    c = rng.standard_normal((bb, s, g, n)) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, b, c)]


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_ssd_final_state_matches_reference(case):
    """``ops.ssd(..., return_state=True)`` on CPU tensors (the plain
    version) gives the reference's ``ssd_chunked_ref`` y and final state,
    and the state of the port's per-step recurrence; no kernel launches,
    and the default return stays y alone."""
    bb, s, h, p, g, n, chunk = STATE_CASES[case]
    args = _ssd_inputs(bb, s, h, p, g, n)
    targs = [torch.from_numpy(a) for a in args]
    before = port_ssd.launches
    y, state = ops.ssd(*targs, chunk=chunk, return_state=True)
    assert port_ssd.launches == before
    assert state.shape == (bb, h, p, n) and state.dtype == torch.float32
    assert torch.equal(ops.ssd(*targs, chunk=chunk), y)
    y_j, state_j = jax_ref.ssd_chunked_ref(*(jnp.asarray(a) for a in args),
                                           chunk=chunk)
    _close(y, y_j, "y")
    _close(state, state_j, "state")
    _, state_r = port_ref.ssd_ref(*targs)
    np.testing.assert_allclose(state.numpy(), state_r.numpy(), rtol=TOL,
                               atol=TOL, err_msg="recurrence")


def test_generate_runs_mamba2_reduced_on_cpu():
    """The ssm family through the serving entry point: greedy tokens in
    range, finite logits, and the same tokens from the same seed."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config("mamba2_780m").reduced()
    ex = ExecConfig(device="cpu", ssd_chunk=cfg.ssm.chunk)
    g1 = generate(cfg, ex, prompt_len=24, gen_len=6, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=24, gen_len=6, batch=2, seed=1)
    assert g1.tokens.shape == (2, 6)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)
    assert torch.equal(g1.prefill_logits, g2.prefill_logits)
