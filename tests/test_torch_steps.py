"""The port's step builders against the reference's, on the CPU, with
parameters kept in float32 and the steps computing in bfloat16.

The reference casts its parameters to ``compute_dtype`` inside every
call and leaves the caller's in ``param_dtype``
(``repro/launch/steps.py``); the port's steps do the same with a module
(ROADMAP C10).  The same numpy weights (converted by ``params_from_jax``)
and the same prompt go through both packages' ``make_prefill_step`` and
``make_serve_step``.  Tolerance: 0.03 of the largest logit, atol: both
packages round activations to bfloat16 at every layer, in their own
order, so the logits differ by a few bf16 ulps of their scale (the
largest difference read 0.018 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import build_model as jax_build_model
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import ExecConfig, build_model

LOGIT_TOL = 0.03      # x the largest |logit| of the reference
N_DECODE = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtypes(model):
    return {p.dtype for p in model.parameters()}


def test_bf16_steps_keep_fp32_params_and_match_reference():
    cfg = get_config("tinyllama_1_1b").reduced()
    pcfg = torch_get_config("tinyllama_1_1b").reduced()
    jex = JaxExecConfig(param_dtype=jnp.float32, compute_dtype=jnp.bfloat16,
                        backend="xla", attn_block=16)
    # jitted as the reference's serving driver runs them
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(3))
    ex = ExecConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                    device="cpu", attn_block=16)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), pcfg))
    assert _dtypes(model) == {torch.float32}

    b, s = 2, 16
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    j_logits, j_cache = jax.jit(jax_prefill_step(cfg, jex))(
        params, {"tokens": jnp.asarray(tokens)})
    cache = fns.init_cache(b, s + N_DECODE, ex)
    t_logits, cache = make_prefill_step(pcfg, ex)(
        model, {"tokens": torch.from_numpy(tokens).long()}, cache)
    assert _dtypes(model) == {torch.float32}, "prefill cast the caller's model"
    scale = float(np.abs(np.asarray(j_logits, np.float32)).max())
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32),
                               rtol=0, atol=LOGIT_TOL * scale)

    # the reference's decode cache with room for N_DECODE more positions
    full = jax_build_model(cfg).init_cache(b, s + N_DECODE, jex)
    j_cache = {n: full[n].at[:, :, :, :s].set(j_cache[n]) for n in full}
    j_step = jax.jit(jax_serve_step(cfg, jex))
    t_step = make_serve_step(pcfg, ex)
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.from_numpy(np.array(j_tok)).long()
    for i in range(N_DECODE):
        j_logits, j_cache = j_step(params, j_cache, j_tok, jnp.int32(s + i))
        t_logits, cache = t_step(model, cache, t_tok, s + i)
        np.testing.assert_allclose(t_logits.float().numpy(),
                                   np.asarray(j_logits, np.float32),
                                   rtol=0, atol=LOGIT_TOL * scale,
                                   err_msg=f"decode step {i}")
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        t_tok = torch.from_numpy(np.array(j_tok)).long()
    assert _dtypes(model) == {torch.float32}, "decode cast the caller's model"


def test_steps_use_the_model_itself_when_dtypes_agree():
    """No cast where the parameters already have the compute dtype (the
    served paths set both dtypes equal); otherwise the call sees them in
    the compute dtype and the caller's module keeps its own."""
    from repro_torch.launch.steps import _call_cast
    cfg = torch_get_config("tinyllama_1_1b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    model = build_model(cfg).init(0, ex)
    params = {n: p for n, p in model.named_parameters()}

    def seen(m, tag):
        return tag, m, {n: p for n, p in m.named_parameters()}, _dtypes(m)

    tag, m, inside, dtypes = _call_cast(seen, model, ex, "a")
    assert tag == "a" and m is model and dtypes == {torch.float32}
    assert all(inside[n] is p for n, p in params.items())
    ex16 = ExecConfig(param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device="cpu")
    tag, m, inside, dtypes = _call_cast(seen, model, ex16, "b")
    assert tag == "b" and m is model and dtypes == {torch.bfloat16}
    assert all(torch.equal(inside[n], p.to(torch.bfloat16))
               for n, p in params.items())
    assert _dtypes(model) == {torch.float32}
    assert all(q is params[n] for n, q in model.named_parameters())
