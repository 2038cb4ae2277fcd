"""The port's hybrid (Zamba2) prefill + greedy decode against the JAX
package, on the CPU.

The same numpy weights (the reference's own init, converted by
``params_from_jax``) and the same prompt go through ``repro``'s
``hybrid_prefill`` / ``hybrid_decode_step`` (xla path, float32, jitted)
and through ``repro_torch``'s ``Hybrid`` (plain PyTorch path, float32).
Tolerance 1e-4 (rtol and atol): both compute in float32, but sums run in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jax_hybrid
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
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


def _narrow_5_layer(get_config):
    """Period 2 over 5 layers: two applications of the shared block and
    one leftover SSM layer; two B/C groups; MQA in the shared block."""
    cfg = get_config("zamba2_7b").reduced()
    return dataclasses.replace(
        cfg, name="zamba2-5l-narrow", n_layers=5, d_model=32, d_ff=64,
        attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv_heads=1,
                                 head_dim=16),
        ssm=dataclasses.replace(cfg.ssm, n_groups=2))


# each case builds its config from either package's config module
CASES = {
    "zamba2-reduced": lambda get: get("zamba2_7b").reduced(),
    "zamba2-5l-narrow": _narrow_5_layer,
}


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL,
                               err_msg=msg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_prefill_decode_match_jax(case):
    cfg = CASES[case](get_config)
    pcfg = CASES[case](torch_get_config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jex = JaxExecConfig(backend="xla", attn_block=16, ssd_chunk=CHUNK)
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(5))
    j_prefill = jax.jit(
        lambda p, t: jax_hybrid.hybrid_prefill(p, t, cfg, jex))
    j_decode = jax.jit(lambda p, c, t, pos: jax_hybrid.hybrid_decode_step(
        p, c, t, pos, cfg, jex))
    np_params = jax.tree.map(np.asarray, params)

    ex = ExecConfig(device="cpu", attn_block=16, ssd_chunk=CHUNK)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(params_from_jax(np_params, pcfg))

    b, s = 2, 24
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    j_logits, j_cache = j_prefill(params, jnp.asarray(tokens))
    t_logits, t_cache = fns.prefill(
        model, {"tokens": torch.from_numpy(tokens).long()}, ex)
    _close(t_logits, j_logits, "prefill logits")
    for name in ("k", "v"):
        _close(t_cache[name], j_cache[name], f"prefill {name}")
    for name in ("conv", "ssm"):   # zeros on both sides (ROADMAP C6)
        _close(t_cache[name], j_cache["ssm"][name], f"prefill {name}")

    # decode with headroom: both caches hold prompt + N_DECODE positions
    full = jax_hybrid.hybrid_init_cache(cfg, b, s + N_DECODE, jnp.float32)
    j_cache = dict(j_cache, **{n: full[n].at[:, :, :, :s].set(j_cache[n])
                               for n in ("k", "v")})
    t_full = fns.init_cache(b, s + N_DECODE, ex)
    for n in ("k", "v"):
        t_full[n][:, :, :, :s] = t_cache[n]
    t_cache = t_full
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    for i in range(N_DECODE):
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok)), i
        j_logits, j_cache = j_decode(params, j_cache, j_tok, jnp.int32(s + i))
        t_logits, t_cache = fns.decode_step(model, t_cache, t_tok, s + i, ex)
        _close(t_logits, j_logits, f"step {i}")
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_logits, -1)
    for name in ("k", "v"):
        _close(t_cache[name], j_cache[name], f"decoded {name}")
    for name in ("conv", "ssm"):
        _close(t_cache[name], j_cache["ssm"][name], f"decoded {name}")
