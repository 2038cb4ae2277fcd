"""The port's prefill + greedy decode against the JAX package, on the CPU.

The same numpy weights (the reference's own init, converted by
``params_from_jax``) and the same prompt go through ``repro``'s
``lm_prefill`` / ``lm_decode_step`` (xla path, float32) and through
``repro_torch``'s model (plain PyTorch path, float32).  Tolerance 1e-4
(rtol and atol): both compute in float32, but sums run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ExecConfig, build_model

TOL = 1e-4
N_DECODE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_3_layer(get_config):
    cfg = get_config("tinyllama_1_1b").reduced()
    return dataclasses.replace(
        cfg, name="tinyllama-3l-narrow", n_layers=3, d_model=32, d_ff=96,
        attn=dataclasses.replace(cfg.attn, n_heads=4, n_kv_heads=1,
                                 head_dim=8))


# each case builds its config from either package's config module
CASES = {
    "tinyllama-reduced": lambda get: get("tinyllama_1_1b").reduced(),
    "tinyllama-3l-narrow": _narrow_3_layer,
    # window alternation, attention + logit softcap, tied head
    "gemma2-reduced": lambda get: get("gemma2_2b").reduced(),
    # MoE (4 experts, top-2) with qk-norm
    "qwen3-moe-reduced": lambda get: get("qwen3_moe_235b_a22b").reduced(),
    # MoE with a uniform window of 16: a rolling KV cache.  At prompt 24
    # decode overwrites a slot still in the window (ROADMAP C7), and the
    # port matches the reference as it is; at prompt 32 (a multiple of the
    # window) the slots agree
    "mixtral-reduced": lambda get: get("mixtral_8x7b").reduced(),
    "mixtral-reduced-p32": lambda get: get("mixtral_8x7b").reduced(),
}
# prompt length of a case (default 24)
PROMPTS = {"mixtral-reduced-p32": 32}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_match_jax(case):
    cfg = CASES[case](get_config)
    pcfg = CASES[case](torch_get_config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jex = JaxExecConfig(backend="xla", attn_block=16)
    # jitted as the reference's serving driver runs them
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(3))
    j_prefill = jax.jit(
        lambda p, t: jax_transformer.lm_prefill(p, t, cfg, jex))
    j_decode = jax.jit(lambda p, c, t, pos: jax_transformer.lm_decode_step(
        p, c, t, pos, cfg, jex))
    np_params = jax.tree.map(np.asarray, params)

    ex = ExecConfig(device="cpu", attn_block=16)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(params_from_jax(np_params, pcfg))

    b, s = 2, PROMPTS.get(case, 24)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32)
    j_logits, j_cache = j_prefill(params, jnp.asarray(tokens))
    t_logits, t_cache = fns.prefill(
        model, {"tokens": torch.from_numpy(tokens).long()}, ex)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=TOL,
                                   atol=TOL)

    # decode with headroom: both caches hold prompt + N_DECODE positions
    full = jax_transformer.init_cache(cfg, b, s + N_DECODE, jnp.float32)
    j_cache = {n: full[n].at[:, :, :, :s].set(j_cache[n]) for n in full}
    t_full = fns.init_cache(b, s + N_DECODE, ex)
    for n in t_full:
        t_full[n][:, :, :, :s] = t_cache[n]
    t_cache = t_full
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    for i in range(N_DECODE):
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok)), i
        j_logits, j_cache = j_decode(params, j_cache, j_tok, jnp.int32(s + i))
        t_logits, t_cache = fns.decode_step(model, t_cache, t_tok, s + i, ex)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_logits, -1)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=TOL,
                                   atol=TOL)


def test_generate_runs_reduced_on_cpu():
    """The serving entry point end to end at a tiny size: greedy tokens in
    range, finite logits, and the same tokens from the same seed."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config("tinyllama_1_1b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    g1 = generate(cfg, ex, prompt_len=20, gen_len=5, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=20, gen_len=5, batch=2, seed=1)
    assert g1.tokens.shape == (2, 5)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "mixtral_8x7b"])
def test_generate_runs_moe_reduced_on_cpu(arch):
    """The MoE family through the serving entry point; mixtral's rolling
    cache of 16 positions wraps (prompt 20 + 12 new tokens)."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config(arch).reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    g1 = generate(cfg, ex, prompt_len=20, gen_len=12, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=20, gen_len=12, batch=2, seed=1)
    assert g1.tokens.shape == (2, 12)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)


def test_generate_runs_zamba2_reduced_on_cpu():
    """The hybrid family through the serving entry point: SSD prefill with
    the config's chunk, decode of the SSM state, the same tokens from the
    same seed."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config("zamba2_7b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16, ssd_chunk=cfg.ssm.chunk)
    g1 = generate(cfg, ex, prompt_len=24, gen_len=5, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=24, gen_len=5, batch=2, seed=1)
    assert g1.tokens.shape == (2, 5)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)


def test_other_families_raise():
    """Every family of the configs is ported; a family outside
    ``PORTED_FAMILIES`` raises."""
    from repro_torch.models.api import PORTED_FAMILIES
    assert set(PORTED_FAMILIES) == {"dense", "moe", "hybrid", "ssm", "vlm",
                                    "encdec"}
    cfg = dataclasses.replace(torch_get_config("whisper_medium"),
                              family="retrieval")
    with pytest.raises(NotImplementedError, match="family"):
        build_model(cfg)


@pytest.mark.parametrize("arch,family", [("mamba2_780m", "ssm"),
                                         ("llava_next_34b", "vlm"),
                                         ("whisper_medium", "encdec")])
def test_ssm_and_vlm_families_build(arch, family):
    """The ssm, vlm and encdec families build at full size (no weights
    made)."""
    from repro_torch.models.api import PORTED_FAMILIES
    cfg = torch_get_config(arch)
    assert cfg.family == family and family in PORTED_FAMILIES
    fns = build_model(cfg)
    assert fns.cfg is cfg


@pytest.mark.parametrize("prompt", [12, 24, 32])
def test_rolling_cache_c7_decode_vs_full_prefill(prompt):
    """ROADMAP C7, as the port reproduces it: with a rolling cache of 16
    positions, the first decode step after a prompt of 24 disagrees with
    a full prefill of the same 25 tokens (decode overwrites a slot still
    in the window), while prompts of 12 and 32 agree.  Reduced Mixtral
    turned dense, so only the cache layout differs."""
    cfg = dataclasses.replace(torch_get_config("mixtral_8x7b").reduced(),
                              family="dense", moe=None)
    assert cfg.attn.window == 16
    ex = ExecConfig(device="cpu", attn_block=16)
    fns = build_model(cfg)
    model = fns.init(0, ex)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, prompt + 1))).long()
    full, _ = fns.prefill(model, {"tokens": tokens}, ex)
    _, cache = fns.prefill(model, {"tokens": tokens[:, :prompt]}, ex,
                           fns.init_cache(2, prompt + 1, ex))
    step, _ = fns.decode_step(model, cache, tokens[:, prompt], prompt, ex)
    err = (step - full).abs().max().item()
    if prompt % cfg.attn.window and prompt > cfg.attn.window:
        assert err > 0.1 * full.abs().max().item()
    else:
        assert err < TOL
