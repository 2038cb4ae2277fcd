"""The port's VLM backbone (the ``vlm`` family, LLaVA-NeXT) with prefix
embeddings against the JAX package, on the CPU.

The same numpy weights (the reference's own init, converted by
``params_from_jax``), the same prompt and the same numpy prefix
embeddings go through ``repro``'s ``lm_prefill`` / ``lm_decode_step``
(xla path, float32, jitted) and through ``repro_torch``'s
``Transformer`` (plain PyTorch path, float32).  Tolerance 1e-4 (rtol and
atol): both compute in float32, but sums run in another order.
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import ExecConfig, build_model

TOL = 1e-4
N_DECODE = 8
PROMPT = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_gqa7(get_config):
    """Seven query heads over one KV head, as LLaVA-NeXT-34B's 56 over 8:
    a GQA group that is not a power of two."""
    cfg = get_config("llava_next_34b").reduced()
    return dataclasses.replace(
        cfg, name="llava-3l-gqa7", n_layers=3, d_model=56, d_ff=96,
        attn=dataclasses.replace(cfg.attn, n_heads=7, n_kv_heads=1,
                                 head_dim=8))


# each case builds its config from either package's config module
CASES = {
    "llava-reduced": lambda get: get("llava_next_34b").reduced(),
    "llava-3l-gqa7": _narrow_gqa7,
}


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL,
                               err_msg=msg)


def _prompt(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    prefix = rng.standard_normal(
        (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return tokens, prefix


@pytest.mark.parametrize("case", sorted(CASES))
def test_vlm_prefill_decode_match_jax(case):
    cfg = CASES[case](get_config)
    pcfg = CASES[case](torch_get_config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert cfg.family == "vlm" and cfg.n_prefix_tokens == 8
    assert not cfg.tie_embeddings
    jex = JaxExecConfig(backend="xla", attn_block=16)
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(4))
    j_prefill = jax.jit(lambda p, t, e: jax_transformer.lm_prefill(
        p, t, cfg, jex, e))
    j_decode = jax.jit(lambda p, c, t, pos: jax_transformer.lm_decode_step(
        p, c, t, pos, cfg, jex))

    ex = ExecConfig(device="cpu", attn_block=16)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), pcfg), strict=True)

    b, s = 2, PROMPT
    tokens, prefix = _prompt(cfg, b, s)
    j_logits, j_cache = j_prefill(params, jnp.asarray(tokens),
                                  jnp.asarray(prefix))
    t_cache = fns.init_cache(b, s + N_DECODE, ex)
    t_logits, t_cache = fns.prefill(
        model, {"tokens": torch.from_numpy(tokens).long(),
                "prefix_embeds": torch.from_numpy(prefix)}, ex, t_cache)
    _close(t_logits, j_logits, "prefill logits")
    for name in ("k", "v"):
        _close(t_cache[name][:, :, :, :s], j_cache[name], f"prefill {name}")

    full = jax_transformer.init_cache(cfg, b, s + N_DECODE, jnp.float32)
    j_cache = {n: full[n].at[:, :, :, :s].set(j_cache[n]) for n in full}
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


def test_tokens_under_the_prefix_change_nothing():
    """The prefix embeddings replace the first P positions: other tokens
    there give the same logits and K/V; other embeddings do not."""
    cfg = torch_get_config("llava_next_34b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    fns = build_model(cfg)
    model = fns.init(2, ex)
    tokens, prefix = _prompt(cfg, 2, PROMPT, seed=3)
    other = tokens.copy()
    other[:, :cfg.n_prefix_tokens] = (other[:, :cfg.n_prefix_tokens] + 1) \
        % cfg.vocab
    runs = []
    for toks, emb in ((tokens, prefix), (other, prefix),
                      (tokens, prefix * 0.5)):
        runs.append(fns.prefill(model, {
            "tokens": torch.from_numpy(toks).long(),
            "prefix_embeds": torch.from_numpy(emb)}, ex))
    (l0, c0), (l1, c1), (l2, _) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"], c1["v"])
    assert (l0 - l2).abs().max() > 1e-3


def test_prefix_longer_than_the_prompt_raises():
    cfg = torch_get_config("llava_next_34b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    fns = build_model(cfg)
    model = fns.init(0, ex)
    tokens, prefix = _prompt(cfg, 1, cfg.n_prefix_tokens - 1)
    with pytest.raises(ValueError, match="prefix_embeds"):
        fns.prefill(model, {"tokens": torch.from_numpy(tokens).long(),
                            "prefix_embeds": torch.from_numpy(prefix)}, ex)


def test_make_batch_gives_seeded_prefix_embeds():
    """A vlm batch holds (B, n_prefix_tokens, d_model) standard normals in
    the compute dtype, drawn from the tokens' seeded generator; other
    families' batches hold tokens only."""
    cfg = torch_get_config("llava_next_34b").reduced()
    shape = ShapeConfig("serve", "prefill", PROMPT, 3)
    fns = build_model(cfg)
    b1 = fns.make_batch(7, shape, ExecConfig(device="cpu"))
    b2 = fns.make_batch(7, shape, ExecConfig(device="cpu"))
    bf = fns.make_batch(7, shape, ExecConfig(
        device="cpu", param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16))
    emb = b1["prefix_embeds"]
    assert emb.shape == (3, cfg.n_prefix_tokens, cfg.d_model)
    assert emb.dtype == torch.float32 and bf["prefix_embeds"].dtype == \
        torch.bfloat16
    assert torch.equal(emb, b2["prefix_embeds"])
    assert torch.equal(b1["tokens"], bf["tokens"])
    assert torch.equal(bf["prefix_embeds"], emb.to(torch.bfloat16))
    assert 0.8 < float(emb.std()) < 1.2
    dense = build_model(torch_get_config("tinyllama_1_1b").reduced())
    assert set(dense.make_batch(7, shape, ExecConfig(device="cpu"))) == {
        "tokens"}


def test_generate_runs_llava_reduced_on_cpu():
    """The vlm family through the serving entry point: greedy tokens in
    range, finite logits, and the same tokens from the same seed."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config("llava_next_34b").reduced()
    ex = ExecConfig(device="cpu", attn_block=16)
    g1 = generate(cfg, ex, prompt_len=PROMPT, gen_len=6, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=PROMPT, gen_len=6, batch=2, seed=1)
    assert g1.tokens.shape == (2, 6)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)
    assert torch.equal(g1.prefill_logits, g2.prefill_logits)
