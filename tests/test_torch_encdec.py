"""The port's encoder-decoder (the ``encdec`` family, Whisper) against the
JAX package, on the CPU.

The same numpy weights (the reference's own init, converted by
``params_from_jax``), the same prompt and the same numpy frame embeddings
go through ``repro``'s ``encode`` / ``encdec_prefill`` /
``encdec_decode_step`` (xla path, float32, jitted) and through
``repro_torch``'s ``EncDec`` (plain PyTorch path, float32).  Tolerance
1e-4 (rtol and atol): both compute in float32, but sums run in another
order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import ExecConfig, build_model

TOL = 1e-4
N_DECODE = 8
BLOCK = 16   # attn_block of both paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged(get_config):
    """20 encoder frames (not a multiple of the 16-key block) and one KV
    head for four query heads; with a 24-token prompt the decoder's
    cross-attention has more queries than keys (Sq > Sk)."""
    cfg = get_config("whisper_medium").reduced()
    return dataclasses.replace(
        cfg, name="whisper-enc20-gqa4", encoder_len=20,
        attn=dataclasses.replace(cfg.attn, n_kv_heads=1))


# each case builds its config from either package's config module, and
# gives its prompt length
CASES = {
    # 16 frames, 4 query heads over 2 KV heads, a 12-token prompt (Sq < Sk)
    "whisper-reduced": (lambda get: get("whisper_medium").reduced(), 12),
    "whisper-enc20-gqa4": (_ragged, 24),
}


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL,
                               err_msg=msg)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    frames = rng.standard_normal(
        (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return tokens, frames


@pytest.mark.parametrize("case", sorted(CASES))
def test_encdec_encode_prefill_decode_match_jax(case):
    make, s = CASES[case]
    cfg, pcfg = make(get_config), make(torch_get_config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    assert cfg.family == "encdec" and cfg.tie_embeddings
    jex = JaxExecConfig(backend="xla", attn_block=BLOCK)
    params = jax.jit(lambda key: jax_build_model(cfg).init(key, jex))(
        jax.random.PRNGKey(5))
    j_encode = jax.jit(lambda p, f: jax_encdec.encode(p, f, cfg, jex))
    j_prefill = jax.jit(lambda p, t, f: jax_encdec.encdec_prefill(
        p, t, f, cfg, jex))
    j_decode = jax.jit(lambda p, c, t, pos: jax_encdec.encdec_decode_step(
        p, c, t, pos, cfg, jex))

    ex = ExecConfig(device="cpu", attn_block=BLOCK)
    fns = build_model(pcfg)
    model = fns.init(0, ex)
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), pcfg), strict=True)

    b = 2
    tokens, frames = _inputs(cfg, b, s)
    _close(model.encode(torch.from_numpy(frames), ex),
           j_encode(params, jnp.asarray(frames)), "encoder output")

    j_logits, j_cache = j_prefill(params, jnp.asarray(tokens),
                                  jnp.asarray(frames))
    t_cache = fns.init_cache(b, s + N_DECODE, ex)
    t_logits, t_cache = fns.prefill(
        model, {"tokens": torch.from_numpy(tokens).long(),
                "encoder_embeds": torch.from_numpy(frames)}, ex, t_cache)
    _close(t_logits, j_logits, "prefill logits")
    for name in ("k", "v"):
        _close(t_cache[name][:, :, :, :s], j_cache[name], f"prefill {name}")
    for name in ("xk", "xv"):
        assert t_cache[name].shape[3] == cfg.encoder_len
        _close(t_cache[name], j_cache[name], f"prefill {name}")

    full = jax_encdec.encdec_init_cache(cfg, b, s + N_DECODE, jnp.float32)
    j_cache = {"k": full["k"].at[:, :, :, :s].set(j_cache["k"]),
               "v": full["v"].at[:, :, :, :s].set(j_cache["v"]),
               "xk": j_cache["xk"], "xv": j_cache["xv"]}
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    cross = {n: t_cache[n].clone() for n in ("xk", "xv")}
    for i in range(N_DECODE):
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok)), i
        j_logits, j_cache = j_decode(params, j_cache, j_tok, jnp.int32(s + i))
        t_logits, t_cache = fns.decode_step(model, t_cache, t_tok, s + i, ex)
        _close(t_logits, j_logits, f"step {i}")
        j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_logits, -1)
    for name in ("k", "v"):
        _close(t_cache[name], j_cache[name], f"decoded {name}")
    # decode reads the cross K/V and never writes them
    for name in ("xk", "xv"):
        assert torch.equal(t_cache[name], cross[name])


def test_encoder_frames_of_another_shape_raise():
    cfg = torch_get_config("whisper_medium").reduced()
    ex = ExecConfig(device="cpu", attn_block=BLOCK)
    fns = build_model(cfg)
    model = fns.init(0, ex)
    tokens, frames = _inputs(cfg, 2, 8)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    with pytest.raises(ValueError, match="encoder_embeds"):
        fns.prefill(model, batch, ex)
    with pytest.raises(ValueError, match="encoder_embeds"):
        fns.prefill(model, {**batch, "encoder_embeds": torch.from_numpy(
            frames[:, :-1])}, ex)


def test_make_batch_gives_seeded_encoder_embeds():
    """An encdec batch holds (B, encoder_len, d_model) standard normals in
    the compute dtype, drawn from the tokens' seeded generator."""
    cfg = torch_get_config("whisper_medium").reduced()
    shape = ShapeConfig("serve", "prefill", 12, 3)
    fns = build_model(cfg)
    b1 = fns.make_batch(7, shape, ExecConfig(device="cpu"))
    b2 = fns.make_batch(7, shape, ExecConfig(device="cpu"))
    b3 = fns.make_batch(8, shape, ExecConfig(device="cpu"))
    bf = fns.make_batch(7, shape, ExecConfig(
        device="cpu", param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16))
    assert set(b1) == {"tokens", "encoder_embeds"}
    emb = b1["encoder_embeds"]
    assert emb.shape == (3, cfg.encoder_len, cfg.d_model)
    assert emb.dtype == torch.float32
    assert bf["encoder_embeds"].dtype == torch.bfloat16
    assert torch.equal(emb, b2["encoder_embeds"])
    assert not torch.equal(emb, b3["encoder_embeds"])
    assert torch.equal(b1["tokens"], bf["tokens"])
    assert torch.equal(bf["encoder_embeds"], emb.to(torch.bfloat16))
    assert 0.8 < float(emb.std()) < 1.2


def test_generate_runs_whisper_reduced_on_cpu():
    """The encdec family through the serving entry point: greedy tokens in
    range, finite logits, and the same tokens from the same seed."""
    from repro_torch.launch.serve import generate
    cfg = torch_get_config("whisper_medium").reduced()
    ex = ExecConfig(device="cpu", attn_block=BLOCK)
    g1 = generate(cfg, ex, prompt_len=20, gen_len=6, batch=2, seed=1)
    g2 = generate(cfg, ex, prompt_len=20, gen_len=6, batch=2, seed=1)
    assert g1.tokens.shape == (2, 6)
    assert int(g1.tokens.min()) >= 0 and int(g1.tokens.max()) < cfg.vocab
    assert torch.isfinite(g1.prefill_logits).all()
    assert torch.equal(g1.tokens, g2.tokens)
    assert torch.equal(g1.prefill_logits, g2.prefill_logits)
