"""The port's plain kernel versions against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances
are those of the reference's own kernel sweeps: float32 2e-5 (flash) and
1e-5 (rmsnorm), where only the order of sums differs; bfloat16 2e-2, one
rounding of the bf16 output.  The CUDA kernels themselves run only on a
card (``chip_smoke.py`` holds them against these plain versions there).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as port_rmsnorm
from repro_torch.kernels import ref

SWEEP = [
    # b, hq, hkv, s, d, window, softcap, causal
    (1, 2, 2, 128, 32, None, 0.0, True),
    (2, 4, 2, 128, 16, None, 0.0, True),
    (1, 8, 1, 256, 32, None, 0.0, True),     # MQA
    (2, 4, 4, 128, 64, 32, 0.0, True),       # SWA
    (1, 2, 2, 128, 32, None, 50.0, True),    # softcap (gemma2)
    (1, 2, 2, 128, 32, 64, 30.0, True),      # SWA + softcap
    (1, 4, 2, 128, 32, None, 0.0, False),    # encoder (non-causal)
    (1, 2, 2, 128, 112, None, 0.0, True),    # Zamba2's shared block
    (1, 2, 1, 128, 256, 64, 50.0, True),     # gemma2: SWA + softcap
]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shapes, np_dtype, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(np_dtype)
            for s in shapes]


def _torch(a, t_dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(t_dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d,win,cap,causal", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_vs_pallas(b, hq, hkv, s, d, win, cap, causal, dtype):
    np_dt, t_dt, j_dt = DTYPES[dtype]
    q, k, v = _inputs([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], np_dt)
    o_j, lse_j = flash_attention_fwd(
        jnp.asarray(q, j_dt), jnp.asarray(k, j_dt), jnp.asarray(v, j_dt),
        win, causal=causal, softcap=cap, block_q=64, block_k=64,
        interpret=True)
    o_t, lse_t = port_flash.flash_attention_plain(
        _torch(q, t_dt), _torch(k, t_dt), _torch(v, t_dt), win,
        causal=causal, softcap=cap, block=64)
    assert o_t.dtype == t_dt and lse_t.dtype == torch.float32
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(o_t), _f32(np.asarray(o_j, np.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(lse_t), np.asarray(lse_j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s,block", [(100, 32), (128, 48), (128, 128)])
def test_flash_plain_ragged_blocks_vs_dense(s, block):
    """Any S and key tile: the ragged last tile is masked, not padded."""
    q, k, v = _inputs([(2, 4, s, 16), (2, 2, s, 16), (2, 2, s, 16)],
                      np.float32, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o, _ = port_flash.flash_attention_plain(*args, 40, causal=True,
                                            block=block)
    r = ref.attention_ref(*args, causal=True, window=40)
    np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=2e-5, atol=2e-5)


REFUSED = {
    # name: (q shape, k and v shapes, kwargs, message)
    "batch": ((2, 2, 8, 16), (1, 2, 12, 16), {}, "batch or head_dim"),
    "head_dim": ((1, 2, 8, 16), (1, 2, 12, 32), {}, "batch or head_dim"),
    "empty_window": ((1, 2, 8, 16), (1, 2, 8, 16), {"window": 0},
                     "window"),
    "causal_sq_over_sk": ((1, 2, 12, 16), (1, 2, 8, 16), {},
                          "causal mask needs Sq <= Sk"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_flash_rejects_cross_attention_and_empty_window(case):
    """The wrapper (before it asks for a card) and the plain version, and
    so ``ops.flash_attention``, refuse q and k/v of another batch or
    head_dim, an empty window and a causal mask over more queries than
    keys; Sq != Sk itself is cross-attention, which both take."""
    q_shape, kv_shape, kw, msg = REFUSED[case]
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    for fn in (port_flash.flash_attention_fwd,
               port_flash.flash_attention_plain, ops.flash_attention):
        with pytest.raises(ValueError, match=msg):
            fn(q, k, k, **kw)
    assert port_flash.launches == 0


WIDTHS = {torch.float32: [(8, 16), (16, 16), (64, 64), (112, 128),
                          (128, 128), (136, 256), (256, 256)],
          # bf16's tensor-core kernel stores 64-column swizzled slabs
          torch.bfloat16: [(8, 64), (32, 64), (64, 64), (72, 128),
                           (112, 128), (128, 128), (136, 256), (256, 256)]}


@pytest.mark.parametrize(
    "d,width,dtype",
    [(d, w, dt) for dt, rows in WIDTHS.items() for d, w in rows],
    ids=[f"{d}-{w}" + ("" if dt == torch.float32 else "-bf16")
         for dt, rows in WIDTHS.items() for d, w in rows])
def test_flash_kernel_width_holds_head_dim(d, width, dtype):
    """The kernel runs head_dim d at the smallest instantiated width that
    holds it (zeros past d): float32's FMA kernel by default, bfloat16's
    tensor-core kernel at its own widths."""
    if dtype == torch.float32:
        assert port_flash.kernel_head_dim(d) == width
    assert port_flash.kernel_head_dim(d, dtype) == width


SERVED = [
    # b, hq, hkv, d: TinyLlama's head_dim and an 8:1 group, Zamba2's 112
    # (MHA), Qwen3-MoE's 128 with its group of 16
    (1, 8, 1, 64),
    (1, 2, 2, 112),
    (1, 16, 1, 128),
]


@pytest.mark.parametrize("b,hq,hkv,d", SERVED)
def test_flash_plain_vs_pallas_bf16_served_length(b, hq, hkv, d):
    """bf16 at the served prompt length, causal.  The Pallas kernel rounds
    P to bf16 before the P.V product (``p.astype(v.dtype)``), as a
    tensor-core kernel must; the plain version keeps P in float32.  Their
    agreement at S=1024 within the card's bf16 tolerances (o 2e-2, lse
    1e-3) is what lets the card hold its tensor-core kernel against the
    plain version at those tolerances.  Rounding P moves o only: lse is
    summed from float32 P on both sides."""
    np_dt, t_dt, j_dt = DTYPES["bfloat16"]
    s = 1024
    q, k, v = _inputs([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], np_dt,
                      seed=7)
    o_j, lse_j = flash_attention_fwd(
        jnp.asarray(q, j_dt), jnp.asarray(k, j_dt), jnp.asarray(v, j_dt),
        None, causal=True, block_q=128, block_k=128, interpret=True)
    o_t, lse_t = port_flash.flash_attention_plain(
        _torch(q, t_dt), _torch(k, t_dt), _torch(v, t_dt), None, causal=True)
    np.testing.assert_allclose(_f32(o_t), _f32(np.asarray(o_j, np.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_f32(lse_t), np.asarray(lse_j), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("d", [4, 12, 100, 264])
def test_flash_kernel_refuses_head_dim(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        port_flash.kernel_head_dim(d)


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 128), (1, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_plain_vs_pallas(shape, dtype, offset):
    np_dt, t_dt, j_dt = DTYPES[dtype]
    x, w = _inputs([shape, shape[-1:]], np_dt, seed=0)
    w = (w.astype(np.float32) * 0.1).astype(np_dt)
    o_j = pallas_rmsnorm(jnp.asarray(x, j_dt), jnp.asarray(w, j_dt),
                         weight_offset=offset, block_rows=8, interpret=True)
    o_t = ops.rmsnorm(_torch(x, t_dt), _torch(w, t_dt), eps=1e-6,
                      weight_offset=offset)
    assert o_t.dtype == t_dt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(o_t), np.asarray(o_j, np.float32),
                               rtol=tol, atol=tol)


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors the ops take the plain versions: no launch counted."""
    before = (port_flash.launches, port_rmsnorm.launches)
    x = torch.randn(2, 4, 64, 16)
    ops.flash_attention(x, x[:, :2].contiguous(), x[:, :2].contiguous())
    ops.rmsnorm(torch.randn(3, 32), torch.ones(32))
    assert (port_flash.launches, port_rmsnorm.launches) == before == (0, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches only on CUDA tensors; it never falls back."""
    x = torch.randn(1, 2, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port_flash.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        port_rmsnorm.rmsnorm(torch.randn(2, 32), torch.ones(32))
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        ops.rmsnorm(torch.randn(2, 32), torch.ones(32, device="meta"))


@pytest.mark.parametrize("shape", [(3, 2, 128), (2, 2048), (2, 3584),
                                   (2, 4096)],
                         ids=["qwen3_qk_norm", "tinyllama", "zamba2",
                              "qwen3"])
def test_rmsnorm_plain_vs_pallas_served_widths(shape):
    """bf16 at the served widths, each on another path of the kernel:
    128 packs two rows a warp, 2048-4096 hold a row in registers (8, 14
    and 16 vectors a lane)."""
    np_dt, t_dt, j_dt = DTYPES["bfloat16"]
    x, w = _inputs([shape, shape[-1:]], np_dt, seed=3)
    w = (1.0 + 0.1 * w.astype(np.float32)).astype(np_dt)
    o_j = pallas_rmsnorm(jnp.asarray(x, j_dt), jnp.asarray(w, j_dt),
                         block_rows=8, interpret=True)
    o_t = ops.rmsnorm(_torch(x, t_dt), _torch(w, t_dt), eps=1e-6)
    np.testing.assert_allclose(_f32(o_t), np.asarray(o_j, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [128, 2050, 4096, 40000])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_wrapper_refuses_cpu_tensors_any_width(d, dtype):
    """Packed, register-resident, scalar and two-pass widths alike: the
    wrapper raises on CPU tensors and counts no launch."""
    t_dt = DTYPES[dtype][1]
    with pytest.raises(ValueError, match="CUDA"):
        port_rmsnorm.rmsnorm(torch.zeros(2, d, dtype=t_dt),
                             torch.ones(d, dtype=t_dt))
    assert port_rmsnorm.launches == 0


GRAD_CASES = [
    # hq, hkv, window, softcap, causal
    (4, 2, None, 0.0, True),      # causal GQA
    (4, 4, 16, 0.0, True),        # sliding window
    (4, 2, None, 30.0, True),     # softcap
    (4, 2, 24, 20.0, True),       # window + softcap
    (4, 2, None, 0.0, False),     # non-causal
]


@pytest.mark.parametrize("hq,hkv,win,cap,causal", GRAD_CASES)
def test_flash_gradients_vs_jax_grad(hq, hkv, win, cap, causal):
    """dq, dk, dv of the port's flash_attention (CPU: plain forward, the
    torch-op backward on its saved o and lse) against ``jax.grad`` of the
    reference's custom VJP on its xla path, float32, within 1e-5."""
    import jax

    from repro.kernels import ops as ref_ops
    q, k, v, do = _inputs([(1, hq, 64, 32), (1, hkv, 64, 32),
                           (1, hkv, 64, 32), (1, hq, 64, 32)], np.float32)

    def loss(q_, k_, v_):
        o = ref_ops.flash_attention(q_, k_, v_, window=win, causal=causal,
                                    softcap=cap, backend="xla")
        return (o * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*ts, window=win, causal=causal, softcap=cap)
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), ts)
    for name, a, b in zip(("dq", "dk", "dv"), want, got):
        assert b.shape == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=name)


CROSS = [
    # b, hq, hkv, sq, sk, window, softcap, causal
    (2, 4, 2, 24, 64, None, 0.0, True),      # causal, Sq < Sk: the last rows
    (1, 4, 2, 40, 100, 16, 0.0, True),       # causal with a window
    (2, 4, 4, 24, 75, None, 0.0, False),     # cross-attention, Sq < Sk
    (1, 8, 2, 75, 20, None, 0.0, False),     # cross-attention, Sq > Sk
    (1, 4, 1, 50, 30, 12, 20.0, False),      # Sq > Sk, window + softcap
    (1, 4, 2, 1, 48, None, 0.0, True),       # one query over the whole cache
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,win,cap,causal", CROSS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_cross_attention_vs_reference(b, hq, hkv, sq, sk, win,
                                                  cap, causal, dtype):
    """Sq != Sk: the plain version against the reference's dense
    ``attention_ref`` and its xla flash path, both with q at the last Sq of
    the Sk positions; float32 within 2e-5, bfloat16 within one rounding of
    the output (2e-2)."""
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as jax_ref
    np_dt, t_dt, j_dt = DTYPES[dtype]
    q, k, v = _inputs([(b, hq, sq, 32), (b, hkv, sk, 32), (b, hkv, sk, 32)],
                      np_dt, seed=11)
    o_t, lse_t = port_flash.flash_attention_plain(
        _torch(q, t_dt), _torch(k, t_dt), _torch(v, t_dt), win,
        causal=causal, softcap=cap, block=16)
    assert o_t.shape == (b, hq, sq, 32) and lse_t.shape == (b, hq, sq)
    assert o_t.dtype == t_dt
    jq, jk, jv = (jnp.asarray(a, j_dt) for a in (q, k, v))
    want = {
        "attention_ref": jax_ref.attention_ref(jq, jk, jv, causal=causal,
                                               window=win, softcap=cap),
        "xla": ref_ops.flash_attention(jq, jk, jv, window=win,
                                       causal=causal, softcap=cap, block=16,
                                       backend="xla")}
    tol = 2e-5 if dtype == "float32" else 2e-2
    for name, o_j in want.items():
        np.testing.assert_allclose(_f32(o_t), _f32(np.asarray(o_j,
                                                              np.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("sq,sk,win,causal", [(24, 64, None, True),
                                              (24, 64, 20, True),
                                              (40, 24, None, False),
                                              (16, 48, 12, False)])
def test_flash_gradients_cross_attention_vs_jax_grad(sq, sk, win, causal):
    """dq, dk, dv at Sq != Sk (GQA 4/2, float32): the port's torch-op
    backward against ``jax.grad`` of the reference's xla path, within
    1e-5."""
    from repro.kernels import ops as ref_ops
    q, k, v, do = _inputs([(1, 4, sq, 16), (1, 2, sk, 16), (1, 2, sk, 16),
                           (1, 4, sq, 16)], np.float32, seed=5)

    def loss(q_, k_, v_):
        o = ref_ops.flash_attention(q_, k_, v_, window=win, causal=causal,
                                    block=8, backend="xla")
        return (o * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*ts, window=win, causal=causal, block=8)
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), ts)
    for name, a, b in zip(("dq", "dk", "dv"), want, got):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_flash_forward_without_grad_is_the_plain_forward():
    """Where no gradient is asked for, flash_attention is exactly the
    forward the serving paths run (no autograd node, same values)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        [(1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)], np.float32))
    o = ops.flash_attention(q, k, v, window=16)
    o_p, _ = port_flash.flash_attention_plain(q, k, v, 16)
    assert o.grad_fn is None and torch.equal(o, o_p)
    with torch.no_grad():
        o2 = ops.flash_attention(q.requires_grad_(), k, v, window=16)
    assert o2.grad_fn is None and torch.equal(o2, o_p)
