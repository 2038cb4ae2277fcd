"""The port's SSD operator against the JAX package, on the CPU.

``ops.ssd`` on CPU tensors runs the plain version (``ssd_chunked_ref``),
which is held against the Pallas ``ssd_scan`` in interpret mode and
against the reference's per-step recurrence ``ssd_ref``; the port's own
``ssd_ref`` and final states are held against the reference's too.
Inputs are made with numpy from a seed and handed to both.  Tolerances
are those of the reference's own sweep: float32 3e-4, bfloat16 4e-2 (the
output is rounded to bf16).  The CUDA kernel runs only on a card
(``chip_smoke.py`` holds it against ``ssd_plain`` there).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as port_ssd

# the reference's sweep (tests/test_kernels_moe_ssd_norm.py)
SWEEP = [
    # bb, s, h, p, g, n, chunk
    (1, 32, 2, 8, 1, 16, 8),
    (2, 64, 4, 16, 2, 16, 16),
    (1, 128, 4, 8, 4, 32, 32),   # n_groups == n_heads
    (2, 64, 8, 16, 1, 8, 64),    # single big chunk
]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 3e-4, "bfloat16": 4e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bb, s, h, p, g, n, np_dtype, seed=7):
    """x, dt, A, B, C as numpy, with the reference sweep's scales; x, dt,
    B and C rounded to ``np_dtype`` (A stays float32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bb, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((bb, s, h))))   # softplus
    A = -np.exp(rng.standard_normal(h) * 0.5)
    B = rng.standard_normal((bb, s, g, n)) * 0.3
    C = rng.standard_normal((bb, s, g, n)) * 0.3
    cast = lambda a: a.astype(np.float32).astype(np_dtype)
    return cast(x), cast(dt), A.astype(np.float32), cast(B), cast(C)


def _torch(a, t_dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(t_dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("bb,s,h,p,g,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_plain_vs_pallas(bb, s, h, p, g, n, chunk, dtype):
    np_dt, t_dt, j_dt = DTYPES[dtype]
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np_dt)
    y_j = pallas_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          chunk=chunk, interpret=True)
    y_t = ops.ssd(_torch(x, t_dt), _torch(dt, t_dt), _torch(A, torch.float32),
                  _torch(B, t_dt), _torch(C, t_dt), chunk=chunk)
    assert y_t.dtype == t_dt and y_t.shape == (bb, s, h, p)
    np.testing.assert_allclose(_f32(y_t), _f32(np.asarray(y_j, np.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("bb,s,h,p,g,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_plain_vs_recurrence(bb, s, h, p, g, n, chunk, dtype):
    """y and the final state of the port's chunked and per-step versions
    against the reference's per-step recurrence (in float32, as the
    reference sweep runs it)."""
    np_dt, t_dt, _ = DTYPES[dtype]
    x, dt, A, B, C = (np.asarray(a, np.float32)
                      for a in _inputs(bb, s, h, p, g, n, np_dt))
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    y_j, st_j = jax_ref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C,
                                                           D)))
    args = [_torch(a, torch.float32) for a in (x, dt, A, B, C, D)]
    for name, (y_t, st_t) in {
            "chunked": ref.ssd_chunked_ref(*args, chunk=chunk),
            "per-step": ref.ssd_ref(*args)}.items():
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   rtol=TOL["float32"], atol=TOL["float32"],
                                   err_msg=name)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j),
                                   rtol=TOL["float32"], atol=TOL["float32"],
                                   err_msg=name)


def test_ssd_chunk_invariance():
    """The chunk length does not change the result."""
    x, dt, A, B, C = (_torch(a, torch.float32) for a in
                      _inputs(1, 64, 2, 8, 1, 8, np.float32, seed=3))
    outs = [ops.ssd(x, dt, A, B, C, chunk=c) for c in (8, 16, 32, 64, 1000)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_ragged_sequence_raises():
    """S must be a multiple of the chunk, once the chunk is cut to S."""
    x, dt, A, B, C = (_torch(a, torch.float32) for a in
                      _inputs(1, 24, 2, 8, 1, 8, np.float32))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_chunked_ref(x, dt, A, B, C, chunk=16)
    assert ops.ssd(x, dt, A, B, C, chunk=128).shape == x.shape   # chunk = S


def test_ssd_cpu_tensors_launch_no_kernel():
    """On CPU tensors ops.ssd takes the plain version: no launch counted."""
    x, dt, A, B, C = (_torch(a, torch.float32) for a in
                      _inputs(1, 16, 2, 8, 1, 8, np.float32))
    before = port_ssd.launches
    ops.ssd(x, dt, A, B, C, chunk=8)
    assert port_ssd.launches == before == 0


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches only on CUDA tensors; it never falls back."""
    x, dt, A, B, C = (_torch(a, torch.float32) for a in
                      _inputs(1, 16, 2, 8, 1, 8, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        port_ssd.ssd_scan(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        ops.ssd(x, dt, A.to("meta"), B, C, chunk=8)


@pytest.mark.parametrize("chunk,p,n,fits", [
    (128, 64, 64, True),     # Zamba2-7B
    (128, 64, 128, True),    # Mamba2 widths
    (8, 8, 16, True),        # reduced configs
    (256, 64, 64, False),    # Q * P over two 4x4 tiles a thread
    (128, 64, 256, False),   # over one block's shared memory
])
def test_ssd_kernel_limits(chunk, p, n, fits):
    """What the wrapper lets through fits one block of the kernel: its
    shared memory and its two y tiles a thread."""
    assert port_ssd.kernel_fits(chunk, p, n) == fits


# ---------------------------------------------------------------------------
# The bf16 kernels' three-stage split, transcribed in float64
# ---------------------------------------------------------------------------
def _split_ssd_f64(x, dt, A, B, C, chunk, return_state=False):
    """The algebra of ``csrc/ssd_scan.cu``'s bf16 path, in float64 numpy:
    chunk rows padded to a multiple of 16 with dt = x = B = C = 0, then
    (1) chunk state S_c = (x o w)^T B, w_j = exp(L_Q - L_j) dt_j, for
    every chunk but the last (every chunk with ``return_state``); (2)
    state passing, state_{c+1} = exp(L_Q,c) state_c + S_c from a zero
    state, one step more with ``return_state``: the final state; (3)
    chunk scan, y = M x + exp(L_i) C state^T with M = (C B^T)
    exp(L_i - L_j) dt_j where j <= i and 0 elsewhere, the exponent set to
    0 above the diagonal before the exp."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    bb, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, qp = s // chunk, -(-chunk // 16) * 16
    pad = ((0, 0), (0, 0), (0, qp - chunk))

    def chunks(a):   # (Bb, S, K, ...) -> (Bb, nc, qp, K, ...), zero rows
        a = a.reshape(bb, nc, chunk, *a.shape[2:])
        return np.pad(a, pad + ((0, 0),) * (a.ndim - 3))

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    y = np.zeros((bb, nc, qp, h, p))
    final = np.zeros((bb, h, p, n))
    causal = np.tril(np.ones((qp, qp), bool))
    for hh in range(h):
        gg = hh * g // h
        lc = np.cumsum(dtc[..., hh] * A[hh], axis=2)          # (Bb, nc, qp)
        lq = lc[..., -1]                                      # padded: L_Q
        state = np.zeros((bb, p, n))
        for c in range(nc):
            xq, dq = xc[:, c, :, hh], dtc[:, c, :, hh]  # (Bb,qp,P), (Bb,qp)
            bq, cq, lcq = bc[:, c, :, gg], cc[:, c, :, gg], lc[:, c]
            dec = np.where(causal, lcq[:, :, None] - lcq[:, None, :], 0.0)
            m = np.where(causal, np.einsum("bin,bjn->bij", cq, bq)
                         * np.exp(dec) * dq[:, None, :], 0.0)
            y[:, c, :, hh] = (np.einsum("bij,bjp->bip", m, xq)
                              + np.exp(lcq)[..., None]
                              * np.einsum("bin,bpn->bip", cq, state))
            if c < nc - 1 or return_state:
                w = np.exp(lq[:, c, None] - lcq) * dq
                s_c = np.einsum("bjp,bjn->bpn", xq * w[..., None], bq)
                state = np.exp(lq[:, c])[:, None, None] * state + s_c
        final[:, hh] = state
    y = y[:, :, :chunk].reshape(bb, s, h, p)
    return (y, final) if return_state else y


SPLIT_CASES = {
    # bb, s, h, p, g, n, chunk: the served head shapes cut to S = 256
    "zamba2": (1, 256, 2, 64, 1, 64, 128),
    "mamba2": (1, 256, 2, 64, 1, 128, 128),
    "groups4_chunk64": (1, 256, 4, 64, 4, 64, 64),
    # the reduced configs: chunk 8 padded to 16 rows
    "reduced_chunk8": (2, 32, 4, 8, 2, 16, 8),
}


def _recurrence_f64(x, dt, A, B, C):
    """y of the per-step recurrence, state = exp(dt A) state + dt x B^T,
    y = state C, in float64 numpy: independent of any chunking."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    bb, s, h, p = x.shape
    g = B.shape[2]
    y = np.zeros_like(x)
    for hh in range(h):
        gg = hh * g // h
        state = np.zeros((bb, p, B.shape[3]))
        for t in range(s):
            d = dt[:, t, hh, None, None]
            state = (np.exp(d * A[hh]) * state
                     + d * x[:, t, hh, :, None] * B[:, t, gg, None, :])
            y[:, t, hh] = np.einsum("bpn,bn->bp", state, C[:, t, gg])
    return y


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_ssd_split_f64_vs_pallas_and_chunked(case):
    """The three-stage split the bf16 kernels implement computes the
    Pallas kernel's function: held against the Pallas kernel (interpret)
    and the port's chunked version at 1e-6.  Both compute in float32, and
    at the sweep's decays (|L| up to ~200 over a chunk) their own rounding
    of L moves exp(L_i - L_j) by ~1e-5; so here dt is scaled by 1/100
    (|L_Q| of a few), where float32 holds the function to ~1e-7."""
    bb, s, h, p, g, n, chunk = SPLIT_CASES[case]
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np.float32, seed=11)
    dt = (dt * 0.01).astype(np.float32)
    y = _split_ssd_f64(x, dt, A, B, C, chunk)
    y_j = pallas_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          chunk=chunk, interpret=True)
    y_t = ref.ssd_chunked_ref(*(_torch(a, torch.float32)
                                for a in (x, dt, A, B, C)), chunk=chunk)[0]
    np.testing.assert_allclose(np.asarray(y_j), y, rtol=1e-6, atol=1e-6,
                               err_msg="pallas")
    np.testing.assert_allclose(y_t.numpy(), y, rtol=1e-6, atol=1e-6,
                               err_msg="chunked")


# float32 rounds L in [128, 256) to a step of 2^-16 and its cumsum over a
# chunk to a few such steps: exp(L_i - L_j) is off by ~3e-5 relative, and
# y by about that times |y| (here <= ~15).  1e-4 leaves a factor of ~4
# over what the cases read (<= 2.8e-5); a mask or decay error is O(1).
SWEEP_DECAY_TOL = 1e-4


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_ssd_split_f64_vs_pallas_at_sweep_decays(case):
    """At the sweep's own decays (|L| up to ~230 over a chunk) the split
    matches the Pallas kernel (interpret) and the port's chunked version
    within float32's rounding of L."""
    bb, s, h, p, g, n, chunk = SPLIT_CASES[case]
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np.float32, seed=11)
    y = _split_ssd_f64(x, dt, A, B, C, chunk)
    y_j = pallas_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                          chunk=chunk, interpret=True)
    y_t = ref.ssd_chunked_ref(*(_torch(a, torch.float32)
                                for a in (x, dt, A, B, C)), chunk=chunk)[0]
    tol = SWEEP_DECAY_TOL
    np.testing.assert_allclose(np.asarray(y_j), y, rtol=tol, atol=tol,
                               err_msg="pallas")
    np.testing.assert_allclose(y_t.numpy(), y, rtol=tol, atol=tol,
                               err_msg="chunked")


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_ssd_split_f64_vs_recurrence_f64(case):
    """At the sweep's own decays the split, chunk padding and state
    passing included, is the per-step recurrence: both in float64."""
    bb, s, h, p, g, n, chunk = SPLIT_CASES[case]
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np.float32, seed=11)
    np.testing.assert_allclose(_split_ssd_f64(x, dt, A, B, C, chunk),
                               _recurrence_f64(x, dt, A, B, C), rtol=1e-9,
                               atol=1e-9)


def _recurrence_state_f64(x, dt, A, B, C):
    """The per-step recurrence's state after the last step, (Bb, H, P, N),
    in float64 numpy."""
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    bb, s, h, p = x.shape
    g = B.shape[2]
    state = np.zeros((bb, h, p, B.shape[3]))
    for hh in range(h):
        gg = hh * g // h
        for t in range(s):
            d = dt[:, t, hh, None, None]
            state[:, hh] = (np.exp(d * A[hh]) * state[:, hh]
                            + d * x[:, t, hh, :, None] * B[:, t, gg, None, :])
    return state


# the served head shapes, one chunk (the state pass's one step), and a
# chunk of 12 (padded to 16 rows)
FINAL_STATE_CASES = dict(SPLIT_CASES, one_chunk=(2, 64, 2, 16, 1, 32, 64),
                         chunk12=(1, 36, 2, 8, 1, 16, 12))


@pytest.mark.parametrize("case", sorted(FINAL_STATE_CASES))
def test_ssd_split_f64_final_state_vs_recurrence_f64(case):
    """The final state as the bf16 kernels make it (chunk state over every
    chunk, the last step of the state passing written out) is the
    per-step recurrence's state, both in float64; y is unchanged."""
    bb, s, h, p, g, n, chunk = FINAL_STATE_CASES[case]
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np.float32, seed=11)
    y, state = _split_ssd_f64(x, dt, A, B, C, chunk, return_state=True)
    np.testing.assert_array_equal(y, _split_ssd_f64(x, dt, A, B, C, chunk))
    np.testing.assert_allclose(state, _recurrence_state_f64(x, dt, A, B, C),
                               rtol=1e-9, atol=1e-9)


def test_ssd_split_masks_before_the_exp():
    """Above the diagonal L_i - L_j > 0 and can overflow exp: the split
    sets the exponent to 0 there before the exp, so a steep decay gives
    finite outputs that match the per-step recurrence."""
    bb, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 16, 32
    x, dt, A, B, C = _inputs(bb, s, h, p, g, n, np.float32, seed=5)
    A = (A * 200.0).astype(np.float32)    # |L| over a chunk ~ 1e4
    with np.errstate(over="raise"):
        y = _split_ssd_f64(x, dt, A, B, C, chunk)
    y_r, _ = ref.ssd_ref(*(_torch(a, torch.float32)
                           for a in (x, dt, A, B, C)))
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y_r.numpy(), y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk,p,n,fits,smem", [
    (128, 64, 64, True, 56320),      # Zamba2-7B
    (128, 64, 128, True, 89088),    # Mamba2 widths
    (8, 8, 16, True, 3200),          # reduced configs
    (256, 64, 64, True, 112640),     # a chunk the fp32 kernel cannot hold
    (512, 64, 128, False, 290816),   # over one block's 227 KB
    (128, 64, 256, False, 154624),   # N over eight k16 steps
])
def test_ssd_bf16_kernel_limits(chunk, p, n, fits, smem):
    """The bf16 (tensor-core) kernels' shared memory and what they run;
    float32 keeps the FMA kernel's limits."""
    assert port_ssd.smem_bytes(chunk, p, n, torch.bfloat16) == smem
    assert port_ssd.kernel_fits(chunk, p, n, torch.bfloat16) == fits
    assert port_ssd.kernel_fits(chunk, p, n) == port_ssd.kernel_fits(
        chunk, p, n, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_wrapper_refuses_cpu_tensors_any_dtype(dtype):
    """bf16 (tensor cores) and fp32 (FMA) alike: CPU tensors raise."""
    x, dt, A, B, C = _inputs(1, 256, 2, 64, 1, 64, np.float32)
    args = (_torch(x, dtype), _torch(dt, torch.float32),
            _torch(A, torch.float32), _torch(B, dtype), _torch(C, dtype))
    with pytest.raises(ValueError, match="CUDA"):
        port_ssd.ssd_scan(*args, chunk=128)
    assert port_ssd.launches == 0
