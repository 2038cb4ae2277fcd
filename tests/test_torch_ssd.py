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
