"""The gradients of the port's rmsnorm, SSD and grouped-matmul ops.

Each op is a ``torch.autograd.Function`` whose backward is the same code
on the CPU and on the card: rmsnorm and the SSD recompute through their
plain versions, the gmm's dx is the gmm over the transposed experts and
its dw a float32 sum per expert.  Here, on CPU tensors, each Function's
gradients are held against autograd straight through the plain version
on the same inputs (tolerance 1e-6 in float32: the same float32
operations, the gmm's summed in another grouping), and
``torch.autograd.gradcheck`` holds each backward against finite
differences of the forward in float64 on tiny shapes (its default
tolerances).  ``chip_smoke.py``'s grad phase makes the same comparison on
the card, where the forwards are the kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.kernels.ref import rmsnorm_ref, ssd_chunked_ref

TOL = 1e-6   # float32, Function vs autograd through the plain version


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)


def _grads(out, inputs, dout):
    outs = out if isinstance(out, tuple) else (out,)
    douts = dout if isinstance(dout, tuple) else (dout,)
    return torch.autograd.grad(outs, inputs, douts)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   rtol=tol, atol=tol)


def _ssd_inputs(rng, bb=2, s=16, h=4, p=8, g=2, n=8,
                dtype=torch.float32):
    x = _t(rng.standard_normal((bb, s, h, p)), dtype)
    dt = _t(np.log1p(np.exp(rng.standard_normal((bb, s, h)))), dtype)
    a = _t(-np.exp(0.5 * rng.standard_normal(h)), dtype)
    b = _t(0.5 * rng.standard_normal((bb, s, g, n)), dtype)
    c = _t(0.5 * rng.standard_normal((bb, s, g, n)), dtype)
    return x, dt, a, b, c


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_grads_match_autograd_through_plain(offset):
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((3, 5, 24)))
    w = _t(1.0 + 0.1 * rng.standard_normal(24))
    dy = torch.tensor(rng.standard_normal((3, 5, 24)), dtype=torch.float32)
    y = ops.rmsnorm(x, w, eps=1e-6, weight_offset=offset)
    assert y.grad_fn is not None
    y_p = rmsnorm_ref(x, w, eps=1e-6, weight_offset=offset)
    _close([y], [y_p])
    _close(_grads(y, (x, w), dy), _grads(y_p, (x, w), dy))


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_grads_match_autograd_through_plain(return_state, chunk):
    rng = np.random.default_rng(1)
    ins = _ssd_inputs(rng)
    dy = torch.tensor(rng.standard_normal(ins[0].shape), dtype=torch.float32)
    out = ops.ssd(*ins, chunk=chunk, return_state=return_state)
    y_p, st_p = ssd_chunked_ref(*ins, chunk=chunk)
    if return_state:
        dst = torch.tensor(rng.standard_normal(st_p.shape),
                           dtype=torch.float32)
        assert out[0].grad_fn is not None and out[1].grad_fn is not None
        _close(out, (y_p, st_p))
        _close(_grads(out, ins, (dy, dst)), _grads((y_p, st_p), ins,
                                                   (dy, dst)))
    else:
        assert out.grad_fn is not None
        _close([out], [y_p])
        _close(_grads(out, ins, dy), _grads(y_p, ins, dy))


def test_ssd_state_alone_takes_its_gradient():
    """Only the final state reaches the loss: y's gradient is None, the
    inputs' come from the state alone, and C (which only y reads) gets
    none."""
    rng = np.random.default_rng(2)
    ins = _ssd_inputs(rng)
    _, st = ops.ssd(*ins, chunk=8, return_state=True)
    _, st_p = ssd_chunked_ref(*ins, chunk=8)
    dst = torch.tensor(rng.standard_normal(st.shape), dtype=torch.float32)
    got = torch.autograd.grad(st, ins, dst, allow_unused=True)
    want = torch.autograd.grad(st_p, ins, dst, allow_unused=True)
    assert got[4] is None and want[4] is None
    _close(got[:4], want[:4])


@pytest.mark.parametrize("ids", [[2, 0, 2, 1], [1, 1, 3, 0], [0, 3, 1, 9]],
                         ids=["experts", "expert_without_rows", "bad_id"])
def test_gmm_grads_match_autograd_through_plain(ids):
    """ids outside [0, E) (9 of E=4): the rows are NaN in the output and
    in dx, exactly where the plain version's are, and add to no expert's
    dw; every other row and every dw match."""
    rng = np.random.default_rng(3)
    bt, k, n, e = 8, 16, 24, 4
    gids = torch.tensor(ids, dtype=torch.int32)
    x = _t(rng.standard_normal((len(ids) * bt, k)))
    w = _t(rng.standard_normal((e, k, n)) * k ** -0.5)
    dy = torch.tensor(rng.standard_normal((len(ids) * bt, n)),
                      dtype=torch.float32)
    y = ops.moe_gmm(x, w, gids, block_t=bt)
    assert y.grad_fn is not None
    y_p = moe_gmm_plain(x, w, gids, bt)
    dx, dw = _grads(y, (x, w), dy)
    dx_p, dw_p = _grads(y_p, (x, w), dy)
    bad = np.repeat([not 0 <= i < e for i in ids], bt)
    for got, want in ((y, y_p), (dx, dx_p)):
        got, want = got.detach().numpy(), want.detach().numpy()
        assert (np.isnan(got).all(1) == bad).all()
        assert (np.isnan(want).all(1) == bad).all()
        np.testing.assert_allclose(got[~bad], want[~bad], rtol=TOL,
                                   atol=TOL)
    _close([dw], [dw_p])
    unused = sorted(set(range(e)) - set(ids))
    assert not dw[unused].any()


def test_gmm_grad_of_x_alone():
    """With w frozen the backward computes dx only."""
    rng = np.random.default_rng(4)
    gids = torch.tensor([1, 0], dtype=torch.int32)
    x = _t(rng.standard_normal((16, 8)))
    w = torch.tensor(rng.standard_normal((2, 8, 16)), dtype=torch.float32)
    y = ops.moe_gmm(x, w, gids, block_t=8)
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    (dx_p,) = torch.autograd.grad(moe_gmm_plain(x, w, gids, 8).sum(), (x,))
    _close([dx], [dx_p])


def _f64(rng, shape, scale=1.0, shift=0.0):
    return torch.tensor(shift + scale * rng.standard_normal(shape),
                        dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("op", ["rmsnorm", "ssd", "ssd_state", "gmm"])
def test_gradcheck_float64(op):
    """Each Function's backward against finite differences of its forward
    (the plain version on the CPU, float64 end to end)."""
    rng = np.random.default_rng(5)
    if op == "rmsnorm":
        args = (_f64(rng, (3, 4, 8)), _f64(rng, 8, 0.1, 1.0))

        def fn(x, w):
            return ops._RMSNorm.apply(x, w, 1e-6, 0.5)
    elif op.startswith("ssd"):
        bb, s, h, p, g, n = 1, 8, 2, 4, 1, 4
        args = (_f64(rng, (bb, s, h, p)),
                torch.tensor(np.log1p(np.exp(rng.standard_normal(
                    (bb, s, h)))), dtype=torch.float64, requires_grad=True),
                torch.tensor(-np.exp(0.5 * rng.standard_normal(h)),
                             dtype=torch.float64, requires_grad=True),
                _f64(rng, (bb, s, g, n), 0.5), _f64(rng, (bb, s, g, n), 0.5))

        def fn(*t):
            return ops._SSD.apply(*t, 4, op == "ssd_state")
    else:
        gids = torch.tensor([1, 0, 1], dtype=torch.int32)
        args = (_f64(rng, (24, 8)), _f64(rng, (2, 8, 8), 8 ** -0.5))

        def fn(x, w):
            return ops._MoEGMM.apply(x, w, gids, 8)
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("op", ["rmsnorm", "ssd", "gmm"])
def test_no_grad_fn_without_a_grad_input(op):
    """Without an input that requires a gradient the output has no
    grad_fn, as with any torch op."""
    rng = np.random.default_rng(6)
    if op == "rmsnorm":
        out = ops.rmsnorm(torch.randn(4, 8), torch.ones(8))
    elif op == "ssd":
        out = ops.ssd(*(t.detach() for t in _ssd_inputs(rng)), chunk=8)
    else:
        out = ops.moe_gmm(torch.randn(8, 8), torch.randn(1, 8, 8),
                          torch.zeros(1, dtype=torch.int32), block_t=8)
    assert out.grad_fn is None
