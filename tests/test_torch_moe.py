"""The port's grouped matmul and MoE layer against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
plain ``moe_gmm`` is held against the Pallas kernel in interpret mode
(block ids) and against ``repro.kernels.ref.moe_gmm_ref`` (group sizes):
float32 1e-5, where only the order of sums differs, and bfloat16 2e-2, one
rounding of the bf16 output (the tolerances of the reference's own gmm
sweep).  The MoE layer runs in float32 on converted parameters: the
routing must pick the same experts, token for token, before the outputs
are compared at 1e-4.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jax_ref
from repro.kernels.moe_gmm import moe_gmm as pallas_moe_gmm
from repro.models import moe as jax_moe
from repro.models.common import ExecConfig as JaxExecConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.kernels import moe_gmm as port_gmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.launch import gmm_variants
from repro_torch.models import moe as port_moe

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run PyTorch's CPU ops on one thread: the suite runs in parallel
    workers, and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _gmm_inputs(counts, bt, k, n, np_dt, seed=0):
    """x (T, K), w (E, K, N) and the block ids of ``counts[e]`` blocks of
    ``bt`` rows for expert e, in expert order (zero counts: empty
    experts)."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(counts) * bt
    t = int(sizes.sum())
    x = rng.standard_normal((t, k)).astype(np.float32).astype(np_dt)
    w = (0.1 * rng.standard_normal((len(counts), k, n))).astype(
        np.float32).astype(np_dt)
    gids = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    return x, w, gids, sizes


GMM_CASES = [
    # counts of row blocks per expert, block_t
    ([2, 1, 3], 8),
    ([0, 2, 0, 1], 8),        # empty experts first and between
    ([1, 0, 0, 2, 0], 32),    # and last
    ([3], 32),
    ([1, 1, 1, 1, 1, 1, 0, 1], 8),
    # the row tiles of the wgmma kernel (bf16 on the card)
    ([1, 0, 2], 128),
    ([0, 3, 1, 0], 128),      # one expert owning consecutive blocks
    ([2, 0, 0, 3, 1], 64),
    ([0, 1, 4], 64),
]


def _gmm_dims(bt):
    """(K, N, Pallas block_k, block_n) of a GMM_CASES entry: 64 x 96 at the
    small row tiles; at 64 and 128, K 200 and N 328, past a 64-deep K step
    and a 256-wide column tile of the wgmma kernel.  The Pallas blocks
    divide K and N and keep the interpret-mode grid small."""
    return (64, 96, 32, 32) if bt <= 32 else (200, 328, 40, 164)


@pytest.mark.parametrize("counts,bt", GMM_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_plain_vs_pallas_and_ref(counts, bt, dtype):
    np_dt, t_dt, j_dt = DTYPES[dtype]
    k, n, block_k, block_n = _gmm_dims(bt)
    x, w, gids, sizes = _gmm_inputs(counts, bt, k, n, np_dt)
    o_pl = pallas_moe_gmm(jnp.asarray(x, j_dt), jnp.asarray(w, j_dt),
                          jnp.asarray(gids), block_t=bt, block_n=block_n,
                          block_k=block_k, interpret=True)
    o_ref = jax_ref.moe_gmm_ref(jnp.asarray(x, j_dt), jnp.asarray(w, j_dt),
                                sizes)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(t_dt)
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(t_dt)
    o_t = ops.moe_gmm(xt, wt, torch.from_numpy(gids), block_t=bt)
    assert o_t.dtype == t_dt and o_t.shape == (x.shape[0], w.shape[2])
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(o_t), np.asarray(o_pl, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(o_t), np.asarray(o_ref, np.float32),
                               rtol=tol, atol=tol)
    # the port's group-sizes oracle is the reference's
    np.testing.assert_allclose(_f32(port_ref.moe_gmm_ref(xt, wt, sizes)),
                               np.asarray(o_ref, np.float32), rtol=tol,
                               atol=tol)


def test_gmm_ref_zeros_past_the_groups():
    """Rows beyond sum(group_sizes) are zeros in both oracles."""
    x, w, _, _ = _gmm_inputs([2, 1], 8, 16, 24, np.float32, seed=3)
    sizes = [8, 8]                    # 24 rows, 16 in groups
    o_j = jax_ref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w), sizes)
    o_t = port_ref.moe_gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                               sizes)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    assert not o_t[16:].any()


@pytest.mark.parametrize("bad,match", [
    (dict(block_t=24), "block_t"),
    (dict(block_t=128), "multiple of block_t"),
    (dict(k=12), "multiples of 8"),
    (dict(gid_dtype=torch.int64), "int32"),
    (dict(w_dtype=torch.bfloat16), "one dtype"),
])
def test_gmm_refuses_what_the_kernel_does_not_take(bad, match):
    """The CPU path checks the kernel's contract too, so a call that runs
    here runs on the card."""
    k = bad.get("k", 16)
    x = torch.randn(16, k)
    w = torch.randn(2, k, 8, dtype=bad.get("w_dtype", torch.float32))
    gids = torch.tensor([0, 1], dtype=bad.get("gid_dtype", torch.int32))
    with pytest.raises((ValueError, TypeError), match=match):
        ops.moe_gmm(x, w, gids, block_t=bad.get("block_t", 8))


@pytest.mark.parametrize("dtype,bt,kernel", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "decode"), (torch.bfloat16, 16, "decode"),
    (torch.bfloat16, 8, "decode"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 32, "fma"), (torch.float32, 16, "fma"),
    (torch.float32, 8, "fma"),
])
def test_gmm_kernel_for_each_call(dtype, bt, kernel):
    """bf16 prefill tiles reach wgmma + TMA, bf16 decode tiles the
    persistent TMA-fed decode kernel, float32 the FMA kernel; the code
    passed for it is the C entry's."""
    assert port_gmm.kernel_for(dtype, bt) == kernel
    assert kernel in port_gmm.KERNEL_CODES


@pytest.mark.parametrize("dtype,bt,err", [
    (torch.float16, 128, TypeError), (torch.bfloat16, 24, ValueError),
])
def test_gmm_kernel_for_refuses_the_rest(dtype, bt, err):
    with pytest.raises(err):
        port_gmm.kernel_for(dtype, bt)


def test_gmm_kernel_codes_match_the_c_entry():
    """The wrapper's kernel codes are the enum the C entry switches on."""
    src = (pathlib.Path(port_gmm.__file__).parents[1] / "csrc"
           / "moe_gmm.cu").read_text()
    enum = re.search(r"enum Kernel : int \{([^}]*)\}", src).group(1)
    codes = {name.lower(): int(v) for name, v in
             re.findall(r"k(\w+) = (\d+)", enum)}
    assert codes == port_gmm.KERNEL_CODES


@pytest.mark.parametrize("name", sorted(
    {**gmm_variants.VARIANTS, **gmm_variants.DECODE_VARIANTS}))
def test_gmm_variants_patch_the_kernel_source(name):
    """Each timed variant of the wgmma kernel (and, with ``--decode``, of
    the decode kernel) is the source with its text replaced once (the
    probe refuses a patch that no longer applies)."""
    decode = name in gmm_variants.DECODE_VARIANTS
    patches = (gmm_variants.DECODE_VARIANTS if decode
               else gmm_variants.VARIANTS)[name]
    src = gmm_variants.variant_source(patches)
    assert ("gmm_decode_kernel" if decode else "gmm_wgmma_kernel") in src
    for old, new in patches:
        assert new in src and old not in src


def test_gmm_cpu_launches_no_kernel_and_wrapper_refuses_cpu():
    x, w = torch.randn(16, 16), torch.randn(2, 16, 8)
    gids = torch.tensor([1, 0], dtype=torch.int32)
    before = port_gmm.launches
    ops.moe_gmm(x, w, gids, block_t=8)
    assert port_gmm.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        port_gmm.moe_gmm(x, w, gids, block_t=8)


@pytest.mark.parametrize("arch,tokens,cap,block_t", [
    ("qwen3_moe_235b_a22b", 8 * 1024, 640, 128),   # prefill, batch 8
    ("qwen3_moe_235b_a22b", 8, 8, 8),              # decode, batch 8
    ("mixtral_8x7b", 8 * 1024, 2560, 128),
    ("qwen3_moe_235b_a22b", 2 * 128, 24, 8),       # the card-vs-CPU check
])
def test_capacity_and_row_tile(arch, tokens, cap, block_t):
    m = torch_get_config(arch).moe
    assert port_moe.capacity(tokens, m) == cap
    assert jax_moe._capacity(tokens, get_config(arch).moe) == cap
    assert port_moe.block_t_for(cap) == block_t


def _layer_cfg(name):
    """MoE configs of the layer test: (config, router bias)."""
    m = get_config("qwen3_moe_235b_a22b").reduced().moe
    if name == "reduced":            # 4 experts, top-2
        return m, 0.0
    if name == "16e_top8":           # many experts, top-8, reduced widths
        return dataclasses.replace(m, n_experts=16, top_k=8), 0.0
    # every token prefers expert 0: capacity drops its later choices
    return m, 0.5


@pytest.mark.parametrize("case", ["reduced", "16e_top8", "biased_drops"])
def test_moe_layer_matches_jax(case):
    m, bias = _layer_cfg(case)
    d, b, s = 64, 2, 24
    params = jax_moe.moe_init(jax.random.PRNGKey(5), d, m, jnp.float32)
    np_params = {k: np.array(v) for k, v in params.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    if bias:
        # the test's own inputs: a positive offset on x and a router
        # column of constants give expert 0 a logit of ~bias * d
        x += 1.0
        np_params["router"][:, 0] = bias

    jex = JaxExecConfig(backend="xla")
    y_j, _ = jax.jit(lambda p, v: jax_moe.moe_apply(p, v, m, jex))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    xf = jnp.asarray(x.reshape(b * s, d))
    logits = (xf @ jnp.asarray(np_params["router"])).astype(jnp.float32)
    _, j_ids, _ = jax_moe.router_topk(logits, m)

    layer = port_moe.MoE(d, m, device="cpu", dtype=torch.float32)
    layer.load_state_dict({
        "router.weight": torch.from_numpy(np_params["router"].T.copy()),
        **{n: torch.from_numpy(np_params[n]) for n in ("w1", "w2", "w3")}})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _, t_ids, _, keep, cap, _ = port_moe.route(xt.reshape(b * s, d),
                                                   layer, m)
        y_t, _ = port_moe.moe_apply(layer, xt, m)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert bool((~keep).any()) == (case == "biased_drops"), cap
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
