"""The port's all-to-all MoE (``repro_torch/parallel/moe_a2a.py``) on
gloo ranks against the reference's ``moe_apply_a2a``, on the CPU.

The reference runs in a subprocess with four host devices
(``--xla_force_host_platform_device_count=4``) on the same numpy inputs:
reduced Mixtral-8x7B's router and experts, x (4, 8, 64) and a fixed
cotangent dy.  Its objective is ``sum(y * dy) + aux`` through
``jax.value_and_grad``; the port's ranks take their tiles and the
gradients of the same objective (``tests/_torch_ranks.py::a2a_case``).
Meshes (data, model): (1, 2), (2, 2) and (1, 4); capacity factor 1.25
(the config's) and 0.5 (choices dropped at both capacities).
Tolerances, float32 with sums in other orders: y and aux
within 1e-5, each gradient within 1e-4, both relative to the largest
element.

At a model axis of 1 the all-to-all is the dense ``moe_apply`` (the
same drops, the same y and aux) where ``cap_exp == capacity()``: the
premise of ``chip_smoke.py``'s Mixtral check.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_ranks import a2a_case, run_ranks
from repro_torch.configs import get_config
from repro_torch.models import moe as port_moe
from repro_torch.parallel import moe_a2a

ARCH = "mixtral-8x7b"
B, S = 4, 8
TOL_Y = 1e-5
TOL_GRAD = 1e-4
ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.common import ExecConfig
from repro.parallel.moe_a2a import moe_apply_a2a

arg = json.loads(sys.argv[1])
cfg = get_config(arg["arch"]).reduced()
m = dataclasses.replace(cfg.moe, capacity_factor=arg["cf"])
a = dict(np.load(arg["inputs"]))
shape = tuple(arg["mesh"])
n = int(np.prod(shape))
mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
params = {k: jnp.asarray(a[k]) for k in ("router", "w1", "w3", "w2")}
dy = jnp.asarray(a["dy"])

def f(x, params):
    y, aux = moe_apply_a2a(params, x, m, ExecConfig(), mesh)
    return jnp.sum(y * dy) + aux, (y, aux)

(_, (y, aux)), (dx, dp) = jax.jit(jax.value_and_grad(
    f, argnums=(0, 1), has_aux=True))(jnp.asarray(a["x"]), params)
np.savez(arg["out"], y=np.asarray(y), aux=np.asarray(aux),
         dx=np.asarray(dx), **{"d" + k: np.asarray(v) for k, v in dp.items()})
"""


def _inputs(path, seed=0):
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    a = {"x": rng.standard_normal((B, S, d)),
         "dy": rng.standard_normal((B, S, d)),
         "router": rng.standard_normal((d, e)) * d ** -0.5,
         "w1": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w3": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w2": rng.standard_normal((e, f, d)) * f ** -0.5}
    np.savez(path, **{k: v.astype(np.float32) for k, v in a.items()})
    return path


def _reference(inputs, mesh, cf, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps({"arch": ARCH, "inputs": str(inputs), "mesh": mesh,
                      "cf": cf, "out": str(out)})
    subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                   check=True, timeout=240, capture_output=True)
    return dict(np.load(out))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max error {err:.3g} of the largest " \
                       f"element, over {tol}"


def _assemble(results, mesh):
    """The ranks' tiles -> the global arrays (x's rows by data rank, the
    experts by model rank)."""
    data, model = mesh
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in results}
    out = {"y": np.concatenate([by[(d, 0)]["y"] for d in range(data)]),
           "dx": np.concatenate([by[(d, 0)]["dx"] for d in range(data)]),
           "drouter": by[(0, 0)]["drouter"], "aux": by[(0, 0)]["aux"]}
    for k in ("dw1", "dw3", "dw2"):
        out[k] = np.concatenate([by[(0, mm)][k] for mm in range(model)])
    # every model rank holds its data shard's y and x's gradient alike,
    # and every rank the same aux and router gradient
    for (d, mm), r in by.items():
        np.testing.assert_array_equal(r["y"], by[(d, 0)]["y"])
        np.testing.assert_array_equal(r["dx"], by[(d, 0)]["dx"])
        np.testing.assert_allclose(r["aux"], out["aux"], rtol=1e-6)
        np.testing.assert_allclose(r["drouter"], out["drouter"], rtol=1e-5,
                                   atol=1e-7)
    return out


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["no_drop", "drop"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a2a_matches_reference(mesh, cf, tmp_path):
    inputs = _inputs(tmp_path / "inputs.npz")
    want = _reference(inputs, list(mesh), cf, tmp_path / "ref.npz")
    results = run_ranks(a2a_case, int(np.prod(mesh)), tmp_path,
                        mesh_shape=mesh, inputs=str(inputs), arch=ARCH,
                        capacity_factor=cf)
    got = _assemble([{k: (v.numpy() if torch.is_tensor(v) else v)
                      for k, v in r.items()} for r in results], mesh)
    _close(got["y"], want["y"], TOL_Y, "y")
    _close(got["aux"], want["aux"], TOL_Y, "aux")
    for k in ("dx", "drouter", "dw1", "dw3", "dw2"):
        _close(got[k], want[k], TOL_GRAD, k)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_one_model_rank_is_the_dense_moe(one_rank_group):
    """At a model axis of 1 and 2 x 32 tokens, top 2, capacity factor
    1.25 over 4 experts, ``cap_exp`` and ``capacity()`` are both 40 rows:
    the all-to-all drops what the dense path drops and gives its y, aux
    and gradients.  The router is skewed so that expert 0 is every
    token's choice and 24 of its 64 choices drop."""
    torch.manual_seed(0)
    cfg = get_config(ARCH).reduced()
    m = cfg.moe
    moe = port_moe.MoE(cfg.d_model, m)
    with torch.no_grad():
        for p in (moe.w1, moe.w3, moe.w2):
            p.normal_(0.0, cfg.d_model ** -0.5)
        moe.router.weight.normal_(0.0, cfg.d_model ** -0.5)
        moe.router.weight[0] += 0.3     # expert 0 takes too many
    x = torch.randn(2, 32, cfg.d_model) + 0.5
    t = x.shape[0] * x.shape[1]
    cap_send = max(8, -(-int(t * m.top_k * m.capacity_factor) // 8) * 8)
    assert -(-cap_send // m.n_experts // 8) * 8 == port_moe.capacity(t, m)
    _, _, _, keep, _, _ = port_moe.route(x.reshape(t, -1), moe, m)
    assert not bool(keep.all()), "no choice dropped: the case tests less"
    outs = {}
    for impl in ("dense", "a2a"):
        xi = x.clone().requires_grad_()
        moe.zero_grad()
        if impl == "dense":
            y, aux = port_moe.moe_apply(moe, xi, m, with_aux=True)
        else:
            y, aux = moe_a2a.moe_apply_a2a(moe, xi, m, None, one_rank_group)
        (torch.sum(y * torch.linspace(-1, 1, y.numel()).view_as(y))
         + aux).backward()
        outs[impl] = {"y": y.detach(), "aux": aux.detach(),
                      "dx": xi.grad, **{n: p.grad.clone() for n, p in
                                        moe.named_parameters()}}
    for k, want in outs["dense"].items():
        torch.testing.assert_close(outs["a2a"][k], want, rtol=1e-6,
                                   atol=1e-7, msg=k)
