"""The port's sharding rules, plans and meshes against the reference's
(``repro_torch/parallel/``, ``repro_torch/launch/mesh.py``), on the CPU.

``param_specs``: for every parameter of each family's reduced config
(dense, moe, vlm, hybrid, ssm, encdec), the port's spec equals the
reference's mapped through the port's layout: the reference's stacked
layers lose their leading ``None`` (one module per layer) and an
``nn.Linear`` weight, stored (out, in), takes the reference's two entries
swapped.  The reference runs on a stand-in mesh with ``.shape`` and
``.axis_names``, which is all its rules read, so no devices are needed.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import build_model as jax_build_model
from repro.models.common import ExecConfig as JaxExecConfig
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import ExecConfig, build_model
from repro_torch.parallel import sharding

ARCHS = ["tinyllama-1.1b", "mixtral-8x7b", "qwen3-moe-235b-a22b",
         "llava-next-34b", "zamba2-7b", "mamba2-780m", "whisper-medium"]
MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 2},
          {"data": 1, "model": 4}, {"pod": 2, "data": 2, "model": 2}]
STACKED = ("layers", "enc_layers", "dec_layers")


def _stand_in(sizes):
    return SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _mesh_id(sizes):
    return "x".join(f"{a}{n}" for a, n in sizes.items())


def _reference_specs(arch, sizes):
    cfg = jax_get_config(arch).reduced()
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), JaxExecConfig()))
    specs = jax_sharding.param_specs(cfg, shapes, _stand_in(sizes))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", k) for k in path): tuple(spec)
            for path, spec in flat}


def _port_model(arch):
    cfg = get_config(arch).reduced()
    return cfg, build_model(cfg).init(0, ExecConfig(device="cpu"))


def _mapped(ref_specs, port_names):
    """The reference's specs under the port's names and layouts."""
    out = {}
    for path, spec in ref_specs.items():
        if path[0] in STACKED:
            layers = sorted({int(n.split(".")[1]) for n in port_names
                             if n.startswith(path[0] + ".")})
            names = [".".join((path[0], str(i)) + path[1:]) for i in layers]
            spec = spec[1:]
        else:
            names = [".".join(path)]
        for name in names:
            if name + ".weight" in port_names:   # an nn.Linear: (out, in)
                out[name + ".weight"] = spec[::-1]
            else:
                out[name] = spec
    return out


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, sizes):
    cfg, model = _port_model(arch)
    port = sharding.param_specs(cfg, model, sizes)
    want = _mapped(_reference_specs(arch.replace("-", "_").replace(
        ".", "_"), sizes), set(port))
    assert set(port) == set(want)
    bad = {n: (port[n], want[n]) for n in port if port[n] != want[n]}
    assert not bad, bad
    # the mesh's model axis shards something wherever it is > 1
    if sizes["model"] > 1:
        assert any("model" in s for s in port.values())


def test_sanitize_drops_what_does_not_divide():
    mesh = {"data": 2, "model": 2}
    assert sharding._sanitize(("model", "data"), (51865, 64), mesh) == \
        (None, "data")
    assert sharding._sanitize((("pod", "data"),), (8, 3),
                              {"pod": 2, "data": 2, "model": 1}) == \
        (("pod", "data"), None)


def test_whisper_vocab_stays_replicated_on_model():
    cfg = get_config("whisper-medium")
    spec = sharding.param_spec(cfg, "embed", (cfg.vocab, cfg.d_model),
                               {"data": 16, "model": 16})
    assert cfg.vocab == 51865 and spec == (None, "data")


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_match_reference(sizes, kind):
    cfg = get_config("llava-next-34b")
    port = sharding.batch_specs(cfg, ShapeConfig("s", kind, 64, 8), sizes)
    ref = jax_sharding.batch_specs(
        jax_get_config("llava_next_34b"), JaxShapeConfig("s", kind, 64, 8),
        _stand_in(sizes))
    for key in ("tokens", "labels", "loss_mask", "prefix_embeds",
                "encoder_embeds", "pos"):
        assert port(key) == tuple(ref(key)), key
    with pytest.raises(KeyError):
        port("nope")


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "mamba2-780m", "whisper-medium"])
def test_cache_specs_match_reference(arch, sizes, batch):
    """Each cache entry's spec, on the port's cache and the reference's
    (the same names and layouts), decode at batch 16 (batch-sharded) and
    a long context at batch 1 (sequence-sharded)."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch.replace("-", "_").replace(".", "_"))
    seq = 64
    cache = _cache(cfg, batch, seq)
    rule = sharding.cache_specs(cfg, ShapeConfig("d", "decode", seq, batch),
                                sizes)
    jrule = jax_sharding.cache_specs(
        jcfg, JaxShapeConfig("d", "decode", seq, batch), _stand_in(sizes))
    for name, shape in cache.items():
        leaf = SimpleNamespace(shape=shape)
        want = tuple(jrule((SimpleNamespace(key=name),), leaf))
        assert rule(name, shape) == want, name


def _cache(cfg, batch, seq):
    """The port's cache entry shapes, without allocating them."""
    from repro_torch.models.api import _FAMILIES
    with torch.device("meta"):
        cache = _FAMILIES[cfg.family][1](cfg, batch, seq, torch.float32,
                                         torch.device("meta"))
    return {k: tuple(v.shape) for k, v in cache.items()}


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert sharding.placements(("model", ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    assert sharding.placements((None, None), mesh) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"),), mesh)


def test_local_slice_is_the_mixed_radix_block():
    t = torch.arange(8 * 6).reshape(8, 6)
    mesh = {"pod": 2, "data": 2, "model": 3}
    got = sharding.local_slice(t, (("pod", "data"), "model"), mesh,
                               {"pod": 1, "data": 0, "model": 2})
    assert torch.equal(got, t[4:6, 4:6])


def _design_points(core, workload_mod, mcm_mod, configs, **kw):
    cfg = configs.get_config("tinyllama_1_1b")
    w = workload_mod.Workload(cfg, seq_len=4096, global_batch=256)
    mcm = mcm_mod.mcm_from_compute(1e6, 4, 2)
    best, evaluated = core.inner_search(w, mcm, budget=8, **kw)
    return [best] + evaluated[:6]


def test_plan_from_design_matches_reference():
    import repro.configs as jconfigs
    import repro.core.mcm as jmcm
    import repro.core.optimizer as jopt
    import repro.core.workload as jwork
    import repro.parallel.plan as jplan
    import repro_torch.configs as tconfigs
    import repro_torch.core.mcm as tmcm
    import repro_torch.core.optimizer as topt
    import repro_torch.core.workload as twork
    from repro_torch.parallel import plan as tplan
    want = [jplan.plan_from_design(p)
            for p in _design_points(jopt, jwork, jmcm, jconfigs)]
    got = [tplan.plan_from_design(p)
           for p in _design_points(topt, twork, tmcm, tconfigs,
                                   device="cpu")]
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert vars(g) == vars(w)
        assert g.mesh_shape() == w.mesh_shape()
        assert g.mesh_shape(pod=2) == w.mesh_shape(pod=2)
        assert vars(g.strategy) == vars(w.strategy)


@pytest.fixture
def one_rank_group(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_on_one_rank(one_rank_group):
    mesh = port_mesh.make_mesh_from_plan(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert port_mesh.fsdp_axes(mesh) == ("data",)
    assert port_mesh.model_axis(mesh) == "model"
    with pytest.raises(RuntimeError,
                       match=r"mesh \(16, 16\) needs 256 devices, have 1"):
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        port_mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 8 devices"):
        port_mesh.make_mesh_from_plan(2, 2, pod=2, device="cpu")
