"""The port's spec engine (``repro_torch.distributed.sharding``,
``optim.optimizers.opt_state_specs``, ``Model``'s spec methods and
``launch/mesh.py``) against the JAX package's.

Every case of tests/test_sharding.py runs on the port; then the port's
param and optimizer-state specs equal JAX's leaf by leaf for every arch
of the registry on the meshes 16x16, 2x16x16, 4x2 and 2x2 under every
policy, and ``resolve_batch`` picks the same axes. Both packages read
the same duck-typed ``FakeMesh`` (axis names and sizes only). Specs are
compared exactly, as tuples of entries (jax 0.9's ``P`` normalises a
singleton tuple to the name; the port's does too).

The layout itself: in a subprocess with 8 host devices, JAX's
``NamedSharding.devices_indices_map`` for every leaf of stablelm and
mamba2 at smoke size on the meshes 4x2 and 2x2x2 gives each device the
index ranges that the port's ``shard_slices`` gives its mesh
coordinate, including the leaves whose dim takes ``("pod", "data")``."""
import json

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist as JaxDist
from repro.models.model import make_model as jax_make_model
from repro.optim.optimizers import OptConfig as JaxOpt
from repro.optim.optimizers import opt_state_specs as jax_opt_specs
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.distributed.sharding import (Dist, P, dim_shardable,
                                              placements, shard_slices,
                                              spec_for)
from repro_torch.models import make_model
from repro_torch.models.layers import ParamDef, iter_leaves
from repro_torch.optim.optimizers import OptConfig, opt_state_specs
from util_subproc import run_with_devices


class FakeMesh:
    """Duck-typed mesh: only axis_names + shape are consulted by the
    spec engine (tests/test_sharding.py's)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "2x2": {"data": 2, "model": 2}}
POLICIES = ("dp_only", "tp_dp", "fsdp_tp", "zero3_sp")
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")


def dist(policy="fsdp_tp", pod=False):
    shape = {"pod": 2, "data": 16, "model": 16} if pod else \
        {"data": 16, "model": 16}
    return Dist(mesh=FakeMesh(shape), policy=policy)


# ---- the cases of tests/test_sharding.py, on the port ----------------------

def test_tp_dims_take_model_axis():
    d = dist()
    assert spec_for(d, ("embed", "ff"), (1024, 4096)) == \
        P(("data",), "model")
    assert spec_for(d, ("vocab", "embed"), (163840, 7168)) == \
        P("model", ("data",))


def test_indivisible_dims_fall_back_to_replicated():
    d = dist()
    assert spec_for(d, ("embed", "heads", "hd"), (1280, 20, 64)) == \
        P(("data",), None, None)
    assert spec_for(d, ("vocab", "embed"), (51866, 1280)) == \
        P(None, ("data",))
    assert not dim_shardable(d, 51866, "vocab")
    assert dim_shardable(d, 49152, "vocab")


def test_policies():
    assert spec_for(dist("dp_only"), ("embed", "ff"), (1024, 4096)) == \
        P(None, None)
    assert spec_for(dist("tp_dp"), ("embed", "ff"), (1024, 4096)) == \
        P(None, "model")
    assert spec_for(dist("fsdp_tp", pod=True), ("embed", "ff"),
                    (1024, 4096)) == P(("pod", "data"), "model")


def test_axis_used_once_per_spec():
    assert spec_for(dist(), ("embed", "eff"), (1024, 2048)) == \
        P(("data",), None)


def test_batch_resolution():
    d = dist(pod=True)
    assert d.resolve_batch(256).batch_axes == ("pod", "data")
    assert d.resolve_batch(16).batch_axes == ("data",)
    assert d.resolve_batch(1).batch_axes is None


def test_adafactor_state_specs_follow_factoring():
    d = dist()
    defs = {"w": ParamDef((1024, 4096), ("embed", "ff")),
            "b": ParamDef((4096,), ("ff",))}
    specs = opt_state_specs(OptConfig(name="adafactor"), defs, d)
    assert specs["vr"]["w"] == P(("data",))
    assert specs["vc"]["w"] == P("model")
    assert specs["vc"]["b"] == P()
    specs = opt_state_specs(OptConfig(name="adamw"), defs, d)
    assert specs["m"]["w"] == P(("data",), "model")


def test_model_param_specs_cover_tree():
    specs = make_model(get_arch("kimi-k2-1t-a32b"), dist()).param_specs()
    assert all(isinstance(s, P) for _, s in iter_leaves(specs))
    assert specs["blocks"]["moe"]["wg"][1] == "model"


def test_partition_spec_normalises_as_jax():
    for parts in [(("x",),), (("a", "b"), None), ((), "y"), (None,), ()]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts
    assert P(("x",)) == P("x")


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert placements(P(("pod", "data"), "model"), names) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), names) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), names)


def test_shard_slices_major_axis_first():
    axes = {"pod": 2, "data": 4, "model": 2}
    # dim 0 over pod x data: 8 blocks of 2, pod the major index
    sl = shard_slices(P(("pod", "data"), None), (16, 3), axes,
                      {"pod": 1, "data": 2, "model": 0})
    assert sl == (slice(12, 14), slice(0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        shard_slices(P("data"), (6,), axes, {"pod": 0, "data": 0,
                                             "model": 0})


def test_mesh_module_touches_no_process_group():
    import torch.distributed as tdist
    import repro_torch.launch.mesh as mesh_mod
    assert callable(mesh_mod.make_mesh)
    assert not tdist.is_initialized()


# ---- every arch, mesh and policy against JAX ------------------------------

def _jax_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in leaves}


def _port_specs(tree):
    return {path: tuple(s) for path, s in iter_leaves(tree)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, mesh):
    """Params and the state of every optimizer, every policy."""
    fm = FakeMesh(MESHES[mesh])
    for policy in POLICIES:
        jd = JaxDist(mesh=fm, policy=policy)
        pd = Dist(mesh=fm, policy=policy)
        jm = jax_make_model(jax_get_arch(arch), jd)
        pm = make_model(get_arch(arch), pd)
        want = _jax_specs(jm.param_specs())
        assert _port_specs(pm.param_specs()) == want, policy
        for name in OPTIMIZERS:
            got = opt_state_specs(OptConfig(name=name), pm.param_defs(), pd)
            ref = jax_opt_specs(JaxOpt(name=name), jm.param_defs(), jd)
            assert _port_specs(got) == _jax_specs(ref), (policy, name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_batch_equals_jax(mesh):
    fm = FakeMesh(MESHES[mesh])
    for B in (1, 2, 4, 16, 256):
        j = JaxDist(mesh=fm).resolve_batch(B)
        p = Dist(mesh=fm).resolve_batch(B)
        assert p.batch_axes == j.batch_axes, B
        assert p.batch_axes_resolved == j.batch_axes_resolved, B
        assert (p.data_size, p.model_size) == (j.data_size, j.model_size)
        assert (p.fsdp_axes, p.tp_axis, p.expert_axis, p.seq_parallel) \
            == (j.fsdp_axes, j.tp_axis, j.expert_axis, j.seq_parallel)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b",
                                  "qwen2-vl-2b", "whisper-large-v3",
                                  "jamba-1.5-large-398b"])
def test_input_and_cache_specs_equal_jax(arch):
    """``input_sharding_specs`` and ``cache_sharding_specs`` (the port's
    per-slot ``pos`` aside: it takes the batch axes, the reference's
    scalar ``P()``)."""
    for mesh in ("4x2", "2x16x16"):
        fm = FakeMesh(MESHES[mesh])
        for B in (16, 1):
            jd = JaxDist(mesh=fm).resolve_batch(B)
            pd = Dist(mesh=fm).resolve_batch(B)
            jm = jax_make_model(jax_reduce(jax_get_arch(arch)), jd)
            pm = make_model(reduce_for_smoke(get_arch(arch)), pd)
            for kind in ("train", "prefill", "decode"):
                js = jm.input_sharding_specs(JaxShapeSpec("x", 64, B, kind))
                ps = pm.input_sharding_specs(ShapeSpec("x", 64, B, kind))
                assert {k: tuple(v) for k, v in ps.items()} == \
                    {k: tuple(v) for k, v in js.items()}, (mesh, B, kind)
            jc = {k: tuple(v) for k, v in jm.cache_sharding_specs(B).items()}
            pc = {k: tuple(v) for k, v in pm.cache_sharding_specs(B).items()}
            assert pc.pop("pos") == tuple(P(pd.batch_axes))
            jc.pop("pos")
            assert pc == jc, (mesh, B)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b"])
def test_abstract_opt_state_equals_jax(arch):
    """``abstract_opt_state``: meta tensors of the shapes and dtypes of
    JAX's ``eval_shape`` of the state, every optimizer (Adafactor's
    factored stats at ``min_dim_factored`` 32 for the smoke model)."""
    import jax.numpy as jnp
    from repro.optim.optimizers import abstract_opt_state as jax_abstract
    from repro_torch.optim.optimizers import abstract_opt_state
    jm = jax_make_model(jax_reduce(jax_get_arch(arch)))
    pm = make_model(reduce_for_smoke(get_arch(arch)))
    for name in OPTIMIZERS:
        kw = dict(name=name, min_dim_factored=32)
        want = jax.tree_util.tree_flatten_with_path(
            jax_abstract(JaxOpt(**kw), jm.abstract_params()))[0]
        want = {"/".join(str(getattr(k, "key", k)) for k in path):
                (tuple(v.shape), str(jnp.dtype(v.dtype))) for path, v in want}
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in iter_leaves(abstract_opt_state(
                   OptConfig(**kw), pm.abstract_params()))}
        assert got == want, name
        assert all(v.device.type == "meta" for _, v in iter_leaves(
            abstract_opt_state(OptConfig(**kw), pm.abstract_params())))


def test_no_mesh_specs_are_empty():
    m = make_model(reduce_for_smoke(get_arch("stablelm-1.6b")))
    assert all(s == P() for _, s in iter_leaves(m.param_specs()))
    assert m.param_shardings() == m.param_specs()
    assert m.cache_shardings(4) is None


# ---- the layout against JAX's own shards (8 host devices) -------------------

_LAYOUT = r"""
import json, numpy as np, jax
from jax.sharding import NamedSharding
from repro.configs.base import reduce_for_smoke
from repro.configs.registry import get_arch
from repro.distributed.sharding import Dist
from repro.launch.mesh import make_mesh
from repro.models.model import make_model
out = {}
for name, (d, m, pod) in {"4x2": (4, 2, 1), "2x2x2": (2, 2, 2)}.items():
    mesh = make_mesh(d, m, pod)
    for arch in ("stablelm-1.6b", "mamba2-1.3b"):
        model = make_model(reduce_for_smoke(get_arch(arch)), Dist(mesh=mesh))
        specs = model.param_specs()
        flat = jax.tree_util.tree_flatten_with_path(
            model.abstract_params())[0]
        sflat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        for (path, leaf), spec in zip(flat, sflat):
            key = "/".join(str(k.key) for k in path)
            idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            rows = []
            for dev, sl in idx.items():
                coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
                rows.append([coord, [list(s.indices(n))[:2]
                                     for s, n in zip(sl, leaf.shape)]])
            out[f"{name}|{arch}|{key}"] = {
                "axes": dict(zip(mesh.axis_names, mesh.devices.shape)),
                "spec": [list(a) if isinstance(a, tuple) else a
                         for a in spec],
                "shape": list(leaf.shape), "rows": rows}
print("JSON" + json.dumps(out))
"""


def test_shard_slices_equal_jax_devices_indices_map():
    out = run_with_devices(_LAYOUT, n=8)
    cases = json.loads(out.split("JSON", 1)[1])
    pod_data = 0
    for key, c in cases.items():
        spec = P(*[tuple(a) if isinstance(a, list) else a
                   for a in c["spec"]])
        pod_data += ("pod", "data") in tuple(spec)
        for coord, ranges in c["rows"]:
            sl = shard_slices(spec, c["shape"], c["axes"],
                              dict(zip(c["axes"], coord)))
            assert [[s.start, s.stop] for s in sl] == ranges, (key, coord)
    assert len(cases) > 40 and pod_data > 5
