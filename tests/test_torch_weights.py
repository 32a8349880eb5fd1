"""The port's flat weight layout against JAX's ``_flat_io``: leaf order,
shapes and offsets, exact round trips, and the two ways of carrying JAX
weights across (flat vector, numpy tree)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.models import make_model as jax_make_model
from repro.runtime.learner import _flat_io
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.models.layers import iter_leaves
from repro_torch.weights import (flat_from_params, flat_layout, flat_size,
                                 params_from_flat, params_from_jax)

DENSE_ARCHS = ["stablelm-1.6b", "granite-20b", "minitron-8b",
               "qwen1.5-110b"]


def _jax_model(arch):
    return jax_make_model(jax_reduce(jax_get_arch(arch)), Dist())


def _jax_layout(arch):
    shapes = jax.eval_shape(_jax_model(arch).init, jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    out, off = [], 0
    for path, leaf in leaves:
        name = "/".join(p.key for p in path)
        out.append((name, tuple(leaf.shape), off))
        off += int(np.prod(leaf.shape))
    return out


def _jax_flat(arch, seed=0):
    model = _jax_model(arch)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    ravel, unravel = _flat_io(shapes)
    params = model.init(jax.random.PRNGKey(seed))
    return np.asarray(ravel(params)), unravel


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_flat_layout_matches_jax(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    assert flat_layout(cfg) == _jax_layout(arch)
    flat, _ = _jax_flat(arch)
    assert flat_size(cfg) == flat.size
    if cfg.qkv_bias:
        names = [p for p, _, _ in flat_layout(cfg)]
        assert names[:7] == ["blocks/attn/" + k for k in
                             ("bk", "bq", "bv", "wk", "wo", "wq", "wv")]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_flat_round_trip_exact(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    flat = np.random.RandomState(0).standard_normal(
        flat_size(cfg)).astype(np.float32)
    params = params_from_flat(flat, cfg, device="cpu")
    np.testing.assert_array_equal(flat_from_params(params), flat)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen1.5-110b"])
def test_params_from_jax_equals_params_from_flat(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    flat, unravel = _jax_flat(arch, seed=3)
    tree = jax.tree.map(np.asarray, unravel(flat))
    a = params_from_jax(tree, device="cpu")
    b = params_from_flat(flat, cfg, device="cpu")
    la, lb = list(iter_leaves(a)), list(iter_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype == torch.float32, path
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_params_from_jax_keeps_bf16():
    tree = {"w": jax.numpy.arange(6, dtype=jax.numpy.bfloat16) / 7}
    t = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(tree["w"], np.float32))


def test_params_from_flat_rejects_wrong_size():
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    with pytest.raises(ValueError):
        params_from_flat(np.zeros(7, np.float32), cfg, device="cpu")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_expert_copies_carry_across(arch):
    """2 experts on a "model" axis of 4 (r = 2): the reference's numpy
    tree holds 4 expert copies and loads into the port leaf for leaf,
    every value equal and every shape the port's ``make_model(cfg,
    dist)`` param defs under the same mesh."""
    import dataclasses
    from repro_torch.distributed.sharding import Dist as TDist
    from repro_torch.models.model import make_model
    mesh = _FakeMesh({"data": 1, "model": 4})
    jcfg = jax_reduce(jax_get_arch(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=2))
    cfg = reduce_for_smoke(get_arch(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=2))
    jparams = jax.tree.map(np.asarray, jax_make_model(
        jcfg, Dist(mesh=mesh)).init(jax.random.PRNGKey(0)))
    got = dict(iter_leaves(params_from_jax(jparams, device="cpu")))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    defs = dict(iter_leaves(make_model(cfg, TDist(mesh=mesh))
                            .param_defs()))
    assert got["blocks/moe/wg"].shape[-3] == 4
    assert set(got) == set(want) == set(defs)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(defs[k].shape), k
        np.testing.assert_array_equal(
            v.float().numpy(), np.asarray(want[k], np.float32), err_msg=k)
