"""The port's PS primitives (``repro_torch.core.ps``) on their local path
(a leading learner axis, one process) against ``repro.core.ps``'s local
path on the same numpy inputs, ``ATOL``; the server update of each
elementwise optimizer (K1's plain version where it computes the
configuration, ``flat_update`` otherwise) as the reference's jnp
``flat_update``. Their mesh paths run on 4 gloo ranks in
tests/test_torch_solvers.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ps as jps
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import flat_update as jflat_update
from repro_torch.core import ps
from repro_torch.optim.optimizers import OptConfig, flat_init

ATOL = 1e-6
NL, F = 4, 2048
OPTS = {"sgd": dict(name="sgd", lr=0.1),
        "momentum": dict(name="momentum", lr=0.1),
        "adamw": dict(name="adamw", lr=0.01),
        "adamw-wd": dict(name="adamw", lr=0.01, weight_decay=0.1)}
LOCAL = ps.PSContext(mesh=None, n_learners=NL)
JLOCAL = jps.PSContext(mesh=None, n_learners=NL)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"stack": rng.standard_normal((NL, F)).astype(np.float32),
            "center": rng.standard_normal(F).astype(np.float32),
            "m": 0.1 * rng.standard_normal(F).astype(np.float32),
            "v": np.abs(0.1 * rng.standard_normal(F)).astype(np.float32)}


def _states(opt, x, step0=2):
    """(port state, reference state) from the same numbers."""
    cfg = OptConfig(**opt)
    st = flat_init(cfg, F)
    jst = {"step": jnp.asarray(step0, jnp.int32)}
    for k in ("m", "v"):
        if k in st:
            st[k].copy_(torch.from_numpy(x[k]))
            jst[k] = jnp.asarray(x[k].copy())
    st["step"] = torch.tensor(step0, dtype=torch.int32)
    return st, jst


def _jupdate(opt):
    cfg = JOptConfig(**opt)
    return lambda p, g, s: jflat_update(cfg, p, g, s)


def test_pull_is_the_center():
    x = _inputs()
    got = ps.pull(torch.from_numpy(x["center"]), LOCAL)
    want = jps.pull(jnp.asarray(x["center"]), JLOCAL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["ps", "broadcast"])
def test_push_mean(mode):
    x = _inputs(1)
    got = ps.push_mean(torch.from_numpy(x["stack"]), mode, LOCAL)
    want = jps.push_mean(jnp.asarray(x["stack"]), mode, JLOCAL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("mode", ["ps", "broadcast"])
def test_push_update_pull(mode, opt):
    x = _inputs(2)
    st, jst = _states(OPTS[opt], x)
    center = torch.from_numpy(x["center"].copy())
    c, st, full = ps.push_update_pull(torch.from_numpy(x["stack"]), center,
                                      st, ps.ServerUpdate(
                                          OptConfig(**OPTS[opt])),
                                      mode, LOCAL)
    jc, jst, jfull = jps.push_update_pull(
        jnp.asarray(x["stack"]), jnp.asarray(x["center"]), jst,
        _jupdate(OPTS[opt]), mode, JLOCAL)
    for got, want in ((c, jc), (full, jfull)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    for k in ("m", "v"):
        if k in jst:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=ATOL, err_msg=k)
    assert int(st["step"]) == int(jst["step"]) == 3
    assert c.data_ptr() == center.data_ptr()        # in place


@pytest.mark.parametrize("opt", list(OPTS))
def test_downpour_round(opt):
    x = _inputs(3)
    st, jst = _states(OPTS[opt], x)
    c, st, pre, stale = ps.downpour_round(
        torch.from_numpy(x["stack"]), torch.from_numpy(x["center"].copy()),
        st, ps.ServerUpdate(OptConfig(**OPTS[opt])), LOCAL)
    jc, jst, jpre = jps.downpour_round(
        jnp.asarray(x["stack"]), jnp.asarray(x["center"]), jst,
        _jupdate(OPTS[opt]), JLOCAL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(
        float(stale), float(jnp.mean(jnp.abs(jpre[-1] - jpre[0]))),
        rtol=1e-6)
    assert int(st["step"]) == int(jst["step"]) == 2 + NL


def test_shard_len():
    assert ps.shard_len(1024, 4) == jps.shard_len(1024, 4) == 256
    with pytest.raises(ValueError):
        ps.shard_len(1023, 4)
    with pytest.raises(AssertionError):
        jps.shard_len(1023, 4)


def test_use_mesh():
    assert not ps.PSContext(mesh=None, n_learners=4).use_mesh
    assert not ps.PSContext(mesh=object(), n_learners=1).use_mesh
    assert ps.PSContext(mesh=object(), n_learners=2).use_mesh
