"""The port's software parameter server (``device="cpu"``: plain versions
of K1/K2/K3) against the JAX package's on the same init and the same
pushes: every solver, dense and int8 pushes, BSP rounds with 3 learners
on threads, on-arrival (Downpour) pushes, the BSP timeout withdraw, and
``stats()``.

Tolerance 1e-5 (atol and rtol): the two servers run the same f32 update
on identical receive rows (the int8 wire is exact in both), except that
JAX's CPU server takes adam's b^t in float64 and the port in f32 (~1e-7
relative per round)."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.software_ps import ShardLayout as JaxLayout
from repro.core.software_ps import SoftwareParameterServer as JaxPS
from repro_torch.core.software_ps import (PSClient, ShardLayout,
                                          SoftwareParameterServer)
from repro_torch.kernels import ops

TOL = dict(atol=1e-5, rtol=1e-5)
SOLVERS = ["sgd", "momentum", "adam", "average", "easgd"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run_threads(fns, timeout=30):
    ts = [threading.Thread(target=f) for f in fns]
    [t.start() for t in ts]
    [t.join(timeout) for t in ts]
    assert not any(t.is_alive() for t in ts)


def _bsp(ps, vectors, clients=None):
    """One BSP round: every learner pushes its vector from its thread."""
    if clients is None:
        fns = [lambda i=i: ps.push(i, vectors[i])
               for i in range(len(vectors))]
    else:
        fns = [lambda i=i: clients[i].push(vectors[i])
               for i in range(len(vectors))]
    _run_threads(fns)


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("optimizer", SOLVERS)
def test_bsp_rounds_match_jax(optimizer, compression):
    """3 learners, 2 shards, 4 BSP rounds through each package's
    clients: same params after every round."""
    rng = np.random.RandomState(0)
    n, nl = 700, 3
    init = rng.standard_normal(n).astype(np.float32)
    kw = dict(n_shards=2, n_learners=nl, optimizer=optimizer, lr=0.05,
              compression=compression)
    ps = SoftwareParameterServer(init, device="cpu", **kw)
    jps = JaxPS(init, **kw)
    assert ps.layout == ShardLayout(*JaxLayout.build(n, 2).__dict__.values())
    clients = [ps.make_client(i) for i in range(nl)]
    jclients = [jps.make_client(i) for i in range(nl)]
    assert all(isinstance(c, PSClient) for c in clients)
    for i in range(nl):
        ps.join(i)
        jps.join(i)
    ops.reset_launch_counts()
    for _ in range(4):
        vecs = rng.standard_normal((nl, n)).astype(np.float32)
        _bsp(ps, [torch.from_numpy(v) for v in vecs], clients)
        _bsp(jps, list(vecs), jclients)
        got = clients[0].pull()
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(_np(got), jclients[0].pull(), **TOL,
                                   err_msg=optimizer)
    assert set(ops.launch_counts().values()) == {0}      # plain versions
    st, jst = ps.stats(), jps.stats()
    assert set(st) == set(jst)
    for key in ("compression", "ps_shards", "push_count", "pull_count",
                "push_timeouts", "bytes_pushed_wire", "bytes_pushed_dense",
                "bytes_pulled", "agg_rounds", "slow_slots",
                "compression_ratio"):
        assert st[key] == jst[key], key
    assert st["agg_rounds"] == 4 and st["push_count"] == 12
    assert st["agg_ms_per_round"] is not None


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_on_arrival_matches_jax(optimizer):
    """Downpour: every push is applied on arrival (serial pushes, so the
    order is the same in both)."""
    rng = np.random.RandomState(1)
    init = rng.standard_normal(300).astype(np.float32)
    kw = dict(n_shards=2, n_learners=3, optimizer=optimizer, lr=0.1,
              trigger="on_arrival")
    ps = SoftwareParameterServer(init, device="cpu", **kw)
    jps = JaxPS(init, **kw)
    for i in range(3):
        ps.join(i)
        jps.join(i)
    for r in range(5):
        g = rng.standard_normal(300).astype(np.float32)
        assert ps.push(r % 3, g) is True
        jps.push(r % 3, g)
    np.testing.assert_allclose(_np(ps.pull(0)), jps.pull(0), **TOL)
    assert ps.stats()["agg_rounds"] == jps.stats()["agg_rounds"] == 5


def test_bsp_timeout_withdraws_and_reports():
    """A timed-out BSP push returns False, counts the drop and leaves the
    round clean; the int8 client puts the withdrawn signal back into its
    feedback buffer, as JAX's client does."""
    ps = SoftwareParameterServer(np.zeros(512, np.float32), n_shards=2,
                                 n_learners=2, optimizer="sgd", lr=1.0,
                                 compression="int8", device="cpu")
    jps = JaxPS(np.zeros(512, np.float32), n_shards=2, n_learners=2,
                optimizer="sgd", lr=1.0, compression="int8")
    for s in (ps, jps):
        s.join(0)
        s.join(1)
    g = np.random.RandomState(2).standard_normal(512).astype(np.float32)
    c, jcl = ps.make_client(0), jps.make_client(0)
    assert c.push(torch.from_numpy(g), timeout=0.2) is False
    assert jcl.push(g, timeout=0.2) is False
    assert ps.stats()["push_timeouts"] == 1 and ps._arrived == []
    np.testing.assert_allclose(_np(c._err), np.asarray(jcl._err), atol=1e-6)
    # both learners push again: the round completes normally
    done = []
    c1, jc1 = ps.make_client(1), jps.make_client(1)
    _run_threads([lambda: done.append(c.push(torch.from_numpy(g))),
                  lambda: done.append(c1.push(torch.from_numpy(g)))])
    _run_threads([lambda: jcl.push(g), lambda: jc1.push(g)])
    assert done == [True, True]
    np.testing.assert_allclose(_np(ps.pull(0)), jps.pull(0), **TOL)


def test_leave_releases_bsp_barrier():
    ps = SoftwareParameterServer(np.zeros(4, np.float32), n_shards=2,
                                 n_learners=2, optimizer="sgd", lr=1.0,
                                 device="cpu")
    ps.join(0)
    ps.join(1)
    done = []
    t = threading.Thread(target=lambda: done.append(
        ps.push(0, np.ones(4, np.float32), timeout=5.0)))
    t.start()
    time.sleep(0.1)
    ps.leave(1)              # learner 1 crashes before pushing
    t.join(10)
    assert done == [True]
    np.testing.assert_allclose(_np(ps.pull(0)), -np.ones(4))


def test_partitioning_load_flat_and_dense_pushes():
    w = np.random.RandomState(3).standard_normal(700).astype(np.float32)
    ps = SoftwareParameterServer(np.zeros(700, np.float32), n_shards=4,
                                 n_learners=1, optimizer="sgd", lr=0.0,
                                 device="cpu")
    ps.load_flat(w)
    np.testing.assert_array_equal(_np(ps.pull(0)), w)
    assert ps.pull(0) is ps.pull(0)             # reused pull buffer
    with pytest.raises(ValueError):
        ps.load_flat(w[:10])
    ps.join(0)
    with pytest.raises(ValueError):
        ps.push(0, np.ones(10, np.float32))
    # a padded-length dense push is accepted too
    ps.push(0, np.zeros(ps.layout.padded, np.float32))
    assert ps.stats()["agg_rounds"] == 1


def test_slow_learner_matches_jax():
    ps = SoftwareParameterServer(np.zeros(8, np.float32), n_shards=2,
                                 n_learners=2, device="cpu")
    jps = JaxPS(np.zeros(8, np.float32), n_shards=2, n_learners=2)
    for s in (ps, jps):
        s.slow_learner(3, 0.01, rounds=1)
    assert ps.stats()["slow_slots"] == jps.stats()["slow_slots"] == [1]
    ps.join(1)
    t0 = time.perf_counter()
    ps.push(1, np.ones(8, np.float32))
    assert time.perf_counter() - t0 >= 0.01
    assert ps.stats()["slow_slots"] == []


def test_rejects_unknown_settings():
    for kw in ({"optimizer": "adagrad"}, {"trigger": "ssp"},
               {"compression": "fp8"}):
        with pytest.raises(ValueError):
            SoftwareParameterServer(np.zeros(8, np.float32), device="cpu",
                                    **kw)
