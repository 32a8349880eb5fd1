"""The port's solvers (``repro_torch.core.solvers``) against the JAX
package's (``repro.core.solvers``), on the CPU.

Local path (a leading learner axis, one process), the quadratic problem
of tests/test_solvers.py (D 8, 4 learners, 16 rows a learner): the six
configurations of tests/test_solvers.py:36-43, and the server's AdamW
(K1's adam) and AdamW with weight decay (``flat_update``), 5 rounds from
the same numpy batches; the center after every round within ``ATOL``
(the reference's own ``modelavg(H=1) == psgd`` tolerance), the metrics
and ``wire_bytes_per_round`` equal. Then the reference's own checks on
the port: convergence (err < 0.2; AdamW < 0.3), staleness, divergence
falling, ``modelavg(H=1) == psgd``, and the byte asymptotics. The flat
vector of an LM is ``LMPlugin.flat_state``'s.

Mesh path: 4 gloo ranks on a (4, 1) mesh, spawned once
(``util_ps_worker.py``, a ``FileStore`` under ``tmp_path``: no port),
run every case: each primitive and push mode on the ranks' rows and
shards against ``repro.core.ps``'s local path on the global arrays
(``PRIM_ATOL``); every solver configuration above, 5 rounds, against
JAX's local path (``ATOL``); the collectives of a psgd round counted by
``analysis.roofline.ProgramCounter`` in both push modes."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ps as jps
from repro.core.solvers import SolverConfig as JSolverConfig
from repro.core.solvers import make_solver as jmake_solver
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import flat_update as jflat_update
from repro_torch.core.solvers import SolverConfig, make_solver
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig
from util_gloo import spawn_ranks

ATOL = 1e-5            # tests/test_solvers.py: modelavg(H=1) == psgd
PRIM_ATOL = 1e-6
D, NL, B = 8, 4, 16
ROUNDS = 5
W_TRUE = np.random.default_rng(0).standard_normal(D).astype(np.float32)
WORKER = Path(__file__).resolve().parent / "util_ps_worker.py"

SGD = dict(name="sgd", lr=0.1)
CONFIGS = {
    "psgd-ps": (dict(name="psgd"), SGD),
    "psgd-broadcast": (dict(name="psgd", push_mode="broadcast"), SGD),
    "psgd-ps-q8": (dict(name="psgd", compress=True), SGD),
    "modelavg-H2": (dict(name="modelavg", comm_every=2), SGD),
    "easgd-H2": (dict(name="easgd", comm_every=2), SGD),
    "downpour-H2": (dict(name="downpour", comm_every=2), SGD),
    "psgd-adamw": (dict(name="psgd"),
                   dict(name="adamw", lr=0.05, weight_decay=0.0)),
    "psgd-adamw-wd": (dict(name="psgd"),
                      dict(name="adamw", lr=0.05, weight_decay=0.01)),
    "downpour-momentum-q8": (dict(name="downpour", comm_every=2,
                                  compress=True),
                             dict(name="momentum", lr=0.02)),
    "modelavg-broadcast-q8": (dict(name="modelavg", comm_every=2,
                                   push_mode="broadcast", compress=True),
                              SGD),
    "easgd-broadcast": (dict(name="easgd", comm_every=2,
                             push_mode="broadcast"), SGD),
}
REFERENCE_SIX = list(CONFIGS)[:6]


def jloss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def tloss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _batches(seed, rounds, h):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        x = rng.standard_normal((h, NL, B, D)).astype(np.float32)
        out.append((x, x @ W_TRUE))
    return out


def _jax_run(scfg, opt, data):
    s = jmake_solver(jloss, {"w": jnp.zeros(D)}, JOptConfig(**opt),
                     JSolverConfig(**scfg), NL)
    st = s.init_state({"w": jnp.zeros(D)})
    ws, ms = [], []
    for x, y in data:
        st, m = s.round(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        ws.append(np.asarray(s.params_of(st)["w"]))
        ms.append({k: float(v) for k, v in m.items()})
    return ws, ms, s.wire_bytes_per_round()


def _port(scfg, opt):
    s = make_solver(tloss, {"w": torch.zeros(D)}, OptConfig(**opt),
                    SolverConfig(**scfg), NL, device="cpu")
    return s, s.init_state({"w": torch.zeros(D)})


def _port_run(scfg, opt, data):
    s, st = _port(scfg, opt)
    ws, ms = [], []
    for x, y in data:
        st, m = s.round(st, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)})
        ws.append(s.params_of(st)["w"].numpy())
        ms.append({k: float(v) for k, v in m.items()})
    return ws, ms, s.wire_bytes_per_round()


@pytest.mark.parametrize("cid", list(CONFIGS))
def test_local_rounds_match_jax(cid):
    scfg, opt = CONFIGS[cid]
    data = _batches(1, ROUNDS, SolverConfig(**scfg).rounds_h)
    jw, jm, jwire = _jax_run(scfg, opt, data)
    tw, tm, twire = _port_run(scfg, opt, data)
    for i in range(ROUNDS):
        np.testing.assert_allclose(tw[i], jw[i], rtol=0, atol=ATOL,
                                   err_msg=f"round {i}")
        assert tm[i].keys() == jm[i].keys()
        for k in jm[i]:
            np.testing.assert_allclose(tm[i][k], jm[i][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert twire == jwire


def _converge(scfg, opt, rounds, seed=1):
    s, st = _port(scfg, opt)
    m = {}
    for x, y in _batches(seed, rounds, SolverConfig(**scfg).rounds_h):
        st, m = s.round(st, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)})
    return s.params_of(st)["w"].numpy(), m


@pytest.mark.parametrize("cid", REFERENCE_SIX)
def test_solver_converges(cid):
    scfg, opt = CONFIGS[cid]
    w, m = _converge(scfg, opt, 60)
    assert float(np.linalg.norm(w - W_TRUE)) < 0.2
    assert "loss" in m


def test_modelavg_h1_equals_psgd():
    w1, _ = _converge(dict(name="psgd"), SGD, 5)
    w2, _ = _converge(dict(name="modelavg", comm_every=1, local_lr=0.1),
                      SGD, 5)
    np.testing.assert_allclose(w1, w2, rtol=0, atol=ATOL)


def test_downpour_reports_staleness():
    _, m = _converge(dict(name="downpour", comm_every=2), SGD, 3)
    assert float(m["staleness"]) > 0


def test_easgd_divergence_metric_decreases():
    s, st = _port(dict(name="easgd", comm_every=2), SGD)
    divs = []
    for x, y in _batches(2, 40, 2):
        st, m = s.round(st, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)})
        divs.append(float(m["divergence"]))
    assert divs[-1] < divs[0]


def test_psgd_with_adam_server():
    w, _ = _converge(dict(name="psgd"),
                     dict(name="adamw", lr=0.05, weight_decay=0.0), 150)
    assert float(np.linalg.norm(w - W_TRUE)) < 0.3


def test_wire_bytes_asymptotics():
    mk = lambda mode: _port(dict(name="psgd", push_mode=mode),   # noqa
                            dict(name="sgd"))[0]
    assert mk("broadcast").wire_bytes_per_round() > \
        mk("ps").wire_bytes_per_round() * (NL - 1) / 2


def test_server_update_takes_k1_where_it_computes_the_config():
    from repro_torch.core.ps import ServerUpdate
    assert ServerUpdate(OptConfig(name="sgd")).uses_k1
    assert ServerUpdate(OptConfig(name="momentum")).uses_k1
    assert ServerUpdate(OptConfig(name="adamw", weight_decay=0.0)).uses_k1
    assert not ServerUpdate(OptConfig(name="adamw",
                                      weight_decay=0.01)).uses_k1


def test_server_update_matches_flat_update():
    """K1's plain version (sgd, momentum, adam) and ``flat_update``
    (AdamW with weight decay) against the reference's jnp update over
    three steps from the mean of 3 rows."""
    from repro_torch.core.ps import ServerUpdate
    from repro_torch.optim.optimizers import flat_init
    rng = np.random.default_rng(3)
    n = 512
    p0 = rng.standard_normal(n).astype(np.float32)
    for kw in (dict(name="sgd", lr=0.1), dict(name="momentum", lr=0.1),
               dict(name="adamw", lr=0.01),
               dict(name="adamw", lr=0.01, weight_decay=0.1)):
        upd = ServerUpdate(OptConfig(**kw))
        p = torch.from_numpy(p0.copy())
        st = flat_init(OptConfig(**kw), n)
        jp = jnp.asarray(p0)
        jst = {k: jnp.asarray(v.numpy().copy()) for k, v in st.items()}
        for _ in range(3):
            rows = rng.standard_normal((3, n)).astype(np.float32)
            upd(p, torch.from_numpy(rows), st)
            jp, jst = jflat_update(JOptConfig(**kw), jp,
                                   jnp.mean(jnp.asarray(rows), 0), jst)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0,
                                   atol=PRIM_ATOL, err_msg=str(kw))
        assert int(st["step"]) == int(jst["step"]) == 3


def test_flat_vector_is_the_learners():
    """An LM tree raveled by the solver is ``LMPlugin.flat_state``'s
    vector, padded with zeros to a multiple of BLOCK * L."""
    from repro_torch.runtime.learner import LMPlugin
    from repro_torch.weights import params_from_flat
    plugin = LMPlugin({"arch": "stablelm-1.6b"}, device="cpu")
    flat = plugin.flat_state(0)
    tree = params_from_flat(flat.numpy(), plugin.cfg, device="cpu")
    s = make_solver(lambda p, b: p, tree, OptConfig(name="sgd"),
                    SolverConfig(), NL, device="cpu")
    got = s.ravel(tree)
    assert s.true_size == flat.numel()
    assert s.padded % (256 * NL) == 0 and s.padded >= flat.numel()
    assert torch.equal(got[:flat.numel()], flat)
    assert not got[flat.numel():].any()
    back = dict(iter_leaves(s.unravel(got)))
    for path, t in iter_leaves(tree):
        assert torch.equal(back[path], t.float()), path


@pytest.mark.parametrize("split", [False, True])
def test_per_layer_is_the_callers_choice(split):
    """A leaf enters ``loss_fn`` as one tensor unless the caller's
    ``per_layer`` names it, whatever its key (``blocks`` included); named,
    it enters as the list of its leading-dim slices. The gradient is the
    same either way: the whole tree's, raveled."""
    from repro_torch.models.layers import is_stacked
    rng = np.random.default_rng(3)
    tree = {"blocks": {"w": torch.tensor(rng.standard_normal((3, 4)),
                                         dtype=torch.float32)},
            "head": torch.tensor(rng.standard_normal(4),
                                 dtype=torch.float32)}
    seen = []

    def loss_fn(p, batch):
        w = p["blocks"]["w"]
        seen.append(type(w))
        w = torch.stack(w) if isinstance(w, list) else w
        return ((w * batch["x"]).sum(0) * p["head"]).square().sum()
    s = make_solver(loss_fn, tree, OptConfig(name="sgd"), SolverConfig(),
                    NL, device="cpu", per_layer=is_stacked if split else None)
    x = torch.tensor(rng.standard_normal((3, 4)), dtype=torch.float32)
    _, g = s.value_and_grad(s.ravel(tree), {"x": x})
    assert seen == [list if split else torch.Tensor]
    live = {"blocks": {"w": tree["blocks"]["w"].clone().requires_grad_()},
            "head": tree["head"].clone().requires_grad_()}
    loss_fn(live, {"x": x}).backward()
    want = s.ravel({"blocks": {"w": live["blocks"]["w"].grad},
                    "head": live["head"].grad})
    assert torch.equal(g, want)


# ---------------------------------------------------------------------------
# the mesh path: 4 gloo ranks
# ---------------------------------------------------------------------------

F = 1024                 # padded length of the D = 8 problem at L = 4
PRIMS = [dict(op="pull"),
         dict(op="push_mean", mode="ps"),
         dict(op="push_mean", mode="broadcast")]
for _mode in ("ps", "broadcast"):
    for _opt in (SGD, dict(name="adamw", lr=0.01),
                 dict(name="adamw", lr=0.01, weight_decay=0.1),
                 dict(name="momentum", lr=0.1)):
        PRIMS.append(dict(op="push_update_pull", mode=_mode, opt=_opt))
for _opt in (SGD, dict(name="adamw", lr=0.01)):
    PRIMS.append(dict(op="downpour_round", opt=_opt))
for _i, _p in enumerate(PRIMS):
    _p.update(id=f"prim{_i}-{_p['op']}-{_p.get('mode', '')}-"
                 f"{_p.get('opt', {}).get('name', '')}", kind="prim",
              step0=2)
PRIM_IDS = [p["id"] for p in PRIMS]


def _mesh_cases():
    out = list(PRIMS)
    for cid, (scfg, opt) in CONFIGS.items():
        out.append(dict(id=cid, kind="solver", scfg=scfg, opt=opt, nl=NL,
                        rounds=ROUNDS, data=cid))
    return out


def _prim_inputs():
    rng = np.random.default_rng(7)
    return {"stack": rng.standard_normal((NL, F)).astype(np.float32),
            "center": rng.standard_normal(F).astype(np.float32),
            "m": 0.1 * rng.standard_normal(F).astype(np.float32),
            "v": np.abs(0.1 * rng.standard_normal(F)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh case on 4 gloo ranks, once: (each rank's json, each
    rank's arrays, the inputs)."""
    work = tmp_path_factory.mktemp("ps-gloo")
    inputs = _prim_inputs()
    inputs["w_true"] = W_TRUE
    for cid, (scfg, _) in CONFIGS.items():
        for i, (x, y) in enumerate(_batches(1, ROUNDS,
                                            SolverConfig(**scfg).rounds_h)):
            inputs[f"{cid}/x{i}"], inputs[f"{cid}/y{i}"] = x, y
    np.savez(work / "inputs.npz", **inputs)
    (work / "cases.json").write_text(json.dumps(_mesh_cases()))
    spawn_ranks(WORKER, work, NL, timeout=300)
    every = [json.loads((work / f"out-{r}.json").read_text())
             for r in range(NL)]
    arrays = [dict(np.load(work / f"out-{r}.npz")) for r in range(NL)]
    return every, arrays, inputs


def _jax_prim(case, inputs):
    """The reference's local path on the global arrays: every output as
    a global array."""
    ctx = jps.PSContext(mesh=None, n_learners=NL)
    stack = jnp.asarray(inputs["stack"])
    center = jnp.asarray(inputs["center"])
    if case["op"] == "pull":
        return {"out": np.asarray(jps.pull(center, ctx))}
    if case["op"] == "push_mean":
        return {"out": np.asarray(jps.push_mean(stack, case["mode"], ctx))}
    cfg = JOptConfig(**case["opt"])
    st = {"step": jnp.asarray(case["step0"], jnp.int32)}
    if cfg.name in ("momentum", "adamw"):
        st["m"] = jnp.asarray(inputs["m"])
    if cfg.name == "adamw":
        st["v"] = jnp.asarray(inputs["v"])
    upd = lambda p, g, s: jflat_update(cfg, p, g, s)       # noqa: E731
    if case["op"] == "push_update_pull":
        c, s, full = jps.push_update_pull(stack, center, st, upd,
                                          case["mode"], ctx)
        out = {"full": np.asarray(full)}
    else:
        c, s, pre = jps.downpour_round(stack, center, st, upd, ctx)
        out = {"prefix": np.asarray(pre),
               "staleness": float(jnp.mean(jnp.abs(pre[-1] - pre[0])))}
    out["center"] = np.asarray(c)
    for k in ("m", "v"):
        if k in s:
            out[k] = np.asarray(s[k])
    out["step"] = int(s["step"])
    return out


@pytest.mark.parametrize("cid", PRIM_IDS)
def test_mesh_primitive_matches_jax_local(ranks, cid):
    every, arrays, inputs = ranks
    case = next(p for p in PRIMS if p["id"] == cid)
    want = _jax_prim(case, inputs)
    c = F // NL
    for r in range(NL):
        got = {k.split("/", 1)[1]: v for k, v in arrays[r].items()
               if k.startswith(cid + "/")}
        for k, w in want.items():
            if k in ("center", "m", "v"):
                w = w[r * c:(r + 1) * c]           # this rank's shard
            elif k == "prefix":
                w = w[r:r + 1]                     # this learner's row
            np.testing.assert_allclose(got[k], w, rtol=0, atol=PRIM_ATOL,
                                       err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("cid", list(CONFIGS))
def test_mesh_rounds_match_jax_local(ranks, cid):
    every, arrays, _ = ranks
    scfg, opt = CONFIGS[cid]
    data = _batches(1, ROUNDS, SolverConfig(**scfg).rounds_h)
    jw, jm, jwire = _jax_run(scfg, opt, data)
    for r in range(NL):
        res = every[r][cid]
        assert res["round"] == ROUNDS and res["wire"] == jwire
        assert res["center_len"] == res["padded"] // NL
        for i in range(ROUNDS):
            np.testing.assert_allclose(arrays[r][f"{cid}/w{i}"], jw[i],
                                       rtol=0, atol=ATOL,
                                       err_msg=f"rank {r} round {i}")
            for k in jm[i]:
                np.testing.assert_allclose(res["metrics"][i][k], jm[i][k],
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"{k} rank {r}")


def test_mesh_psgd_collective_bytes(ranks):
    """A psgd round's collectives, counted as issued, by the
    reference's per-device wire formula (``roofline.wire_bytes``): the
    pull at the round's start and the pull-back of ``push_update_pull``,
    each an all-gather of the (F/L,) shard, (L-1)/L * 4F; the push, a
    reduce-scatter of (F,) f32, (L-1)/L * 4F in ``ps`` mode and an
    all-gather of every learner's (F,) vector, (L-1) * 4F, in
    ``broadcast`` mode; the mean loss, an all-reduce of 4 bytes.
    ``wire_bytes_per_round`` counts one pull and the push in f32: its
    pattern, the push O(L) apart between the modes."""
    every = ranks[0]
    pull = (NL - 1) / NL * 4 * F
    loss = 2 * 4 * (NL - 1) / NL
    for r in range(NL):
        ps_ = every[r]["psgd-ps"]
        bc = every[r]["psgd-broadcast"]
        assert ps_["counted"] == {"all-gather": 2 * pull,
                                  "reduce-scatter": (NL - 1) / NL * 4 * F,
                                  "all-reduce": loss}
        assert bc["counted"] == {"all-gather": 2 * pull
                                 + (NL - 1) * 4 * F, "all-reduce": loss}
        assert ps_["wire"] == ps_["counted"]["reduce-scatter"] + pull
        assert bc["wire"] == (NL - 1) * 4 * F + 4 * F
        assert sum(bc["counted"].values()) > sum(ps_["counted"].values())
