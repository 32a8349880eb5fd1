"""The port's expert-parallel moe (``models.moe``'s EP bodies, the moe
and hybrid steps of ``distributed.steps`` on a mesh whose expert axis is
"model") on 4 gloo ranks, against the JAX package's sharded
``moe_block`` and ``jit_*_step`` on 4 host devices.

Both sides run once per module, at the same time: the port's ranks
through ``util_gloo.spawn_ranks`` (``util_gloo_worker.py``, a
``FileStore`` under ``tmp_path``: no port), the reference in one
``util_subproc.run_with_devices(n=4)`` subprocess that computes every
case. The inputs are numpy arrays made here from seeds, the same for
both.

Block cases (kimi-k2 at smoke size: 4 experts, top-2, d 64, f32), each
the output of ``moe_block`` and the gradients of ``sum(out * w)`` with
respect to x and every moe leaf:

  * meshes (data 2, model 2) and (data 1, model 4), ``fsdp_tp``;
  * S = 16: the train body (a sequence slice per "model" rank, two
    all-to-alls); S = 1 and S = 6 on model 4, S = 1 on model 2: the
    decode body (local experts, the combine all-reduced);
  * 2 experts on (1, 4): r = 2 copies of each (the router's round
    robin over copies, one copy per rank);
  * nearly equal tokens with capacity factor 1.0, so every pair goes to
    the same two experts and most are dropped, in either body;
  * ``zero3_sp`` on (2, 2): the rows handed in are the rank's slice of
    the sequence already (``ExpertParallel.sliced``).

Every rank's output and x gradient are held against its rows (and
slice) of the reference's; the router's gradient summed over the ranks
that hold different tokens, and each "model" block of an expert leaf's
gradient summed over "data", against the reference's. The output within
``FWD_TOL``, the gradients within ``GRAD_TOL`` (tests/test_torch_moe.py).

Step cases on (2, 2): kimi-k2 and jamba-1.5-large at smoke size through
``jit_train_step`` (2 AdamW steps), and from the same initial params
``jit_prefill_step`` of 12 tokens into a cache of 14 and 2
``jit_decode_step`` calls on fixed tokens, against the reference's
``jit_*_step`` on the same mesh (its prefill cache padded to 14 before
its decode). Losses within ``FWD_TOL``; params, logits and caches
within ``MODEL_TOL``. And kimi-k2 under ``zero3_sp`` on (2, 2): the
sequence-parallel step's loss and gradients
(``steps.local_loss_and_grads``, the moe layers on the rank's slice)
against the reference's ``value_and_grad`` of ``Model.loss`` on the
mesh, the loss within ``FWD_TOL`` and the gradients within
``MODEL_TOL`` (as tests/test_torch_sp.py holds the dense families'; a
third AdamW update of an element whose gradient is near zero moves it
by up to lr, past any tolerance on the params). The serve starts from the initial params, not the
trained ones: after two AdamW steps the packages' params differ by up
to 5.4e-5 (within ``MODEL_TOL``), which the smoke model's key
projection (keys up to ~11) carries into cache differences of ~5e-4;
from one set of params the mesh-less caches of the two agree to 1.4e-5.
"""
import dataclasses
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.models import make_model as jax_make_model
from repro.models.moe import _capacity
from util_gloo import spawn_ranks
from util_subproc import run_with_devices

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_steps.py
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)    # tests/test_torch_moe.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
WORLD = 4
B = 4
WORKER = Path(__file__).resolve().parent / "util_gloo_worker.py"
KIMI = "kimi-k2-1t-a32b"
JAMBA = "jamba-1.5-large-398b"
OPTS = {"remat": "none", "xent_chunk": 512, "q_chunk": 32, "k_chunk": 32}


def _block(cid, mesh, S, kind="random", policy="fsdp_tp", n_experts=None,
           capacity_factor=None):
    return dict(id=cid, kind="ep_block", arch=KIMI, mesh=mesh, S=S,
                input=kind, policy=policy, n_experts=n_experts,
                capacity_factor=capacity_factor)


BLOCKS = [
    _block("2x2-s16", [2, 2], 16),
    _block("2x2-s16-drop", [2, 2], 16, "drop", capacity_factor=1.0),
    _block("2x2-s1", [2, 2], 1),
    _block("2x2-s16-sp", [2, 2], 16, policy="zero3_sp"),
    _block("1x4-s16", [1, 4], 16),
    _block("1x4-s1", [1, 4], 1),
    _block("1x4-s6", [1, 4], 6),
    _block("1x4-s6-drop", [1, 4], 6, "drop", capacity_factor=1.0),
    _block("1x4-e2-s16", [1, 4], 16, n_experts=2),
    _block("1x4-e2-s1", [1, 4], 1, n_experts=2),
    _block("1x4-e2-s6", [1, 4], 6, n_experts=2),
]
STEPS = [
    dict(id="kimi", kind="ep_step", arch=KIMI, mesh=[2, 2],
         policy="fsdp_tp", lr=1e-3, steps=2, S=16, prompt=12, new=2),
    dict(id="jamba", kind="ep_step", arch=JAMBA, mesh=[2, 2],
         policy="fsdp_tp", lr=1e-3, steps=2, S=16, prompt=12, new=2),
    dict(id="kimi-e2", kind="ep_step", arch=KIMI, mesh=[1, 4],
         policy="fsdp_tp", lr=1e-3, steps=2, S=16, prompt=12, new=4,
         n_experts=2),
    dict(id="kimi-sp", kind="sp", arch=KIMI, mesh=[2, 2], data="kimi-sp",
         opts=OPTS, S=16),
]

# the reference, every case in one process with 4 host devices
REF = r'''
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import ShapeSpec, reduce_for_smoke
from repro.configs.registry import get_arch
from repro.distributed import steps
from repro.distributed.sharding import Dist
from repro.launch.mesh import make_mesh
from repro.models import make_model
from repro.models.moe import moe_block
from repro.optim import optimizers as jopt

WORK = "{work}"
inp = np.load(WORK + "/inputs.npz")
out = {{}}


def ctx(mesh):
    return jax.sharding.use_mesh(mesh) if hasattr(jax.sharding,
                                                  "use_mesh") else mesh


def tree(pre):
    t = {{}}
    for k in inp.files:
        if k.startswith(pre):
            node = t
            *parents, last = k[len(pre):].split("/")
            for p in parents:
                node = node.setdefault(p, {{}})
            node[last] = jnp.asarray(inp[k])
    return t


def flat(t, pre):
    for path, v in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[pre + "/".join(str(p.key) for p in path)] = np.asarray(v)


def block(c):
    cfg = reduce_for_smoke(get_arch(c["arch"]))
    over = {{k: c[k] for k in ("n_experts", "capacity_factor")
            if c.get(k) is not None}}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    mesh = make_mesh(*c["mesh"])
    pre = c["id"] + "/"
    x, w = jnp.asarray(inp[pre + "x"]), jnp.asarray(inp[pre + "w"])
    dist = Dist(mesh=mesh, policy=c["policy"]).resolve_batch(x.shape[0])
    p = tree(pre + "p/")
    f = lambda x, p: moe_block(x, p, cfg, dist)
    loss = lambda x, p: jnp.sum(f(x, p).astype(jnp.float32) * w)
    with ctx(mesh):
        out[pre + "out"] = np.asarray(jax.jit(f)(x, p))
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, p)
    out[pre + "dx"] = np.asarray(gx)
    for k, v in gp.items():
        out[pre + "d" + k] = np.asarray(v)


def step(c):
    cfg = reduce_for_smoke(get_arch(c["arch"]))
    if c.get("n_experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=c["n_experts"]))
    mesh = make_mesh(*c["mesh"])
    pre = c["id"] + "/"
    toks = jnp.asarray(inp[pre + "b/tokens"])
    labels = jnp.asarray(inp[pre + "b/labels"])
    Bg, S = toks.shape
    dist = Dist(mesh=mesh, policy=c["policy"]).resolve_batch(Bg)
    model = make_model(cfg, dist)
    oc = jopt.OptConfig(name="adamw", lr=c["lr"])
    with ctx(mesh):
        params = jax.device_put(tree(pre + "p/"),
                                steps._ns(dist, model.param_specs()))
        state = jopt.init_opt_state(oc, params)
        state = jax.device_put(state, steps._ns(dist, jopt.opt_state_specs(
            oc, model.param_defs(), dist)))
        fn = steps.jit_train_step(model, oc, ShapeSpec("t", S, Bg, "train"))
        losses = []
        for _ in range(c["steps"]):
            params, state, loss = fn(params, state,
                                     {{"tokens": toks, "labels": labels}})
            losses.append(float(loss))
        out[pre + "losses"] = np.asarray(losses)
        flat(params, pre + "params/")
        if not c.get("prompt"):
            return
        params = jax.device_put(tree(pre + "p/"),
                                steps._ns(dist, model.param_specs()))
        plen, new = c["prompt"], c["new"]
        shape = ShapeSpec("s", plen, Bg, "prefill")
        logits, cache = steps.jit_prefill_step(model, shape)(
            params, {{"tokens": toks[:, :plen]}})
        got = [np.asarray(logits)]
        pad = {{k: v for k, v in cache.items()}}
        for k in ("k", "v"):
            widths = [(0, 0)] * pad[k].ndim
            widths[2] = (0, new)
            pad[k] = jnp.pad(pad[k], widths)
        dec = steps.jit_decode_step(model, ShapeSpec("d", plen + new, Bg,
                                                     "decode"))
        cache = jax.device_put(pad, steps._ns(
            dist, model.cache_sharding_specs(Bg)))
        for i in range(new):
            logits, cache = dec(params, cache,
                                {{"tokens": toks[:, plen + i:plen + i + 1]}})
            got.append(np.asarray(logits))
        out[pre + "logits"] = np.concatenate(got, 1)
        for k, v in cache.items():
            out[pre + "cache/" + k] = np.asarray(v)


def grads(c):
    cfg = reduce_for_smoke(get_arch(c["arch"]))
    mesh = make_mesh(*c["mesh"])
    pre = c["id"] + "/"
    batch = {{k: jnp.asarray(inp[pre + "b/" + k]) for k in ("tokens",
                                                           "labels")}}
    dist = Dist(mesh=mesh, policy="zero3_sp").resolve_batch(
        batch["tokens"].shape[0])
    model = make_model(cfg, dist, dict(c["opts"]))
    with ctx(mesh):
        params = jax.device_put(tree(pre + "p/"),
                                steps._ns(dist, model.param_specs()))
        loss, g = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    out[pre + "loss"] = np.asarray(loss)
    flat(g, pre + "grads/")


KINDS = {{"ep_block": block, "ep_step": step, "sp": grads}}
for c in json.load(open(WORK + "/cases.json")):
    KINDS[c["kind"]](c)
np.savez(WORK + "/ref.npz", **out)
print("OK")
'''


def _r(case):
    """Copies of each expert: the "model" size over the experts where
    they are fewer."""
    e, m = case["n_experts"] or 4, case["mesh"][1]
    return m // e if e < m else 1


def _block_inputs(case, seed):
    rng = np.random.default_rng(seed)
    D, Fe = 64, 64                     # the kimi-k2 smoke model's
    E = case["n_experts"] or 4
    ev = E * _r(case)
    x = rng.standard_normal((B, case["S"], D)).astype(np.float32) * 0.5
    if case["input"] == "drop":        # every pair picks the same experts
        x = x[:1, :1] + 1e-3 * x
    pre = case["id"] + "/"
    return {pre + "x": x,
            pre + "w": rng.standard_normal((B, case["S"], D))
            .astype(np.float32),
            pre + "p/router": (rng.standard_normal((D, E))
                               / np.sqrt(D)).astype(np.float32),
            pre + "p/wg": (rng.standard_normal((ev, D, Fe))
                           / np.sqrt(D)).astype(np.float32),
            pre + "p/wu": (rng.standard_normal((ev, D, Fe))
                           / np.sqrt(D)).astype(np.float32),
            pre + "p/wd": (rng.standard_normal((ev, Fe, D))
                           / np.sqrt(Fe)).astype(np.float32)}


class _FakeMesh:
    """The spec engine's duck-typed mesh: axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _step_inputs(case, seed):
    """The reference's init of the smoke model and a batch: mesh-less
    (one copy of each expert, as on (2, 2)), or with ``n_experts`` on the
    case's mesh (``r`` copies of each)."""
    cfg = jax_reduce(jax_get_arch(case["arch"]))
    dist = None
    if case.get("n_experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=case["n_experts"]))
        dist = Dist(mesh=_FakeMesh(dict(zip(("data", "model"),
                                            case["mesh"]))))
    params = jax_make_model(cfg, dist).init(jax.random.PRNGKey(seed))
    pre = case["id"] + "/"
    out = {pre + "p/" + "/".join(str(p.key) for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, case["S"] + 1)).astype(np.int32)
    out[pre + "b/tokens"] = toks[:, :-1]
    out[pre + "b/labels"] = toks[:, 1:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks and in the reference, at once: (each
    rank's json and arrays, the reference's arrays)."""
    work = tmp_path_factory.mktemp("moe-ep")
    inputs = {}
    for i, c in enumerate(BLOCKS):
        inputs.update(_block_inputs(c, i))
    for i, c in enumerate(STEPS):
        inputs.update(_step_inputs(c, 100 + i))
    np.savez(work / "inputs.npz", **inputs)
    (work / "cases.json").write_text(json.dumps(BLOCKS + STEPS))
    failed = []

    def reference():
        try:
            run_with_devices(REF.format(work=work), n=WORLD, timeout=900)
        except BaseException as e:       # raised in the main thread below
            failed.append(e)
    t = threading.Thread(target=reference)
    t.start()
    try:
        spawn_ranks(WORKER, work, WORLD, timeout=900)
    finally:
        t.join()
    if failed:
        raise failed[0]
    ranks = [(json.loads((work / f"out-{r}.json").read_text()),
              dict(np.load(work / f"out-{r}.npz"))) for r in range(WORLD)]
    return ranks, dict(np.load(work / "ref.npz"))


def _rows(case, coord):
    """The (batch, sequence) slice of the whole that rank ``coord``
    holds."""
    d, m = case["mesh"]
    nb = B // d
    rows = slice(coord[0] * nb, (coord[0] + 1) * nb)
    if case["policy"] != "zero3_sp":
        return rows, slice(None)
    n = case["S"] // m
    return rows, slice(coord[1] * n, (coord[1] + 1) * n)


@pytest.mark.parametrize("case", BLOCKS, ids=[c["id"] for c in BLOCKS])
def test_ep_block_matches_the_sharded_reference(runs, case):
    ranks, ref = runs
    pre = case["id"] + "/"
    d, m = case["mesh"]
    sliced = case["policy"] == "zero3_sp"
    ev = ref[pre + "dwg"].shape[0]
    e_local = ev // m
    router = np.zeros_like(ref[pre + "drouter"])
    experts = {k: np.zeros_like(ref[pre + "d" + k])
               for k in ("wg", "wu", "wd")}
    for res, arr in ranks:
        coord = res[case["id"]]["coord"]
        assert res[case["id"]]["r"] == _r(case)
        sl = _rows(case, coord)
        np.testing.assert_allclose(arr[pre + "out"], ref[pre + "out"][sl],
                                   **FWD_TOL, err_msg=f"out {coord}")
        np.testing.assert_allclose(arr[pre + "dx"], ref[pre + "dx"][sl],
                                   **GRAD_TOL, err_msg=f"dx {coord}")
        if sliced or coord[1] == 0:      # else a copy of model rank 0's
            router += arr[pre + "drouter"]
        blk = slice(coord[1] * e_local, (coord[1] + 1) * e_local)
        for k in experts:
            experts[k][blk] += arr[pre + "d" + k]
    np.testing.assert_allclose(router, ref[pre + "drouter"], **GRAD_TOL)
    for k, v in experts.items():
        np.testing.assert_allclose(v, ref[pre + "d" + k], **GRAD_TOL,
                                   err_msg=k)


def test_ep_block_replicates_over_model_where_rows_are_replicated(runs):
    """Under ``fsdp_tp`` the "model" ranks of one data row hold the same
    rows: their outputs, x gradients and router gradients are equal (the
    gather's backward hands out slices; ``CopyIn`` sums the partial
    router and decode-body x gradients)."""
    ranks, _ = runs
    for case in BLOCKS:
        if case["policy"] == "zero3_sp":
            continue
        pre = case["id"] + "/"
        by_data = {}
        for res, arr in ranks:
            dd = res[case["id"]]["coord"][0]
            by_data.setdefault(dd, []).append(arr)
        for arrs in by_data.values():
            for a in arrs[1:]:
                for k in ("out", "dx", "drouter"):
                    np.testing.assert_array_equal(a[pre + k],
                                                  arrs[0][pre + k])


def test_drop_cases_drop_pairs():
    """The "drop" inputs overfill an expert in either body: every pair
    of nearly equal tokens routes to the same two experts, more of them
    than the capacity (at least 8 a rank) holds."""
    import torch
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    cfg = reduce_for_smoke(get_arch(KIMI))
    for case in BLOCKS:
        if case["input"] != "drop":
            continue
        x = torch.from_numpy(_block_inputs(case, 0)[case["id"] + "/x"])
        d, m = case["mesh"]
        rows = x[:B // d]
        t = rows.shape[0] * (rows.shape[1] // m if case["S"] % m == 0
                             else rows.shape[1])
        p = {"router": torch.from_numpy(
            _block_inputs(case, 0)[case["id"] + "/p/router"])}
        ei, _, _ = moe._route(rows.reshape(-1, rows.shape[-1])[:t],
                              p["router"], cfg.moe)
        cap = moe._capacity(t, cfg.moe.top_k, 4, case["capacity_factor"])
        assert torch.bincount(ei, minlength=4).max().item() > cap


EP_STEPS = [c for c in STEPS if c["kind"] == "ep_step"]


@pytest.mark.parametrize("case", EP_STEPS, ids=[c["id"] for c in EP_STEPS])
def test_ep_steps_match_the_sharded_reference(runs, case):
    ranks, ref = runs
    pre = case["id"] + "/"
    for res, _ in ranks:
        np.testing.assert_allclose(res[case["id"]]["losses"],
                                   ref[pre + "losses"], **FWD_TOL)
    got = ranks[0][1]
    keys = [k for k in ref if k.startswith(pre + "params/")]
    assert keys and all(k in got for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], **MODEL_TOL, err_msg=k)
    if not case.get("prompt"):
        return
    np.testing.assert_allclose(got[pre + "logits"], ref[pre + "logits"],
                               **MODEL_TOL)
    want_pos = case["prompt"] + case["new"]
    assert (got[pre + "cache/pos"] == want_pos).all()
    assert int(ref[pre + "cache/pos"]) == want_pos
    ckeys = [k for k in ref if k.startswith(pre + "cache/")
             and not k.endswith("/pos")]
    assert ckeys
    for k in ckeys:
        np.testing.assert_allclose(got[k], ref[k], **MODEL_TOL, err_msg=k)


def test_zero3_sp_moe_step_matches_the_sharded_reference(runs):
    ranks, ref = runs
    case = next(c for c in STEPS if c["id"] == "kimi-sp")
    pre = case["id"] + "/"
    for res, _ in ranks:
        assert res[case["id"]]["sp"]
        np.testing.assert_allclose(res[case["id"]]["loss"],
                                   ref[pre + "loss"], **FWD_TOL)
    got = ranks[0][1]
    keys = [k for k in ref if k.startswith(pre + "grads/")]
    assert any("/moe/" in k for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[pre + k[len(pre + "grads/"):]],
                                   ref[k], **MODEL_TOL, err_msg=k)


def _expected_collectives(case):
    """(forward, backward) collectives of one rank's ``moe_block``, each a
    sorted list of (kind, payload bytes, ranks), from the case alone: the
    train body's two all-to-alls of the (E r, cap, D) f32 buffer each
    way (cap the reference's ``_capacity`` of the rank's tokens), with,
    where the rows are replicated over "model", the output's all-gather
    and in the backward the x slices' all-gather and the router's
    all-reduce; the decode body's all-reduce of the (b S, D) f32 combine,
    and in the backward the all-reduces of x's and the router's
    gradients."""
    d, m = case["mesh"]
    moe = jax_reduce(jax_get_arch(KIMI)).moe
    D, k = 64, moe.top_k
    cf = case["capacity_factor"] or moe.capacity_factor
    E = case["n_experts"] or 4
    ev, b, S = E * _r(case), B // d, case["S"]
    sliced = case["policy"] == "zero3_sp"
    router = ("all-reduce", D * E * 4, m)
    if S % m == 0 and S > 1:
        s = S // m
        buf = ("all-to-all", ev * _capacity(b * s, k, ev, cf) * D * 4, m)
        if sliced:
            return [buf, buf], [buf, buf]
        rows = ("all-gather", b * s * D * 4, m)
        return sorted([buf, buf, rows]), sorted([buf, buf, rows, router])
    rows = ("all-reduce", b * S * D * 4, m)
    return [rows], sorted([rows, router])


@pytest.mark.parametrize("case", BLOCKS, ids=[c["id"] for c in BLOCKS])
def test_ep_block_collectives(runs, case):
    """Every rank's collectives in the EP ``moe_block``, forward and
    backward, as ``analysis.roofline.ProgramCounter`` counts them
    (``all_to_all_single_autograd`` among them, both ways), against
    ``_expected_collectives``."""
    want_f, want_b = _expected_collectives(case)
    for res, _ in runs[0]:
        got = res[case["id"]]["colls"]
        assert sorted(map(tuple, got["fwd"])) == want_f
        assert sorted(map(tuple, got["bwd"])) == want_b
