"""The sharded train step of ``repro_torch.distributed.steps`` on 4 gloo
processes on the CPU, against the JAX package's mesh-less
``build_train_step`` on the same params and global batch.

The module spawns the 4 ranks once (``util_gloo_worker.py``, rendezvous
through a ``FileStore`` under ``tmp_path``: no port) and runs every case
inside them; the tests read their results. Cases, at smoke size
(stablelm, f32, global batch 4 x 32):

  * the meshes (data 2, model 2) and (data 4, model 1), the policies
    ``fsdp_tp`` and ``dp_only``, the optimizers AdamW and Adafactor
    (``min_dim_factored`` 32: the smoke matrices take the factored
    statistics, and under ``fsdp_tp`` on 2 x 2 both of their last two
    dims are sharded), ``STEPS`` steps: the loss of step 1 and of every
    step within ``FWD_TOL`` of JAX's, every leaf gathered after step 1
    and after the last within ``MODEL_TOL`` (tests/test_torch_steps.py's
    tolerances); each rank's local shard of every param and state leaf
    equals its slice of the gathered leaf;
  * the collectives of one step: those the roofline's counter saw equal
    those it counts of the step on the meta device, and on (4, 1)
    under ``dp_only`` (every gradient all-reduced over 4 ranks) the
    reference's wire formula, 2 * bytes * 3/4;
  * ``Trainer.resume`` from (4, 1) to (2, 2) after 2 steps, then 2 more:
    the losses of a mesh-less port ``Trainer`` run uninterrupted (a mesh
    that leaves ranks out and a failed step's retry across ranks:
    tests/test_torch_elastic.py and tests/test_torch_step_retry.py);
  * prefill and decode on (2, 2): logits and cache gathered equal the
    one-card steps', and the cache is laid out per
    ``cache_sharding_specs``.

And without processes: a moe arch's steps build on a mesh whose "model"
axis is larger than 1, under ``zero3_sp`` too (they run expert-parallel:
tests/test_torch_moe_ep.py runs them on 4 gloo ranks against the
reference); one whose experts and "model" axis do not divide one another
raises ``UserError``; a cache whose batch the data axes do not divide
takes its sequence dim over every axis."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed import steps as jax_steps
from repro.models import make_model as jax_make_model
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import Dist
from repro_torch.errors import UserError
from repro_torch.models import make_model
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from util_gloo import spawn_ranks

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_steps.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
WORLD = 4
STEPS = 3
ARCH = "stablelm-1.6b"
B, S = 4, 32
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
POLICIES = ("fsdp_tp", "dp_only")
OPTS = {"adamw": dict(name="adamw", lr=1e-3),
        "adafactor": dict(name="adafactor", lr=1e-3, min_dim_factored=32)}
RESUME = dict(id="resume", kind="resume", arch=ARCH, mesh=[4, 1],
              to=[2, 2], opt=OPTS["adamw"], batch=B, seq=S, seed=0,
              before=2, after=2)
SERVE = dict(id="serve", kind="serve", arch=ARCH, mesh=[2, 2],
             policy="fsdp_tp", prompt=12, new=4)
WORKER = Path(__file__).resolve().parent / "util_gloo_worker.py"


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _cases():
    out = []
    for mesh, shape in MESHES.items():
        for policy in POLICIES:
            for opt in OPTS:
                out.append(dict(id=f"{mesh}-{policy}-{opt}", kind="step",
                                arch=ARCH, mesh=list(shape), policy=policy,
                                opt=OPTS[opt], steps=STEPS))
    return out + [RESUME, SERVE]


def _initial():
    """The port's smoke params from seed 0 and a global batch (numpy)."""
    cfg = reduce_for_smoke(get_arch(ARCH))
    params = make_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return ({k: v.numpy() for k, v in iter_leaves(params)},
            toks[:, :-1], toks[:, 1:])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every case on 4 gloo ranks once; their results by case id:
    (rank 0's json, rank 0's arrays, every rank's json)."""
    work = tmp_path_factory.mktemp("gloo")
    params, tokens, labels = _initial()
    np.savez(work / "inputs.npz", tokens=tokens, labels=labels,
             **{f"p/{k}": v for k, v in params.items()})
    (work / "cases.json").write_text(json.dumps(_cases()))
    spawn_ranks(WORKER, work, WORLD, timeout=600)
    every = [json.loads((work / f"out-{r}.json").read_text())
             for r in range(WORLD)]
    arrays = dict(np.load(work / "out-0.npz"))
    return every[0], arrays, every, (params, tokens, labels)


@pytest.fixture(scope="module")
def jax_runs(ranks):
    """The JAX package's mesh-less step from the same params and batch:
    per optimizer, the losses and the params after step 1 and the last."""
    params, tokens, labels = ranks[3]
    cfg = jax_reduce(jax_get_arch(ARCH))
    model = jax_make_model(cfg)
    out = {}
    for name, kw in OPTS.items():
        oc = jopt.OptConfig(**kw)
        tree = {}
        for k, v in params.items():
            node = tree
            *parents, last = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(v)
        state = jopt.init_opt_state(oc, tree)
        step = jax.jit(jax_steps.build_train_step(model, oc))
        batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        losses, snaps = [], {}
        for i in range(STEPS):
            tree, state, loss = step(tree, state, batch)
            losses.append(float(loss))
            if i in (0, STEPS - 1):
                snaps[i] = {"/".join(str(p.key) for p in path):
                            np.asarray(v) for path, v in
                            jax.tree_util.tree_flatten_with_path(tree)[0]}
        out[name] = (losses, snaps)
    return out


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_jax(ranks, jax_runs, mesh, policy, opt):
    res, arrays = ranks[0], ranks[1]
    cid = f"{mesh}-{policy}-{opt}"
    losses, snaps = jax_runs[opt]
    got = res[cid]["losses"]
    np.testing.assert_allclose(got[0], losses[0], **FWD_TOL)
    np.testing.assert_allclose(got, losses, **FWD_TOL)
    assert res[cid]["step_count"] == STEPS
    for i in (0, STEPS - 1):
        for k, want in snaps[i].items():
            np.testing.assert_allclose(arrays[f"{cid}/{i}/{k}"], want,
                                       **MODEL_TOL, err_msg=f"{k} {i}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shards_are_slices_of_the_leaves(ranks, mesh):
    for every in ranks[2]:
        for policy in POLICIES:
            for opt in OPTS:
                assert every[f"{mesh}-{policy}-{opt}"]["shards_match"], \
                    (policy, opt)


def test_constrain_redistributes_to_the_spec(ranks):
    """``Dist.constrain`` of a tensor every rank holds alike gives each
    rank its slice; constrained back to ``P()`` it is whole again."""
    for every in ranks[2]:
        for mesh in MESHES:
            assert every[f"{mesh}-fsdp_tp-adamw"]["constrain"], mesh


def test_program_cost_adds_the_step_collectives(ranks):
    """A trainer on a mesh counts its step on the meta device (the rank's
    rows and shards), collectives included: the ``status.perf`` estimate
    of a pjit job on a mesh. Its collectives are those the counter saw
    the real step issue, and its FLOPs the one-card step's on the rank's
    rows (the update on the shards has no products)."""
    res = ranks[0]["resume"]
    cost = res["cost"]
    assert cost["collective_bytes_by_kind"] == res["counted"]
    assert cost["ici_bytes_per_device"] == sum(res["counted"].values()) > 0
    local = make_model(reduce_for_smoke(get_arch(ARCH)),
                       opts=NO_REMAT)
    shape = ShapeSpec("t", S, B // 2, "train")      # (2, 2): 2 data shards
    from repro_torch.analysis.roofline import count_program
    want = count_program(steps.build_train_step(local, OptConfig(
        **RESUME["opt"])), *steps.abstract_inputs(local, shape, OptConfig(
            **RESUME["opt"])))
    assert cost["flops_per_device"] == want["flops_per_device"]


def test_wire_bytes_follow_the_reference_formula():
    from repro_torch.analysis.roofline import (NVLINK_BW, collective_totals,
                                               wire_bytes)
    assert wire_bytes("all-gather", 100, 4) == 300
    assert wire_bytes("reduce-scatter", 100, 4) == 75
    assert wire_bytes("all-to-all", 100, 4) == 75
    assert wire_bytes("all-reduce", 100, 4) == 150
    assert wire_bytes("all-reduce", 100, 1) == 0
    t = collective_totals([("all-gather", 100, 4), ("all-reduce", 8, 2),
                           ("all-reduce", 8, 1)])
    assert t["collective_bytes_by_kind"] == {"all-gather": 300,
                                             "all-reduce": 8}
    assert t["ici_bytes_per_device"] == 308
    assert t["collective_s"] == 308 / NVLINK_BW


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_counted_equal_the_placements(ranks, mesh):
    for every in ranks[2]:
        for policy in POLICIES:
            for opt in OPTS:
                r = every[f"{mesh}-{policy}-{opt}"]
                assert r["counted"] == r["listed"], (policy, opt)
                assert r["counted"], (policy, opt)


def test_dp_only_collective_term_is_the_wire_formula(ranks):
    """(4, 1), dp_only, AdamW: every gradient (f32) all-reduced over 4
    ranks, and the loss: 2 * bytes * (n - 1) / n each; no gather."""
    params = ranks[3][0]
    nbytes = sum(v.size * 4 for v in params.values())
    want = 2.0 * (nbytes + 4) * 3 / 4
    got = ranks[0]["4x1-dp_only-adamw"]["counted"]
    assert got == {"all-reduce": want}


def test_fsdp_tp_collective_term_is_the_wire_formula(ranks):
    """(2, 2), fsdp_tp, AdamW: each leaf gathered from its shards,
    (k - 1) * shard bytes over its k shards; each gradient
    reduce-scattered over "data" after its "model" slice where "data"
    shards it ((1/2) * bytes / model shards), else all-reduced (2 * 1/2
    of that); the loss all-reduced over "data"."""
    d = Dist(mesh=FakeMesh({"data": 2, "model": 2})).resolve_batch(B)
    model = make_model(reduce_for_smoke(get_arch(ARCH)), d,
                       NO_REMAT)
    ag = rs = ar = 0.0
    for path, s in iter_leaves(model.param_specs()):
        n = ranks[3][0][path].size * 4
        axes = [a for ax in s if ax for a in
                ((ax,) if isinstance(ax, str) else ax)]
        k = 2 ** len(axes)
        ag += (k - 1) * n / k
        after_model = n / (2 if "model" in axes else 1)
        if "data" in axes:
            rs += after_model / 2
        else:
            ar += 2 * after_model / 2
    ar += 2 * 4 / 2
    got = ranks[0]["2x2-fsdp_tp-adamw"]["counted"]
    assert got == {"all-gather": ag, "reduce-scatter": rs,
                   "all-reduce": ar}


def test_resume_between_meshes_continues_the_run(ranks, tmp_path):
    res = ranks[0]["resume"]
    assert res["resumed_at"] == RESUME["before"]
    assert res["mesh_after"] == RESUME["to"]
    tr = Trainer(reduce_for_smoke(get_arch(ARCH)), Dist(),
                 OptConfig(**RESUME["opt"]),
                 TrainerConfig(batch=B, seq=S, ckpt_dir=str(tmp_path)),
                 device="cpu").init(RESUME["seed"])
    n = RESUME["before"] + RESUME["after"]
    want = [tr.step_once(tr._batch(s)) for s in range(n)]
    np.testing.assert_allclose(res["losses"], want, **FWD_TOL)
    for every in ranks[2]:
        np.testing.assert_allclose(every["resume"]["losses"], want,
                                   **FWD_TOL)


def test_sharded_prefill_and_decode_match_one_card(ranks):
    assert all(r["serve"]["cache_layout"] for r in ranks[2])
    arrays = ranks[1]
    params, tokens, _ = ranks[3]
    cfg = reduce_for_smoke(get_arch(ARCH))
    model = make_model(cfg, opts=NO_REMAT)
    tree = {}
    for k, v in params.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(v.copy())
    prompt = torch.from_numpy(tokens[:, :SERVE["prompt"]]).long()
    cache = model.empty_cache(B, SERVE["prompt"] + SERVE["new"], "cpu")
    logits, cache = steps.build_prefill_step(model)(
        tree, {"tokens": prompt}, cache=cache, slots=torch.arange(B))
    got = [logits]
    decode = steps.build_decode_step(model)
    for _ in range(SERVE["new"]):
        logits, cache = decode(tree, cache, {"tokens": got[-1].argmax(-1)})
        got.append(logits)
    np.testing.assert_allclose(arrays["serve/logits"],
                               torch.cat(got, 1).numpy(), **FWD_TOL)
    for k, v in cache.items():
        np.testing.assert_allclose(arrays[f"serve/cache/{k}"], v.numpy(),
                                   **FWD_TOL, err_msg=k)


def _shape():
    return ShapeSpec("t", S, B, "train")


def test_moe_steps_build_on_an_expert_axis():
    """The expert-parallel steps build for a "model" axis of 2 (4
    experts, 2 a rank) and of 8 (2 copies of each), of 1, and under
    ``dp_only``. The steps on a real mesh: tests/test_torch_moe_ep.py."""
    cfg = reduce_for_smoke(get_arch("grok-1-314b"))
    opt = OptConfig()
    for m in (2, 8):
        wide = Dist(mesh=FakeMesh({"data": 2, "model": m})).resolve_batch(B)
        for build in (lambda mm: steps.jit_train_step(mm, opt, _shape()),
                      lambda mm: steps.jit_prefill_step(mm, _shape()),
                      lambda mm: steps.jit_decode_step(mm, _shape())):
            assert callable(build(make_model(cfg, wide)))
    narrow = Dist(mesh=FakeMesh({"data": 4, "model": 1})).resolve_batch(B)
    assert callable(steps.jit_train_step(make_model(cfg, narrow), opt,
                                         _shape()))
    dp = Dist(mesh=FakeMesh({"data": 2, "model": 2}),
              policy="dp_only").resolve_batch(B)
    assert callable(steps.jit_train_step(make_model(cfg, dp), opt,
                                         _shape()))


def test_moe_with_an_expert_axis_raises():
    """A "model" axis of 3 neither divides grok-1's 4 smoke experts nor
    holds whole copies of them: every step raises ``UserError``."""
    cfg = reduce_for_smoke(get_arch("grok-1-314b"))
    odd = Dist(mesh=FakeMesh({"data": 1, "model": 3})).resolve_batch(B)
    for build in (lambda mm: steps.jit_train_step(mm, OptConfig(), _shape()),
                  lambda mm: steps.jit_prefill_step(mm, _shape()),
                  lambda mm: steps.jit_decode_step(mm, _shape())):
        with pytest.raises(UserError, match="do not split"):
            build(make_model(cfg, odd))


def test_zero3_sp_steps_build():
    """``zero3_sp`` keeps the expert axis on "model": a moe arch's steps
    build under it on a "model" axis of 2 (expert-parallel, the rows the
    rank's slice where the step is sequence-parallel: run on 4 gloo
    ranks in tests/test_torch_moe_ep.py) and of 1; a dense arch builds
    under it (its sequence-parallel step: tests/test_torch_sp.py)."""
    moe = reduce_for_smoke(get_arch("grok-1-314b"))
    wide = Dist(mesh=FakeMesh({"data": 2, "model": 2}),
                policy="zero3_sp").resolve_batch(B)
    for build in (lambda m: steps.jit_train_step(m, OptConfig(), _shape()),
                  lambda m: steps.jit_decode_step(m, _shape())):
        assert callable(build(make_model(moe, wide)))
    narrow = Dist(mesh=FakeMesh({"data": 4, "model": 1}),
                  policy="zero3_sp").resolve_batch(B)
    assert callable(steps.jit_train_step(make_model(moe, narrow),
                                         OptConfig(), _shape()))
    dense = reduce_for_smoke(get_arch(ARCH))
    assert callable(steps.jit_train_step(make_model(dense, wide),
                                         OptConfig(), _shape()))


def test_zero3_sp_raises():
    """Under ``zero3_sp`` a moe arch on a "model" axis of 3, which does
    not divide its 4 experts, raises ``UserError``."""
    moe = reduce_for_smoke(get_arch("grok-1-314b"))
    odd = Dist(mesh=FakeMesh({"data": 1, "model": 3}),
               policy="zero3_sp").resolve_batch(B)
    for build in (lambda m: steps.jit_train_step(m, OptConfig(), _shape()),
                  lambda m: steps.jit_decode_step(m, _shape())):
        with pytest.raises(UserError, match="do not split"):
            build(make_model(moe, odd))


def test_cache_of_an_indivisible_batch_raises():
    """Nothing raises any more for a batch the data axes do not divide
    (B = 1 on 2 x 2): its prefill and decode steps build, every rank
    takes every row, and the cache takes its sequence dim over every
    axis, as the reference's (``model.py:175-200``).
    tests/test_torch_dryrun.py runs such steps on 4 gloo ranks against
    the one-card steps."""
    cfg = reduce_for_smoke(get_arch(ARCH))
    d = Dist(mesh=FakeMesh({"data": 2, "model": 2})).resolve_batch(1)
    model = make_model(cfg, d, NO_REMAT)
    assert not d.batch_axes
    shape = ShapeSpec("p", S, 1, "prefill")
    assert callable(steps.jit_prefill_step(model, shape))
    assert callable(steps.jit_decode_step(model, shape))
    specs = model.cache_sharding_specs(1)
    assert tuple(specs["k"])[2] == ("data", "model")
    assert all(ax in (None, ("data", "model")) for ax in tuple(specs["k"]))


def test_without_a_mesh_the_steps_are_the_one_card_steps():
    m = make_model(reduce_for_smoke(get_arch(ARCH)))
    assert steps.jit_train_step(m, OptConfig(), _shape()).__qualname__ \
        .startswith("build_train_step")
    assert steps.jit_decode_step(m, _shape()).__qualname__ \
        .startswith("build_decode_step")
