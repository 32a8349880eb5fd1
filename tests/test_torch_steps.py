"""The port's model-level steps (``repro_torch.distributed.steps``) and
optimizers (``repro_torch.optim.optimizers``) against the JAX package's
on the same inputs, on the CPU.

Optimizers: the four tree optimizers over ``STEPS`` steps on f32 and on
bf16 params, from one set of numpy params and gradients, and the flat
shard optimizers. Tolerances: f32 at ``OPT_TOL`` (1e-5: the same f32
arithmetic, summed in other orders only by Adafactor's means); bf16
params within one bf16 rounding step of the reference's (``BF16_TOL``,
2^-7 relative: an f32 value one ulp either side of a bf16 tie may round
the other way), and the f32 state at ``OPT_TOL``.

Train steps: ``build_train_step`` at ``grad_accum`` 1 and 2 for the
dense (stablelm), encdec (whisper) and vlm (qwen2-vl, ``embeds``)
smoke models from one JAX-initialised flat vector, two momentum-SGD
steps each (``STEP_OPT``): the losses at ``FWD_TOL`` and the params at
``MODEL_TOL`` (1e-4, as tests/test_torch_model.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed import steps as jax_steps
from repro.distributed.sharding import Dist
from repro.models import make_model as jax_make_model
from repro.optim import optimizers as jopt
from repro.runtime.learner import _flat_io
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.models import make_model
from repro_torch.models.layers import iter_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.weights import flat_from_params, params_from_flat
from util_parity import vision_positions

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

OPT_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-6, rtol=2 ** -7)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_training.py
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
OPTS = {"remat": "none", "xent_chunk": 512, "q_chunk": 32, "k_chunk": 32}
STEPS = 3
# leaf shapes: adafactor factors the first two (both trailing dims >= 128)
# and keeps full second moments for the rest
SHAPES = {"a": {"w": (130, 140), "stack": (2, 128, 129)},
          "b": (4, 200), "c": (7,)}
OPTIMIZERS = [
    dict(name="sgd", lr=0.05),
    dict(name="momentum", lr=0.05, momentum=0.8),
    dict(name="adamw", lr=1e-2, weight_decay=0.1),
    dict(name="adafactor", lr=1e-2, weight_decay=0.1),
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(fn, shapes=SHAPES, path=""):
    return {k: (_tree(fn, v, f"{path}{k}/") if isinstance(v, dict)
                else fn(f"{path}{k}", v)) for k, v in shapes.items()}


def _leaves(tree):
    return [t for _, t in iter_leaves(tree)]


def _numpy_trees(seed):
    rng = np.random.RandomState(seed)
    params = _tree(lambda _p, s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda _p, s: rng.standard_normal(s).astype(np.float32)
                   * 0.1) for _ in range(STEPS)]
    return params, grads


# ---------------------------------------------------------------------------
# Tree optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kw", OPTIMIZERS, ids=lambda kw: kw["name"])
def test_apply_updates_matches_jax(kw, dtype):
    tdt, jdt = DTYPES[dtype]
    np_params, np_grads = _numpy_trees(0)
    jcfg, cfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), np_params)
    tp = _tree(lambda p, _s: torch.tensor(_get(np_params, p), dtype=tdt))
    jstate = jopt.init_opt_state(jcfg, jp)
    state = topt.init_opt_state(cfg, tp)
    assert [tuple(t.shape) for t in _leaves(state)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jstate)]
    upd = jax.jit(lambda p, g, s: jopt.apply_updates(jcfg, p, g, s))
    for g in np_grads:
        jp, jstate = upd(jp, jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
                         jstate)
        tg = _tree(lambda p, _s: torch.tensor(_get(g, p), dtype=tdt))
        tp, state = topt.apply_updates(cfg, tp, tg, state)
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    assert all(t.dtype == tdt for t in _leaves(tp))
    tol = OPT_TOL if dtype == "float32" else BF16_TOL
    for t, a in zip(_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(t), _np(a), **tol)
    for key in state:
        if key != "step":
            for t, a in zip(_leaves(state[key]),
                            jax.tree.leaves(jstate[key])):
                np.testing.assert_allclose(_np(t), _np(a), **OPT_TOL)
    moved = max(np.abs(_np(t) - _get(np_params, p)).max()
                for p, t in iter_leaves(tp))
    assert moved > 1e-3


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_adafactor_factors_by_min_dim():
    """Row and column statistics for leaves whose last two dims are both
    >= ``min_dim_factored``; the full second moment (and a (0,) column
    marker) otherwise, as the reference."""
    tp = _tree(lambda _p, s: torch.zeros(s))
    state = topt.init_opt_state(topt.OptConfig(name="adafactor"), tp)
    shapes = {p: tuple(t.shape) for p, t in iter_leaves(state["vr"])}
    assert shapes == {"a/stack": (2, 128), "a/w": (130,), "b": (4, 200),
                      "c": (7,)}
    shapes = {p: tuple(t.shape) for p, t in iter_leaves(state["vc"])}
    assert shapes == {"a/stack": (2, 129), "a/w": (140,), "b": (0,),
                      "c": (0,)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kw", OPTIMIZERS[:3], ids=lambda kw: kw["name"])
def test_flat_update_matches_jax(kw, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    p0 = rng.standard_normal(1000).astype(np.float32)
    jcfg, cfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp, tp = jnp.asarray(p0, jdt), torch.tensor(p0, dtype=tdt)
    jstate, state = jopt.flat_init(jcfg, 1000), topt.flat_init(cfg, 1000)
    for _ in range(STEPS):
        g = rng.standard_normal(1000).astype(np.float32) * 0.1
        jp, jstate = jopt.flat_update(jcfg, jp, jnp.asarray(g, jdt), jstate)
        tp, state = topt.flat_update(cfg, tp, torch.from_numpy(g).to(tdt),
                                     state)
    assert tp.dtype == tdt and int(state["step"]) == STEPS
    np.testing.assert_allclose(
        _np(tp), _np(jp), **(OPT_TOL if dtype == "float32" else BF16_TOL))
    for key in set(state) - {"step"}:
        np.testing.assert_allclose(_np(state[key]), _np(jstate[key]),
                                   **OPT_TOL)


def test_flat_init_refuses_adafactor():
    with pytest.raises(ValueError, match="elementwise"):
        topt.flat_init(topt.OptConfig(name="adafactor"), 8)
    with pytest.raises(ValueError, match="elementwise"):
        jopt.flat_init(jopt.OptConfig(name="adafactor"), 8)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b",
                                  "stablelm-1.6b", "grok-1-314b",
                                  "jamba-1.5-large-398b"])
def test_default_optimizer_matches_jax(arch):
    got = steps.default_optimizer(get_arch(arch))
    want = jax_steps.default_optimizer(jax_get_arch(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_expert_grad_tie_is_the_identity_on_one_card():
    cfg = reduce_for_smoke(get_arch("grok-1-314b"))
    g = {"w": torch.ones(2)}
    assert steps.expert_grad_tie(cfg, make_model(cfg))(g) is g


class _FakeMesh:
    """The spec engine's duck-typed mesh: axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _nested(flat, conv):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[last] = conv(v)
    return tree


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_expert_grad_tie_with_copies(arch):
    """2 experts on a "model" axis of 4: two copies of each, whose
    gradients the tie replaces by their mean on the experts' dim; the
    router and every other leaf untouched. kimi-k2 (moe leaves (L = 2,
    E r = 4, ...)) against the reference's tie, leaf for leaf. jamba
    against the mean over copies computed here: the reference's tie
    averages the first dim of size E * r of any wg/wu/wd under "blocks",
    which for jamba's smoke period is the layer dim of the moe leaves
    (np, 4 moe layers, E r = 4, ...) and of the SwiGLU stack
    ``blocks/mlp/*`` (4 layers) as well."""
    from repro_torch.distributed.sharding import Dist as TDist
    jcfg = jax_reduce(jax_get_arch(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=2))
    cfg = reduce_for_smoke(get_arch(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=2))
    mesh = {"data": 1, "model": 4}
    tm = make_model(cfg, TDist(mesh=_FakeMesh(mesh)))
    rng = np.random.default_rng(0)
    defs = dict(iter_leaves(tm.param_defs()))
    grads = {p: rng.standard_normal(d.shape).astype(np.float32)
             for p, d in defs.items()}
    assert grads["blocks/moe/wg"].shape[-3] == 4         # E * r
    got = dict(iter_leaves(steps.expert_grad_tie(cfg, tm)(
        _nested(grads, torch.from_numpy))))
    assert set(got) == set(grads)
    if arch.startswith("kimi"):
        jm = jax_make_model(jcfg, Dist(mesh=_FakeMesh(mesh)))
        want = {"/".join(str(q.key) for q in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jax_steps.expert_grad_tie(jcfg, jm)(
                        _nested(grads, jnp.asarray)))[0]}
    else:
        want = {}
        for k, g in grads.items():
            if "/moe/" in k and not k.endswith("router"):
                i = defs[k].dims.index("expert")
                gr = g.reshape(g.shape[:i] + (2, 2) + g.shape[i + 1:])
                g = np.broadcast_to(gr.mean(i + 1, keepdims=True),
                                    gr.shape).reshape(g.shape)
            want[k] = g
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        tied = "/moe/" in k and not k.endswith("router")
        assert tied != np.array_equal(v.numpy(), grads[k]), k


def _setup(arch, seed=0):
    jcfg = jax_reduce(jax_get_arch(arch))
    cfg = reduce_for_smoke(get_arch(arch))
    jm = jax_make_model(jcfg, Dist(), dict(OPTS))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    ravel, unravel = _flat_io(shapes)
    flat = np.asarray(ravel(jm.init(jax.random.PRNGKey(seed))))
    return jcfg, cfg, jm, unravel, flat


def _batches(cfg, n, B=4, S=16):
    """``n`` training batches of ``cfg``'s family, numpy from a seed:
    encdec frames (B, 24, D) and tokens; vlm embeds with M-RoPE
    positions that are not a broadcast of 0..S-1; dense tokens."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1))
        b = {"labels": toks[:, 1:]}
        if cfg.family == "encdec":
            b["enc_embeds"] = rng.standard_normal(
                (B, 24, cfg.d_model)).astype(np.float32)
            b["tokens"] = toks[:, :-1]
        elif cfg.frontend != "none":
            b["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        else:
            b["tokens"] = toks[:, :-1]
        if cfg.mrope:
            b["positions"] = vision_positions(B, S, grid=2)
        out.append(b)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


# The step is held with momentum SGD, whose update carries the two
# gradients' difference linearly. AdamW's first steps map a gradient
# that is zero up to rounding (an embedding row at ~1e-8) to ~+-lr, its
# sign set by the summation order, so at the step level it tells
# nothing about the step; ``apply_updates``'s AdamW is held above on
# exactly equal inputs. Positions (3, B, S) at grad_accum 2: the
# reference's split cuts their leading dim of 3, so that case runs on
# embeds without positions.
STEP_OPT = dict(name="momentum", lr=1e-2)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-large-v3",
                                  "qwen2-vl-2b"])
def test_train_step_matches_jax(arch, grad_accum):
    jcfg, cfg, jm, unravel, flat = _setup(arch)
    oc = STEP_OPT
    jstep = jax.jit(jax_steps.build_train_step(
        jm, jopt.OptConfig(**oc), grad_accum))
    step = steps.build_train_step(make_model(cfg, opts=NO_REMAT),
                                  topt.OptConfig(**oc),
                                  grad_accum)
    jp = unravel(jnp.asarray(flat))
    tp = params_from_flat(flat, cfg, device="cpu")
    jstate = jopt.init_opt_state(jopt.OptConfig(**oc), jp)
    state = topt.init_opt_state(topt.OptConfig(**oc), tp)
    for b in _batches(cfg, 2):
        if grad_accum > 1:
            b.pop("positions", None)
        jp, jstate, jl = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        tp, state, loss = step(tp, state, _torch_batch(b))
        np.testing.assert_allclose(loss.item(), float(jl), **FWD_TOL)
    want = np.asarray(jax.jit(lambda p: jnp.concatenate(
        [jnp.ravel(x).astype(jnp.float32) for x in jax.tree.leaves(p)]))(
        jp))
    got = flat_from_params(tp)
    assert np.abs(got - flat).max() > 1e-4                   # it moved
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_grad_accum_splits_mrope_positions_on_the_batch_dim():
    """The port splits (3, B, S) positions on dim 1: two micro-batches
    give the mean of the two halves' losses, each with its own rows'
    positions."""
    cfg = reduce_for_smoke(get_arch("qwen2-vl-2b"))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    b = _torch_batch(_batches(cfg, 1)[0])
    parts = steps.split_batch(b, 2)
    assert parts[1]["positions"].shape == (3, 2, 16)
    assert torch.equal(parts[1]["positions"], b["positions"][:, 2:])
    want = sum(model.loss(params, p) for p in parts) / 2
    state = topt.init_opt_state(topt.OptConfig(name="sgd", lr=0.0), params)
    _, _, loss = steps.build_train_step(
        model, topt.OptConfig(name="sgd", lr=0.0), 2)(params, state, b)
    np.testing.assert_allclose(loss.item(), want.item(), **FWD_TOL)
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        steps.split_batch(b, 3)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_prefill_and_decode_steps_match_the_model(arch):
    _, cfg, _, _, flat = _setup(arch)
    model = make_model(cfg, opts=NO_REMAT)
    params = params_from_flat(flat, cfg, device="cpu")
    b = _torch_batch(_batches(cfg, 1, B=2)[0])
    b.pop("labels")
    logits, cache = steps.build_prefill_step(model)(params, b)
    want, wcache = model.prefill(params, b)
    assert torch.equal(logits, want)
    tok = {"tokens": torch.tensor([[3], [5]])}
    got, _ = steps.build_decode_step(model)(params, cache, tok)
    want, _ = model.decode(params, wcache, tok)
    assert torch.equal(got, want) and not got.requires_grad


# the reference's shapes of one step at these sizes (train splits S
# between encoder and decoder for encdec)
SPECS = [ShapeSpec("t", 64, 4, "train"), ShapeSpec("p", 64, 2, "prefill"),
         ShapeSpec("d", 64, 2, "decode")]


@pytest.mark.parametrize("shape", SPECS, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b",
                                  "stablelm-1.6b"])
def test_abstract_inputs_match_jax(arch, shape):
    """Every leaf's shape and dtype, on the meta device; token ids are
    int64 where JAX's are int32, and the cache's ``pos`` is per slot."""
    jcfg, cfg = jax_reduce(jax_get_arch(arch)), reduce_for_smoke(
        get_arch(arch))
    jargs = jax_steps.abstract_inputs(
        jax_make_model(jcfg, Dist()), JaxShapeSpec(*dataclasses.astuple(
            shape)))
    args = steps.abstract_inputs(make_model(cfg), shape)
    assert len(args) == len(jargs)
    for i, (tree, jtree) in enumerate(zip(args, jargs)):
        jleaves = dict((("/".join(str(getattr(k, "key", k)) for k in p), l)
                        for p, l in jax.tree_util.tree_flatten_with_path(
                            jtree)[0]))
        leaves = dict(iter_leaves(tree))
        assert sorted(leaves) == sorted(jleaves)
        for path, t in leaves.items():
            j = jleaves[path]
            assert t.is_meta, path
            if path == "pos":
                assert t.shape == (shape.global_batch,) and j.shape == ()
                continue
            assert tuple(t.shape) == tuple(j.shape), path
            want = str(j.dtype)
            if i == len(args) - 1:                   # the batch
                want = want.replace("int32", "int64")
            assert str(t.dtype).replace("torch.", "") == want, path
