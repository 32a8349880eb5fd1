"""The port's vlm family fed with a stub frontend's ``embeds`` and M-RoPE
``(3, B, S)`` positions (qwen2-vl-2b) against the JAX package on the
same inputs and weights, at the qwen2-vl smoke reduction (2 layers,
d_model 64, 4 heads over 2 KV heads of hd 16, M-RoPE sections (2, 3,
3), qkv bias, f32): the loss and every gradient leaf, prefill logits and
K/V, batched decode of two slots at their own positions (tokens, and
``embeds``), the count of the steps on the meta device against the
reference's HLO, and the full-width model's size and counts.

Positions are those of an image at the start of each sequence ((t, h,
w) of a patch grid, text after it from max + 1, each slot shifted), so
no section equals another and none is a broadcast of 0..S-1. Every case
starts from one flat vector of the reference model's
``init(PRNGKey(0))``. Tolerances: the model at ``MODEL_TOL`` (1e-4, as
tests/test_torch_model.py), the loss and gradient at ``FWD_TOL`` /
``GRAD_TOL`` of tests/test_torch_training.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.models import make_model as jax_make_model
from repro.runtime.learner import _flat_io
from repro_torch.analysis import roofline
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.models import layers as tl
from repro_torch.models import make_model
from repro_torch.weights import flat_size, params_from_flat
from util_parity import vision_positions

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

ARCH = "qwen2-vl-2b"
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_training.py
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
OPTS = {"remat": "none", "xent_chunk": 512, "q_chunk": 32, "k_chunk": 32}
B, S, GRID = 2, 24, 3
# the port's counts of the smoke steps over the reference's HLO counts
# (B 2, S 24): the kernels' formulas skip the causal mask's upper half,
# which the reference's jnp attention computes, and K4b recomputes the
# scores, which its VJP keeps
HLO_RATIO = {"train": 1.0208333333333333, "prefill": 0.9634533898305084}
DECODE_FLOPS_RTOL = 0.01   # tests/test_torch_roofline.py
# the port's count of the full-width steps over the reference's
# ``model_flops``, which charges every parameter to every token: the
# token table (233 M of 1.78 B) is a gather, and prefill's head
# multiplies the last position only
FULL_WIDTH_RATIO = {"train": 0.9244059135239359,
                    "prefill": 0.7497629809898916,
                    "decode": 0.8804467493032648}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce(jax_get_arch(ARCH))
    cfg = reduce_for_smoke(get_arch(ARCH))
    jm = jax_make_model(jcfg, Dist(), dict(OPTS))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ravel, unravel = _flat_io(shapes)
    flat = np.asarray(ravel(jm.init(jax.random.PRNGKey(0))))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, flat=flat,
                jparams=unravel(jnp.asarray(flat)),
                model=make_model(cfg, opts=NO_REMAT),
                params=params_from_flat(flat, cfg, device="cpu"))


def _inputs(cfg, seed, b=B, s=S):
    rng = np.random.RandomState(seed)
    emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, size=(b, s))
    return emb, vision_positions(b, s, GRID), labels


def _t(x):
    return torch.from_numpy(x).long() if x.dtype.kind == "i" \
        else torch.from_numpy(x)


def test_positions_are_not_a_broadcast():
    pos = vision_positions(B, S, GRID)
    assert pos.shape == (3, B, S)
    assert not np.array_equal(pos[0], pos[1])
    assert not np.array_equal(pos[1], pos[2])
    assert not np.array_equal(pos[0, 0], np.arange(S))
    assert pos[0, 0, GRID * GRID] == GRID        # text after max + 1


def test_loss_and_every_gradient_leaf_match_jax(setup):
    emb, pos, labels = _inputs(setup["cfg"], 1)
    batch = {"embeds": emb, "positions": pos, "labels": labels}
    jloss, jgrads = jax.value_and_grad(setup["jm"].loss)(
        setup["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = steps.value_and_grad(setup["model"], setup["params"],
                                       {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    leaves = list(tl.iter_leaves(grads))
    assert [p for p, _ in leaves] == [
        "/".join(k.key for k in path) for path, _ in jleaves]
    for (path, g), (_, jg) in zip(leaves, jleaves):
        np.testing.assert_allclose(_np(g), _np(jg), err_msg=path,
                                   **GRAD_TOL)
    # the token table is not read under embeds: zero in both
    assert not np.any(_np(grads["embed"])) and not np.any(
        _np(jgrads["embed"]))
    # the positions matter: broadcast 0..S-1 gives another loss
    other = dict(batch, positions=np.broadcast_to(
        np.arange(S, dtype=np.int32), (3, B, S)).copy())
    assert abs(setup["model"].loss(setup["params"], {
        k: _t(v) for k, v in other.items()}).item() - loss.item()) > 1e-4


def _prefill(setup, emb, pos):
    jlog, jcache = setup["jm"].prefill(
        setup["jparams"], {"embeds": jnp.asarray(emb),
                           "positions": jnp.asarray(pos)})
    with torch.no_grad():
        logits, cache = setup["model"].prefill(
            setup["params"], {"embeds": _t(emb), "positions": _t(pos)})
    return (jlog, jcache), (logits, cache)


def test_prefill_matches_jax(setup):
    emb, pos, _ = _inputs(setup["cfg"], 2)
    (jlog, jcache), (logits, cache) = _prefill(setup, emb, pos)
    np.testing.assert_allclose(_np(logits), _np(jlog), **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   err_msg=key, **MODEL_TOL)
    assert cache["pos"].tolist() == [S] * B


def _pad(jcache, n):
    out = dict(jcache)
    for key in ("k", "v"):
        out[key] = jnp.pad(out[key], [(0, 0), (0, 0), (0, n), (0, 0),
                                      (0, 0)])
    return out


@pytest.mark.parametrize("feed", ["tokens", "embeds"])
def test_two_slots_decode_at_their_own_positions(setup, feed):
    """Slots prefilled with embeds of 13 and 24 positions (each alone),
    written into one batched cache of 28 positions, then two decode steps
    of ``feed`` in one call, against JAX decoding each slot alone. The
    decode's M-RoPE position is the cache position in all three sections,
    as in the reference's ``attn_decode``."""
    cfg, jm, jp, model = setup["cfg"], setup["jm"], setup["jparams"], \
        setup["model"]
    lens, M = (13, 24), 28
    cache = model.empty_cache(B, M, "cpu")
    jcaches = []
    rng = np.random.RandomState(3)
    for b, n in enumerate(lens):
        emb, pos, _ = _inputs(cfg, 10 + b, b=1, s=n)
        _, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                                "positions": jnp.asarray(pos)})
        jcaches.append(_pad(jc, M - n))
        with torch.no_grad():
            model.prefill(setup["params"], {"embeds": _t(emb),
                                            "positions": _t(pos)},
                          cache=cache, slots=torch.tensor([b]))
    assert cache["pos"].tolist() == list(lens)
    for _ in range(2):
        if feed == "tokens":
            x = rng.randint(0, cfg.vocab_size, size=(B, 1))
        else:
            x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        with torch.no_grad():
            logits, cache = model.decode(setup["params"], cache,
                                         {feed: _t(x)})
        for b in range(B):
            jlog, jcaches[b] = jm.decode(jp, jcaches[b],
                                         {feed: jnp.asarray(x[b:b + 1])})
            np.testing.assert_allclose(_np(logits[b:b + 1]), _np(jlog),
                                       **MODEL_TOL)
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    _np(cache[key][:, b:b + 1]), _np(jcaches[b][key]),
                    err_msg=key, **MODEL_TOL)
    assert cache["pos"].tolist() == [n + 2 for n in lens]


def _hlo_flops(fn, *args):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return jax_roofline.analyze_hlo_text(
        txt, jax_roofline.KERNEL_SCOPES)["flops_per_device"]


def test_step_counts_match_the_reference_hlo(setup):
    """The loss and gradient, prefill and a decode step of 2 slots over a
    cache of S, counted on the meta device against the reference's HLO
    of the same steps: train and prefill at ``HLO_RATIO``, decode within
    ``DECODE_FLOPS_RTOL``."""
    emb, pos, labels = _inputs(setup["cfg"], 4)
    jm, jp, model = setup["jm"], setup["jparams"], setup["model"]
    batch = {"embeds": emb, "positions": pos, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    aps = model.abstract_params()
    want = _hlo_flops(jax.value_and_grad(jm.loss), jp, jb)
    got = roofline.count_program(
        lambda p, b: steps.value_and_grad(model, p, b), aps, tb)
    assert got["flops_per_device"] / want == pytest.approx(
        HLO_RATIO["train"], rel=1e-9)
    jb.pop("labels")
    tb.pop("labels")
    want = _hlo_flops(jm.prefill, jp, jb)
    got = roofline.count_program(lambda p, b: model.prefill(p, b), aps, tb)
    assert got["flops_per_device"] / want == pytest.approx(
        HLO_RATIO["prefill"], rel=1e-9)
    _, jcache = jm.prefill(jp, jb)
    tok = np.zeros((B, 1), np.int32)
    want = _hlo_flops(jm.decode, jp, jcache, {"tokens": jnp.asarray(tok)})
    args = steps.abstract_inputs(model, ShapeSpec("d", S, B, "decode"))
    got = roofline.count_program(steps.build_decode_step(model), *args)
    assert abs(got["flops_per_device"] - want) <= DECODE_FLOPS_RTOL * want


def test_full_width_size_and_counts():
    """qwen2-vl-2b at full width and depth, on the meta device: the flat
    vector's size against the reference's tree and ``_count_params``
    (which leaves out the final norm's d_model), and the train, prefill
    and decode steps of the reference's shapes (S 2,048, 2 sequences,
    embeds and positions) at ``FULL_WIDTH_RATIO`` of ``model_flops``."""
    from repro.configs.base import _count_params
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    shapes = jax.eval_shape(jax_make_model(jcfg, Dist()).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape, dtype=np.int64))
               for l in jax.tree.leaves(shapes))
    assert flat_size(cfg) == want == 1_777_088_000
    assert want - _count_params(jcfg, False) == cfg.d_model
    model = make_model(cfg, opts=NO_REMAT)
    for kind, fn in (("train", steps.build_train_step(
                         model, steps.default_optimizer(cfg))),
                     ("prefill", steps.build_prefill_step(model)),
                     ("decode", steps.build_decode_step(model))):
        shape = ShapeSpec(kind, 2048, 2, kind)
        got = roofline.count_program(fn, *steps.abstract_inputs(model,
                                                                shape))
        assert got["flops_per_device"] / roofline.model_flops(
            cfg, shape) == pytest.approx(FULL_WIDTH_RATIO[kind], rel=1e-9)
