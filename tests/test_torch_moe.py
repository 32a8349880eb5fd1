"""The port's moe family (grok-1, kimi-k2) against the JAX package on the
same inputs and weights, at smoke size (4 experts, top-2, d_ff_expert
64, f32): the flat layout, the capacity rule, the slot bookkeeping of
the sort-based dispatch (exactly, drops and ties included), the block
against ``_moe_single`` and the plain ``moe_ref``, the training loss and
its gradient, prefill / decode and the caches, a batched decode beyond
the capacity against the reference's per-slot decode, ``count_program``
of a decode step on the meta device, and ``init_leaf``'s draws.

Tolerances: the block and the model at ``MODEL_TOL`` (1e-4, as
tests/test_torch_model.py); in bfloat16 the block at a relative L2 of
``BF16_REL_L2`` = 2e-2 (a few roundings of 2^-8 at other points of the
SwiGLU); ``moe_ref`` against the block at 1e-6 in float32 (the same
products, summed in another order); the loss and gradient at
``FWD_TOL`` / ``GRAD_TOL`` of tests/test_torch_training.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import _count_params
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.models import make_model as jax_make_model
from repro.models import moe as jmoe
from repro.runtime.learner import LMPlugin as JaxLMPlugin
from repro.runtime.learner import _flat_io
from repro_torch.analysis.roofline import count_program
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as tl
from repro_torch.models import make_model
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ParamDef, init_leaf, map_leaves
from repro_torch.models.transformer import layer_params
from repro_torch.runtime.learner import LMPlugin
from repro_torch.serving.engine import InferenceEngine
from repro_torch.weights import flat_layout, flat_size, params_from_flat
from util_poll import wait_until

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_training.py
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
REF_TOL = dict(atol=1e-6, rtol=1e-6)
BF16_REL_L2 = 2e-2
OPTS = {"remat": "none", "xent_chunk": 32, "q_chunk": 32, "k_chunk": 32}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jax_shapes(jcfg):
    return jax.eval_shape(jax_make_model(jcfg, Dist(), dict(OPTS)).init,
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """One JAX-initialised flat vector loaded into both packages."""
    arch = request.param
    jcfg = jax_reduce(jax_get_arch(arch))
    jmodel = jax_make_model(jcfg, Dist(), dict(OPTS))
    ravel, unravel = _flat_io(_jax_shapes(jcfg))
    flat = np.array(ravel(jmodel.init(jax.random.PRNGKey(1))))
    cfg = reduce_for_smoke(get_arch(arch))
    return dict(arch=arch, jcfg=jcfg, jmodel=jmodel,
                jparams=unravel(jnp.asarray(flat)), cfg=cfg,
                model=make_model(cfg, opts=NO_REMAT),
                params=params_from_flat(flat, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# Layout and capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_matches_jax_flat_io(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    shapes = _jax_shapes(jax_reduce(jax_get_arch(arch)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want, off = [], 0
    for path, leaf in leaves:
        want.append(("/".join(p.key for p in path), tuple(leaf.shape), off))
        off += int(np.prod(leaf.shape))
    assert flat_layout(cfg) == want
    assert [p for p, _, _ in flat_layout(cfg) if "/moe/" in p] == [
        "blocks/moe/" + k for k in ("router", "wd", "wg", "wu")]
    assert flat_size(cfg) == off


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_flat_size_matches_jax_without_allocating(arch):
    """At full size: the JAX tree's abstract shapes (``eval_shape``), and
    ``_count_params``, which leaves out the final norm's d_model."""
    jcfg = jax_get_arch(arch)
    cfg = get_arch(arch)
    shapes = jax.eval_shape(jax_make_model(jcfg, Dist()).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape, dtype=np.int64))
               for l in jax.tree.leaves(shapes))
    assert flat_size(cfg) == want
    assert flat_size(cfg) == _count_params(jcfg, False) + cfg.d_model


def test_capacity_matches_jax():
    for t in (1, 2, 7, 12, 64, 128, 512, 1000, 1024):
        for k in (1, 2, 8):
            for e in (4, 8, 384):
                for cf in (1.0, 1.25, 2.0):
                    assert tmoe._capacity(t, k, e, cf) == \
                        jmoe._capacity(t, k, e, cf), (t, k, e, cf)
    assert tmoe._capacity(1024, 2, 8, 1.25) == 320
    assert tmoe.replication_factor(get_arch("grok-1-314b").moe) == 1


def test_decode_capacity_holds_every_slot():
    for b in (1, 4, 8, 9, 12, 100):
        c = tmoe.decode_capacity(b)
        assert c >= b and c >= 8 and c % 8 == 0


# ---------------------------------------------------------------------------
# Dispatch bookkeeping, exactly
# ---------------------------------------------------------------------------


def _inputs(kind, T, D, E, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.standard_normal((D, E)).astype(np.float32) * 0.3
    if kind == "drop":              # every row one vector: same experts
        x = (x[:1] + 1e-3 * x).astype(np.float32)
    elif kind == "tie":             # experts 1 and 2 always tie
        w[:, 2] = w[:, 1]
    return x, w


@pytest.mark.parametrize("kind", ["random", "drop", "tie"])
@pytest.mark.parametrize("T,k,E,cf", [(48, 2, 4, 1.25), (40, 8, 16, 1.25),
                                      (33, 2, 8, 1.0)])
def test_slot_bookkeeping_equals_jax_exactly(kind, T, k, E, cf):
    from repro_torch.configs.base import MoEConfig
    moe = MoEConfig(n_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf)
    x, w = _inputs(kind, T, 16, E, seed=T + k)
    je, jg, jt = jmoe._route(jnp.asarray(x), jnp.asarray(w), moe, 1)
    te, tg, tt = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    cap = tmoe._capacity(T, k, E, cf)
    # the same routed pairs into both dispatches
    jbuf, jtos, jgos = jmoe._fill_buffers(jnp.asarray(x), je, jg, jt, E, cap)
    gate = torch.tensor(np.array(jg))
    tbuf, ttos, tgos, pair_slot = tmoe._fill_buffers(
        torch.from_numpy(x), torch.tensor(np.array(je)).long(), gate,
        torch.tensor(np.array(jt)).long(), E, cap)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(ttos.numpy(), np.asarray(jtos))
    np.testing.assert_array_equal(tgos.numpy(), np.asarray(jgos))
    kept = pair_slot < E * cap
    assert int(kept.sum()) == int((np.asarray(jtos) < T * k).sum())
    # the inverse map: each kept pair's slot holds its token and gate
    p = torch.nonzero(kept).flatten()
    assert torch.equal(ttos[pair_slot[p]], p // k)
    assert torch.equal(tgos[pair_slot[p]], gate[p])
    if kind == "drop":
        assert int((~kept).sum()) > 0
    if kind == "tie":
        idx = te.view(T, k).numpy()
        # lower index first among equals, at the top-k boundary included
        assert not np.any((idx == 2) & ~np.any(idx == 1, axis=1,
                                                keepdims=True))


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def _block_inputs(setup, S=24, kind="random", seed=3):
    cfg = setup["cfg"]
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    if kind == "drop":
        x = (x[:1, :1] + 1e-3 * x).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[0], setup["jparams"]["blocks"]["moe"])
    tbp = layer_params(setup["params"]["blocks"], 0)["moe"]
    return x, jbp, tbp


@pytest.mark.parametrize("kind", ["random", "drop"])
def test_moe_block_matches_jax_and_ref_f32(setup, kind):
    x, jbp, tbp = _block_inputs(setup, kind=kind)
    cfg = setup["cfg"]
    want = jmoe._moe_single(jnp.asarray(x), jbp, setup["jcfg"].moe, 1)
    got = tmoe.moe_block(torch.from_numpy(x), tbp, cfg)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
    ref, dropped = tmoe.moe_ref(torch.from_numpy(x), tbp, cfg)
    np.testing.assert_allclose(_np(ref), _np(got), **REF_TOL)
    if kind == "drop":
        assert dropped > 0


def test_moe_block_matches_jax_bf16(setup):
    x, jbp, tbp = _block_inputs(setup, S=32)
    to16 = lambda t: t.to(torch.bfloat16)
    tbp16 = {k: to16(v) for k, v in tbp.items()}
    jbp16 = {k: v.astype(jnp.bfloat16) for k, v in jbp.items()}
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    got = tmoe.moe_block(x16, tbp16, setup["cfg"])
    assert got.dtype == torch.bfloat16
    want = jmoe._moe_single(jnp.asarray(x).astype(jnp.bfloat16), jbp16,
                            setup["jcfg"].moe, 1)
    g, w = _np(got), _np(want)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < BF16_REL_L2
    ref, _ = tmoe.moe_ref(x16, tbp16, setup["cfg"])
    r = _np(ref)
    assert np.linalg.norm(g - r) / np.linalg.norm(r) < BF16_REL_L2


# ---------------------------------------------------------------------------
# The model: loss and gradient, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_loss_grad_matches_jax(arch):
    jp = JaxLMPlugin({"arch": arch})
    flat = jp.flat_state(0)
    tp = LMPlugin({"arch": arch}, device="cpu")
    assert tp.flat_size == flat.size
    toks = np.random.RandomState(5).randint(
        0, tp.vocab, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jp.flat_loss_grad(flat, batch)
    tl_, tg = tp.flat_loss_grad(flat, batch)
    np.testing.assert_allclose(tl_.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
    offs = {p: (o, int(np.prod(s))) for p, s, o in flat_layout(tp.cfg)}
    for leaf in ("router", "wg", "wu", "wd"):
        o, n = offs[f"blocks/moe/{leaf}"]
        assert np.abs(tg[o:o + n].numpy()).max() > 0, leaf


def test_prefill_and_per_slot_decode_match_jax(setup):
    """Two slots prefilled at different lengths into one batched cache,
    then 4 batched decode steps, against JAX's per-slot prefill and
    ``jax.vmap(model.decode)`` (the JAX engine's decode)."""
    jmodel, jparams = setup["jmodel"], setup["jparams"]
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    S = 24
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12)]
    steps = rng.randint(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    # a whole-batch prefill (one capacity over both rows)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tlog, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)
                                      .long()})
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **MODEL_TOL)

    cache = model.empty_cache(2, S, "cpu")
    jcaches = []
    for b, p in enumerate(prompts):
        tlog, _ = model.prefill(params, {"tokens": torch.from_numpy(
            p[None]).long()}, cache=cache, slots=torch.tensor([b]))
        jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(p[None])})
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
        pad = [(0, 0)] * 5
        pad[2] = (0, S - p.size)
        jcaches.append({"k": jnp.pad(jc["k"], pad)[:, 0],
                        "v": jnp.pad(jc["v"], pad)[:, 0],
                        "pos": jnp.int32(p.size)})
    jcache = {k: jnp.stack([c[k] for c in jcaches],
                           axis=0 if k == "pos" else 1) for k in jcaches[0]}

    def decode_one(jp, c, tok):
        c = {k: (v if k == "pos" else v[:, None]) for k, v in c.items()}
        logits, new = jmodel.decode(jp, c, {"tokens": tok})
        return logits, {k: (v if k == "pos" else v[:, 0])
                        for k, v in new.items()}

    axes = {"k": 1, "v": 1, "pos": 0}
    jdecode = jax.jit(jax.vmap(decode_one, in_axes=(None, axes, 0),
                               out_axes=(0, axes)))
    for tok in steps:
        jlog, jcache = jdecode(jparams, jcache,
                               jnp.asarray(tok.reshape(2, 1, 1)))
        tlog, cache = model.decode(
            params, cache, {"tokens": torch.from_numpy(tok[:, None]).long()})
        np.testing.assert_allclose(_np(tlog), _np(jlog[:, 0]), **MODEL_TOL)
    assert cache["pos"].tolist() == [9, 16]
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   **MODEL_TOL)


def test_decode_beyond_capacity_matches_jax_per_slot(setup):
    """12 slots (the reference's ``_capacity(12)`` is 8 per expert), ten
    of them with one prompt, so each layer routes ten identical tokens to
    the same experts: the reference's batched ``model.decode`` drops
    some; the port's batched decode equals JAX's ``model.decode`` run on
    each slot alone."""
    jmodel, jparams = setup["jmodel"], setup["jparams"]
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    B, S = 12, 16
    moe = cfg.moe
    assert jmoe._capacity(B, moe.top_k, moe.n_experts,
                          moe.capacity_factor) < 10
    rng = np.random.RandomState(7)
    same = rng.randint(0, cfg.vocab_size, size=6).astype(np.int32)
    prompts = [same] * 10 + [rng.randint(0, cfg.vocab_size, size=n)
                             .astype(np.int32) for n in (3, 9)]
    tok = np.full((B, 1), 17, np.int32)
    cache = model.empty_cache(B, S, "cpu")
    want = []
    for b, p in enumerate(prompts):
        model.prefill(params, {"tokens": torch.from_numpy(p[None]).long()},
                      cache=cache, slots=torch.tensor([b]))
        _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(p[None])})
        pad = [(0, 0)] * 5
        pad[2] = (0, S - p.size)
        jc = dict(jc, k=jnp.pad(jc["k"], pad), v=jnp.pad(jc["v"], pad))
        jlog, _ = jmodel.decode(jparams, jc, {"tokens": jnp.asarray(tok[:1])})
        want.append(_np(jlog)[0])
    got, _ = model.decode(params, cache,
                          {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(_np(got), np.stack(want), **MODEL_TOL)
    assert cache["pos"].tolist() == [7] * 10 + [4, 10]


def test_decode_counts_on_meta(setup):
    """``count_program`` of one batched decode step on the meta device,
    as ``status.perf`` counts it: no data, and the expert products of
    every expert at ``decode_capacity`` rows each."""
    model, cfg = setup["model"], setup["cfg"]
    B, S = 4, 32
    meta = map_leaves(lambda _, d: torch.empty(d.shape, device="meta"),
                      model.param_defs())
    cache = model.empty_cache(B, S, "meta")
    toks = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    with torch.no_grad():
        got = count_program(model.decode, meta, cache, {"tokens": toks})
    moe = cfg.moe
    experts = (cfg.n_layers * moe.n_experts * tmoe.decode_capacity(B)
               * 2 * 3 * cfg.d_model * moe.d_ff_expert)
    assert got["flops_per_device"] > experts
    assert got["hbm_bytes_per_device"] > 0


def test_engine_perf_counts_a_moe_decode_step():
    eng = InferenceEngine(reduce_for_smoke(get_arch("grok-1-314b")),
                          capacity=2, max_seq=32, device="cpu")
    eng.start()
    assert wait_until(lambda: eng.perf.state in ("ready", "error"),
                      timeout=240), eng.perf.state
    assert eng.perf.state == "ready", eng.perf.error
    assert eng.perf.analysis["flops_per_device"] > 0
    eng.release()


# ---------------------------------------------------------------------------
# init_leaf: drawn a matrix group at a time
# ---------------------------------------------------------------------------


def test_init_leaf_per_matrix_draws(monkeypatch):
    """A stacked (L, E, D, Fe) leaf drawn one (D, Fe) matrix at a time:
    each matrix N(0, 1/D), no two alike, the same values for one seed,
    in the model dtype."""
    d = ParamDef((2, 4, 64, 512), ("layers", "expert", "embed", "eff"))
    monkeypatch.setattr(tl, "INIT_DRAW_ELEMS", 64 * 512)
    a = init_leaf(d, torch.Generator().manual_seed(0), torch.float32)
    b = init_leaf(d, torch.Generator().manual_seed(0), torch.float32)
    assert a.shape == d.shape and torch.equal(a, b)
    mats = a.view(-1, 64, 512)
    std = 1 / math.sqrt(64)
    for m in mats:
        assert abs(m.mean().item()) < 4 * std / math.sqrt(m.numel())
        assert abs(m.std().item() / std - 1) < 0.02
    assert not torch.equal(mats[0], mats[1])
    h = init_leaf(d, torch.Generator().manual_seed(0), torch.bfloat16)
    assert h.dtype == torch.bfloat16
    torch.testing.assert_close(h, a.to(torch.bfloat16), rtol=0, atol=0)


def test_init_leaf_small_leaf_is_one_draw():
    """A leaf of at most ``INIT_DRAW_ELEMS`` values is ``randn(shape)``
    scaled and cast, as before the grouped draws."""
    d = ParamDef((3, 64, 96), ("layers", "embed", "ff"))
    got = init_leaf(d, torch.Generator().manual_seed(5), torch.bfloat16)
    a = torch.randn(d.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, (a / 8).to(torch.bfloat16), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# kimi-k2's head dim 112 at a narrow width
# ---------------------------------------------------------------------------


def _kimi_narrow(get, moe_config):
    """kimi-k2 narrowed to d_model 448 over 4 heads (head dim 112, as the
    full model's 7168 over 64), KV 2, 2 layers, 16 experts top-8, vocab
    256, f32."""
    import dataclasses
    c = get("kimi-k2-1t-a32b")
    return dataclasses.replace(
        c, arch_id=c.arch_id + "-narrow", d_model=448, n_heads=4,
        n_kv_heads=2, n_layers=2, vocab_size=256, dtype="float32",
        moe=moe_config(n_experts=16, top_k=8, d_ff_expert=64))


def test_kimi_narrow_head_dim_112_matches_jax():
    """Loss, prefill (logits and caches) and two batched decode steps of
    the narrow kimi-k2 against the JAX model, from JAX-initialised
    params carried over as numpy; the attention at head dim 112 (the
    plain flash on the CPU, whose kernel is K4's hd-128 tile with zero
    columns on the card). Loss and logits at ``MODEL_TOL``. The caches
    at ``MODEL_TOL`` of their largest magnitude: the reference's init
    draws wk/wv with std ~0.7 at this width, so the keys reach ~68, and
    layer 1's, after a moe layer whose eight contributions a token the
    two packages sum in different orders, differ by up to 1.5e-3 (2.4e-5
    of the keys' scale; layer 0's by 5e-5)."""
    from repro.configs.base import MoEConfig as JMoE
    from repro_torch.configs.base import MoEConfig as TMoE
    jcfg = _kimi_narrow(jax_get_arch, JMoE)
    cfg = _kimi_narrow(get_arch, TMoE)
    assert cfg.hd == jcfg.hd == 112
    jmodel = jax_make_model(jcfg, Dist(), dict(OPTS))
    ravel, unravel = _flat_io(_jax_shapes(jcfg))
    flat = np.array(ravel(jmodel.init(jax.random.PRNGKey(3))))
    jparams = unravel(jnp.asarray(flat))
    model = make_model(cfg, opts=NO_REMAT)
    params = params_from_flat(flat, cfg, device="cpu")
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl_ = model.loss(params, {k: torch.from_numpy(v).long()
                              for k, v in batch.items()}, xent_chunk=32)
    np.testing.assert_allclose(tl_.item(), float(jl), **MODEL_TOL)

    prompt = toks[:, :20]
    jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)})
    cache = model.empty_cache(2, 22, "cpu")
    tlog, cache = model.prefill(params, {"tokens": torch.from_numpy(
        prompt).long()}, cache=cache, slots=torch.arange(2))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    def close_at_scale(got, want):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL["rtol"],
                                   atol=MODEL_TOL["atol"] * scale)
    for key in ("k", "v"):
        assert cache[key].shape[-1] == 112
        close_at_scale(_np(cache[key])[:, :, :20], _np(jc[key]))
    pad = [(0, 0)] * 5
    pad[2] = (0, 2)
    jc = dict(jc, k=jnp.pad(jc["k"], pad), v=jnp.pad(jc["v"], pad))
    for i in range(2):
        tok = toks[:, 20 + i:21 + i]
        jlog, jc = jmodel.decode(jparams, jc, {"tokens": jnp.asarray(tok)})
        tlog, cache = model.decode(params, cache,
                                   {"tokens": torch.from_numpy(tok).long()})
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in ("k", "v"):
        close_at_scale(_np(cache[key]), _np(jc[key]))
