"""The port's hybrid family (Jamba-1.5-Large) against the JAX package on
the same inputs and weights, at the jamba smoke reduction (one period of
8 layers: attention + 7 mamba, MoE at odd local index, 4 experts, top-2,
f32) and at a two-period variant (``n_layers=16``), so that the periods'
leading dimension is exercised: the flat layout, the full-size flat size
without allocating, the training loss and its gradient, prefill logits
and every cache leaf, a batched per-slot decode, prefill against prefill
plus decode, ``count_program`` of a decode step on the meta device, the
engine's tokens against a loop over JAX's prefill and decode, the
learner step's kernel libraries and ``model_flops`` of the one-card cut.

Every case starts from the one flat vector of the reference's
``LMPlugin.flat_state(0)``. Tolerances: the model at ``MODEL_TOL``
(1e-4, as tests/test_torch_model.py); the loss and gradient at
``FWD_TOL`` / ``GRAD_TOL`` of tests/test_torch_training.py."""
import dataclasses
import math
import threading

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
from repro.runtime.learner import LMPlugin as JaxLMPlugin
from repro.runtime.learner import _flat_io
from repro_torch.analysis.roofline import count_program, model_flops
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_attention_bwd as kfab
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.kernels import ssd_scan_bwd as kssdb
from repro_torch.models import layers as tl
from repro_torch.models import make_model
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ParamDef, init_leaf, map_leaves
from repro_torch.runtime.learner import LMPlugin, step_libraries
from repro_torch.serving.engine import InferenceEngine
from repro_torch.weights import flat_layout, flat_size, params_from_flat
from util_poll import wait_until

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

ARCH = "jamba-1.5-large-398b"
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_training.py
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
# the reference plugin's model options
OPTS = {"remat": "none", "xent_chunk": 64, "q_chunk": 64, "k_chunk": 64}
LAYERS = [8, 16]                         # one period; two periods
CACHE_KEYS = ("k", "v", "ssm", "conv")
# slot axis of each cache leaf in the port's batched cache
SLOT_AXES = {"k": 1, "v": 1, "ssm": 2, "conv": 2, "pos": 0}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _cfgs(n_layers):
    """(JAX config, port config): the jamba smoke reduction with
    ``n_layers`` layers."""
    jcfg = jax_reduce(jax_get_arch(ARCH))
    cfg = reduce_for_smoke(get_arch(ARCH))
    if n_layers != cfg.n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _jax_plugin(n_layers):
    """The reference's ``LMPlugin`` for the jamba smoke reduction, its
    config and model swapped for ``n_layers`` layers before first use."""
    jp = JaxLMPlugin({"arch": ARCH})
    jcfg, _ = _cfgs(n_layers)
    if jcfg.n_layers != jp.cfg.n_layers:
        jp.cfg = jcfg
        jp.model = jax_make_model(jcfg, Dist(), dict(OPTS))
    return jp


@pytest.fixture(scope="module", params=LAYERS)
def setup(request):
    """Both packages' models on the flat vector of the reference plugin's
    ``flat_state(0)``."""
    jp = _jax_plugin(request.param)
    flat = jp.flat_state(0)
    jcfg, cfg = _cfgs(request.param)
    shapes = jax.eval_shape(jp.model.init, jax.random.PRNGKey(0))
    _, unravel = _flat_io(shapes)
    return dict(jp=jp, jcfg=jcfg, jmodel=jp.model, flat=flat,
                jparams=unravel(jnp.asarray(flat)), cfg=cfg,
                model=make_model(cfg, opts=NO_REMAT),
                params=params_from_flat(flat, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# Layout and size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", LAYERS)
def test_flat_layout_matches_jax_flat_io(n_layers):
    jcfg, cfg = _cfgs(n_layers)
    shapes = jax.eval_shape(jax_make_model(jcfg, Dist(), dict(OPTS)).init,
                            jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want, off = [], 0
    for path, leaf in leaves:
        want.append(("/".join(p.key for p in path), tuple(leaf.shape), off))
        off += int(np.prod(leaf.shape))
    assert flat_layout(cfg) == want
    assert flat_size(cfg) == off
    groups = sorted({p.split("/")[1] for p, _, _ in want
                     if p.startswith("blocks/")})
    assert groups == ["attn", "attn_ln", "ffn_ln", "mamba", "mamba_ln",
                      "mlp", "moe"]
    np_ = n_layers // cfg.attn_period
    shape = {p: s for p, s, _ in want}
    assert shape["blocks/attn/wq"][0] == np_
    assert shape["blocks/mamba/wx"][:2] == (np_, cfg.attn_period - 1)
    assert shape["blocks/ffn_ln/w"][:2] == (np_, cfg.attn_period)
    assert shape["blocks/moe/wg"][:2] == (np_, cfg.attn_period // 2)
    assert shape["blocks/mlp/wg"][:2] == (np_, cfg.attn_period // 2)


@pytest.mark.parametrize("cut", [None, dict(attn_period=4, n_layers=4)])
def test_full_size_flat_size_matches_jax_without_allocating(cut):
    """At full width (and at the one-card cut, one period of 4 layers):
    the JAX tree's abstract shapes, and the port's param defs on the
    meta device, none of them allocated. ``_count_params`` leaves out
    the final norm's d_model and each mamba layer's gated-norm weight
    (d_inner)."""
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    if cut:
        jcfg = dataclasses.replace(jcfg, **cut)
        cfg = dataclasses.replace(cfg, **cut)
    shapes = jax.eval_shape(jax_make_model(jcfg, Dist()).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape, dtype=np.int64))
               for l in jax.tree.leaves(shapes))
    assert flat_size(cfg) == want
    n_mamba = cfg.n_layers - cfg.n_layers // cfg.attn_period
    d_in = cfg.ssm.expand * cfg.d_model
    assert flat_size(cfg) == (_count_params(jcfg, False) + cfg.d_model
                              + n_mamba * d_in)
    meta = map_leaves(lambda _, d: torch.empty(d.shape, device="meta"),
                      make_model(cfg).param_defs())
    leaves = [t for _, t in tl.iter_leaves(meta)]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == want
    if cut:
        assert round(want / 1e9, 2) == 22.98          # 45.96 GB in bf16


# ---------------------------------------------------------------------------
# The loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", LAYERS)
def test_flat_loss_grad_matches_jax(n_layers):
    """The learner's step, 64 tokens (two SSD chunks of 32), against the
    reference plugin's ``flat_loss_grad``."""
    jp = _jax_plugin(n_layers)
    flat = jp.flat_state(0)
    _, cfg = _cfgs(n_layers)
    tp = LMPlugin({"arch": ARCH}, cfg=cfg, device="cpu")
    assert tp.flat_size == flat.size
    toks = np.random.RandomState(5).randint(
        0, tp.vocab, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jp.flat_loss_grad(flat, batch)
    tl_, tg = tp.flat_loss_grad(flat, batch)
    np.testing.assert_allclose(tl_.item(), float(jl), **FWD_TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
    offs = {p: (o, int(np.prod(s))) for p, s, o in flat_layout(cfg)}
    for leaf in ("attn/wq", "mamba/wx", "mamba/A_log", "moe/router",
                 "moe/wg", "mlp/wd", "ffn_ln/w", "mamba_ln/w"):
        o, n = offs[f"blocks/{leaf}"]
        assert np.abs(tg[o:o + n].numpy()).max() > 0, leaf


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_matches_jax(setup):
    """Prefill of 40 tokens (an SSD chunk of 32 and a ragged 8): logits
    and every cache leaf against JAX's ``_hybrid_prefill``."""
    jmodel, jparams = setup["jmodel"], setup["jparams"]
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    toks = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, tc = model.prefill(params,
                                 {"tokens": torch.from_numpy(toks).long()})
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in CACHE_KEYS:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **MODEL_TOL)
    np_ = cfg.n_layers // cfg.attn_period
    assert tc["k"].shape[0] == np_
    assert tc["ssm"].shape[:2] == (np_, cfg.attn_period - 1)
    assert tc["ssm"].dtype == torch.float32
    assert tc["pos"].tolist() == [40, 40] and int(jc["pos"]) == 40


def _jax_slot_cache(jc, S, size):
    """JAX's prefill cache of one request (batch 1, ``size`` tokens) with
    its k/v padded to ``S`` positions, the batch axis dropped."""
    pad = [(0, 0)] * 5
    pad[2] = (0, S - size)
    return {"k": jnp.pad(jc["k"], pad)[:, 0],
            "v": jnp.pad(jc["v"], pad)[:, 0],
            "ssm": jc["ssm"][:, :, 0], "conv": jc["conv"][:, :, 0],
            "pos": jnp.int32(size)}



def test_prefill_and_per_slot_decode_match_jax(setup):
    """Two slots prefilled at different lengths (5 and 12) into one
    batched cache, then 4 batched decode steps, against JAX's per-slot
    prefill and ``jax.vmap(model.decode)`` (the JAX engine's decode)."""
    jmodel, jparams = setup["jmodel"], setup["jparams"]
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    S = 24
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12)]
    steps = rng.randint(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    cache = model.empty_cache(2, S, "cpu")
    jcaches = []
    with torch.no_grad():
        for b, p in enumerate(prompts):
            tlog, _ = model.prefill(params, {"tokens": torch.from_numpy(
                p[None]).long()}, cache=cache, slots=torch.tensor([b]))
            jlog, jc = jmodel.prefill(jparams,
                                      {"tokens": jnp.asarray(p[None])})
            np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
            jcaches.append(_jax_slot_cache(jc, S, p.size))
    jcache = {k: jnp.stack([c[k] for c in jcaches], axis=SLOT_AXES[k])
              for k in jcaches[0]}

    def decode_one(jp, c, tok):
        c = {k: (v if k == "pos" else jnp.expand_dims(v, SLOT_AXES[k]))
             for k, v in c.items()}
        logits, new = jmodel.decode(jp, c, {"tokens": tok})
        return logits, {k: (v if k == "pos" else
                            jnp.squeeze(v, SLOT_AXES[k]))
                        for k, v in new.items()}

    jdecode = jax.jit(jax.vmap(decode_one, in_axes=(None, SLOT_AXES, 0),
                               out_axes=(0, SLOT_AXES)))
    for tok in steps:
        jlog, jcache = jdecode(jparams, jcache,
                               jnp.asarray(tok.reshape(2, 1, 1)))
        with torch.no_grad():
            tlog, cache = model.decode(params, cache, {
                "tokens": torch.from_numpy(tok[:, None]).long()})
        np.testing.assert_allclose(_np(tlog), _np(jlog[:, 0]), **MODEL_TOL)
    assert cache["pos"].tolist() == [9, 16]
    for key in CACHE_KEYS:
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   **MODEL_TOL)


@pytest.mark.parametrize("S", [40, 2])
def test_decode_matches_prefill(setup, S):
    """Prefill over S+1 tokens gives the last-position logits of prefill
    over S followed by one decode step, through a batched cache written
    by slot (S = 2: the conv tail left-padded). The MoE layers run at a
    capacity factor of E / k, so that no prefill drops a pair: with
    drops the two prefills rank their pairs differently, which is the
    capacity rule (tests/test_torch_moe.py), not the cache's state."""
    model, params = setup["model"], setup["params"]
    cfg = setup["cfg"]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = make_model(cfg, opts=NO_REMAT)
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(2, S + 1))).long()
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks})
        cache = model.empty_cache(3, S + 1, "cpu")
        model.prefill(params, {"tokens": toks[:, :S]}, cache=cache,
                      slots=torch.tensor([2, 0]))
        assert cache["pos"].tolist() == [S, 0, S]
        step, _ = model.decode(params, cache, {"tokens": torch.stack(
            [toks[1, S:], toks[0, S:], toks[0, S:]])})
    np.testing.assert_allclose(_np(step[[2, 0]]), _np(full), **MODEL_TOL)


def test_decode_counts_on_meta(setup):
    """``count_program`` of one batched decode step on the meta device,
    as ``status.perf`` counts it: no data, and at least the expert
    products of every MoE layer's experts at ``decode_capacity`` rows."""
    model, cfg = setup["model"], setup["cfg"]
    B, S = 4, 32
    meta = map_leaves(lambda _, d: torch.empty(d.shape, device="meta"),
                      model.param_defs())
    cache = model.empty_cache(B, S, "meta")
    toks = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    with torch.no_grad():
        got = count_program(model.decode, meta, cache, {"tokens": toks})
    moe = cfg.moe
    n_moe = cfg.n_layers // 2
    experts = (n_moe * moe.n_experts * tmoe.decode_capacity(B)
               * 2 * 3 * cfg.d_model * moe.d_ff_expert)
    assert got["flops_per_device"] > experts
    assert got["hbm_bytes_per_device"] > 0
    assert all(t.is_meta for t in cache.values())


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _jax_greedy(jmodel, jparams, prompt, max_new, S, decode):
    """One request through JAX's prefill and then its decode (``decode``,
    ``model.decode`` under jit), alone."""
    logits, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt[None])})
    c = _jax_slot_cache(jc, S, prompt.size)
    c = {k: (v if k == "pos" else jnp.expand_dims(v, SLOT_AXES[k]))
         for k, v in c.items()}
    toks = [int(np.argmax(np.asarray(logits)[0, -1]))]
    while len(toks) < max_new:
        logits, c = decode(jparams, c, {"tokens": jnp.asarray(
            [[toks[-1]]], jnp.int32)})
        toks.append(int(np.argmax(np.asarray(logits)[0, -1])))
    return toks


def test_engine_tokens_equal_a_loop_over_jax_prefill_and_decode():
    """Five requests of distinct lengths over two slots (joins into freed
    slots mid-flight) through ``InferenceEngine(device="cpu")`` on the
    reference plugin's weights: each request's tokens equal JAX's
    prefill and decode run on it alone."""
    jp = _jax_plugin(8)
    flat = jp.flat_state(0)
    shapes = jax.eval_shape(jp.model.init, jax.random.PRNGKey(0))
    jparams = _flat_io(shapes)[1](jnp.asarray(flat))
    _, cfg = _cfgs(8)
    S = 48
    rng = np.random.RandomState(9)
    lens, max_new = (9, 33, 3, 17, 40), (6, 3, 7, 4, 5)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    eng = InferenceEngine(cfg, capacity=2, max_seq=S, device="cpu",
                          endpoint_id="ep-hybrid")
    eng.start(flat)
    reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_new)]
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    for r in reqs:
        assert r.wait(120), f"request {r.req_id} stuck: {r.status}"
    eng.drain()
    t.join(20)
    assert not t.is_alive()
    assert all(r.status == "DONE" for r in reqs)
    assert eng.prefill_batches >= 4               # joins did happen
    assert eng._cache["ssm"].shape[2] == 2
    decode = jax.jit(jp.model.decode)
    for r, p, m in zip(reqs, prompts, max_new):
        assert r.tokens == _jax_greedy(jp.model, jparams, p, m, S, decode)
    eng.release()


def test_engine_perf_counts_a_hybrid_decode_step():
    eng = InferenceEngine(reduce_for_smoke(get_arch(ARCH)), capacity=2,
                          max_seq=32, device="cpu")
    eng.start()
    assert wait_until(lambda: eng.perf.state in ("ready", "error"),
                      timeout=240), eng.perf.state
    assert eng.perf.state == "ready", eng.perf.error
    assert eng.perf.analysis["flops_per_device"] > 0
    eng.release()


# ---------------------------------------------------------------------------
# The learner's libraries, model_flops and init
# ---------------------------------------------------------------------------


def test_step_libraries_name_all_four_kernels():
    """A hybrid learner step launches K4, K4b, K5 and K5b."""
    cfg = reduce_for_smoke(get_arch(ARCH))
    assert set(step_libraries(cfg)) == {kfa.NAME, kfab.NAME, kssd.NAME,
                                        kssdb.NAME}
    assert set(step_libraries(get_arch("grok-1-314b"))) == {kfa.NAME,
                                                            kfab.NAME}
    assert set(step_libraries(get_arch("mamba2-1.3b"))) == {kssd.NAME,
                                                            kssdb.NAME}


def test_model_flops_uses_the_cut_attn_period():
    """The one-card cut (one period of 4 layers) counts one attention
    layer and three SSD layers: the prefill's S^2 term and the SSD term
    follow the cut config's ``attn_period``, not the full model's."""
    full = get_arch(ARCH)
    cut = dataclasses.replace(full, attn_period=4, n_layers=4)
    shape = ShapeSpec("p", 2048, 2, "prefill")
    got = model_flops(cut, shape)
    B, S = 2, 2048
    attn = 4.0 * 1 * B * S * S * cut.n_heads * cut.hd * 0.5
    d_in = cut.ssm.expand * cut.d_model
    nh, gn = d_in // cut.ssm.head_dim, cut.ssm.n_groups * cut.ssm.d_state
    per_tok = (2 * cut.ssm.chunk_size * gn
               + 2 * cut.ssm.chunk_size * nh * cut.ssm.head_dim
               + 4 * nh * cut.ssm.head_dim * cut.ssm.d_state)
    want = 2.0 * cut.n_active_params() * B * S + attn + 3 * B * S * per_tok
    assert math.isclose(got, want, rel_tol=1e-12)


def test_init_leaf_draws_a_two_level_stack_a_matrix_at_a_time(monkeypatch):
    """The hybrid's (np, n, E, D, Fe) expert leaves: drawn one (D, Fe)
    matrix at a time, each N(0, 1/D), the same values as one draw of the
    whole leaf from the same seed."""
    d = ParamDef((1, 2, 4, 64, 256),
                 ("layers", "layers", "expert", "embed", "eff"))
    whole = init_leaf(d, torch.Generator().manual_seed(3), torch.float32)
    monkeypatch.setattr(tl, "INIT_DRAW_ELEMS", 64 * 256)
    per = init_leaf(d, torch.Generator().manual_seed(3), torch.float32)
    assert per.shape == d.shape
    torch.testing.assert_close(per, whole, rtol=0, atol=0)
    mats = per.view(-1, 64, 256)
    assert len({float(m[0, 0]) for m in mats}) == mats.shape[0]
    assert abs(per.std().item() * 8 - 1) < 0.02
