"""The port's encoder-decoder family (whisper-large-v3,
``repro_torch.models.encdec``) against the JAX package's
``repro.models.encdec`` on the same inputs and weights, at the whisper
smoke reduction (2 + 2 layers, d_model 64, 4 heads over 2 KV heads of hd
16, vocab 256, f32): the flat layout and both full-size parameter
counts, ``sinusoid_positions``, the LayerNorm branch of ``norm_apply``,
the loss and every gradient leaf, prefill logits and all four cache
leaves, decode on an unpadded and on a padded cache, two slots decoding
at different positions in one call, prefill against prefill plus decode,
and the counts of the steps on the meta device against the reference's
HLO.

Every case starts from one flat vector of the reference model's
``init(PRNGKey(0))``. Tolerances: logits and caches at ``MODEL_TOL``
(1e-4, as tests/test_torch_model.py) of each tensor's largest magnitude
(``_close``), the loss and gradient at ``FWD_TOL`` /
``GRAD_TOL`` of tests/test_torch_training.py, single layers at
``LAYER_TOL``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs.base import _count_params
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.models import layers as jl
from repro.models import make_model as jax_make_model
from repro.models import transformer as jtf
from repro.runtime.learner import _flat_io
from repro_torch.analysis import roofline
from repro_torch.configs import base
from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import steps
from repro_torch.models import layers as tl
from repro_torch.models import make_model
from repro_torch.models import transformer as ttf
from repro_torch.weights import flat_layout, flat_size, params_from_flat

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

ARCH = "whisper-large-v3"
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_training.py
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
OPTS = {"remat": "none", "xent_chunk": 512, "q_chunk": 32, "k_chunk": 32}
CACHE_KEYS = ("k", "v", "cross_k", "cross_v")
B, S_ENC, S = 2, 24, 16
# the port's counts of the smoke steps over the reference's HLO counts
# (B 2, 24 frames, 16 tokens): the kernels' formulas skip the causal
# mask's upper half, which the reference's jnp attention computes, and
# K4b recomputes the scores, which its VJP keeps
HLO_RATIO = {"train": 1.0127792823290453, "prefill": 0.9917763157894737}
DECODE_FLOPS_RTOL = 0.01   # tests/test_torch_roofline.py


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, key="logits"):
    """Logits or a K/V cache leaf at ``MODEL_TOL`` of its largest
    magnitude. The smoke model's K/V reach |15-22| (the reference's
    fan-in rule draws wk/wv at std 1/sqrt(KV) = 0.71), and both
    packages' f32 caches lie 1.6e-4 / 2.3e-4 from a float64 run of the
    port: an element near 0 carries the rounding of its row's large
    terms, and so do the logits after it."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=MODEL_TOL["rtol"],
                               atol=MODEL_TOL["atol"] * scale, err_msg=key)


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


def _inputs(cfg, seed=0, b=B, s=S):
    rng = np.random.RandomState(seed)
    emb = rng.standard_normal((b, S_ENC, cfg.d_model)).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, size=(b, s + 1))
    return emb, toks


# ---------------------------------------------------------------------------
# Layout, sizes, layers
# ---------------------------------------------------------------------------


def test_flat_layout_matches_jax_flat_io(setup):
    """Sorted keys dec_blocks, embed, enc_blocks, enc_norm, final_norm,
    head; each block's leaves sorted, LayerNorm ``b`` before ``w``."""
    shapes = jax.eval_shape(setup["jm"].init, jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want, off = [], 0
    for path, leaf in leaves:
        want.append(("/".join(p.key for p in path), tuple(leaf.shape), off))
        off += int(np.prod(leaf.shape))
    assert flat_layout(setup["cfg"]) == want
    tops = list(dict.fromkeys(p.split("/")[0] for p, _, _ in want))
    assert tops == ["dec_blocks", "embed", "enc_blocks", "enc_norm",
                    "final_norm", "head"]
    paths = [p for p, _, _ in want]
    assert paths.index("enc_norm/b") + 1 == paths.index("enc_norm/w")


def test_full_size_parameter_counts():
    """whisper-large-v3 at full size, on the meta device: 2,020,628,480
    values in the flat vector (the reference's ``model.init`` tree),
    2,020,418,560 by ``_count_params``. The 209,920 = 164 x d_model
    between them are LayerNorm leaves ``_count_params`` leaves out: the
    bias of each of the 5 norms per layer pair (2 encoder, 3 decoder;
    160 x d_model) and both leaves of ``enc_norm`` and ``final_norm``
    (4 x d_model)."""
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    shapes = jax.eval_shape(jax_make_model(jcfg, Dist()).init,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape, dtype=np.int64))
               for l in jax.tree.leaves(shapes))
    assert flat_size(cfg) == want == 2_020_628_480
    assert _count_params(jcfg, False) == base._count_params(cfg, False) \
        == cfg.n_params() == 2_020_418_560
    d, L = cfg.d_model, cfg.n_layers
    assert want - _count_params(jcfg, False) == 164 * d == 209_920
    sizes = {p: int(np.prod(s)) for p, s, _ in flat_layout(cfg)}
    biases = sum(n for p, n in sizes.items() if p.endswith("/b")
                 and "blocks" in p)
    finals = sum(sizes[f"{n}/{k}"] for n in ("enc_norm", "final_norm")
                 for k in "bw")
    assert biases == 5 * L * d and finals == 4 * d
    assert biases + finals == want - _count_params(jcfg, False)
    meta = make_model(cfg).abstract_params()
    assert sum(t.numel() for _, t in tl.iter_leaves(meta)) == want
    assert round(want * 2 / 1e9, 2) == 4.04           # GB in bf16


@pytest.mark.parametrize("seq,d", [(7, 64), (1500, 1280), (449, 1280),
                                   (5, 2), (3, 3)])
def test_sinusoid_positions_matches_jax(seq, d):
    """Equal f32 angles; sin and cos of an angle near ``seq`` may differ
    by the f32 spacing there (1.2e-4 at 1,500) between the two
    libraries' range reductions, so atol is that spacing where it
    exceeds ``LAYER_TOL``'s."""
    atol = max(LAYER_TOL["atol"], float(np.spacing(np.float32(seq))))
    np.testing.assert_allclose(
        _np(tl.sinusoid_positions(seq, d)),
        _np(jl.sinusoid_positions(seq, d)), rtol=LAYER_TOL["rtol"],
        atol=atol)
    assert tl.sinusoid_positions(seq, d, torch.bfloat16).dtype == \
        torch.bfloat16


def test_norm_apply_takes_layer_norm_with_a_bias(setup):
    rng = np.random.RandomState(4)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 64), 64, 64))
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    got = ttf.norm_apply(torch.from_numpy(x), {"w": torch.from_numpy(w),
                                               "b": torch.from_numpy(b)},
                         cfg)
    want = jtf.norm_apply(jnp.asarray(x), {"w": jnp.asarray(w),
                                           "b": jnp.asarray(b)}, jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    np.testing.assert_allclose(
        _np(got), _np(tl.layer_norm(*map(torch.from_numpy, (x, w, b)),
                                    cfg.norm_eps)), **LAYER_TOL)


# ---------------------------------------------------------------------------
# Loss and gradient
# ---------------------------------------------------------------------------


def test_loss_and_every_gradient_leaf_match_jax(setup):
    emb, toks = _inputs(setup["cfg"], seed=1)
    batch = {"enc_embeds": emb, "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(setup["jm"].loss)(
        setup["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = steps.value_and_grad(
        setup["model"], setup["params"],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    leaves = list(tl.iter_leaves(grads))
    assert [p for p, _ in leaves] == [
        "/".join(k.key for k in path) for path, _ in jleaves]
    for (path, g), (_, jg) in zip(leaves, jleaves):
        np.testing.assert_allclose(_np(g), _np(jg), err_msg=path,
                                   **GRAD_TOL)
        assert np.abs(_np(g)).max() > 0, path


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def _padded_cache(model, B, M, S_enc):
    """A zeroed batched cache of ``B`` slots, self K/V ``M`` long."""
    return model.empty_cache(B, M, "cpu", S_enc=S_enc)


def _prefill(setup, emb, toks, max_seq=None):
    """JAX's prefill (a cache as long as the prompt) and the port's: the
    same, or with ``max_seq`` into slot ``b`` of a zeroed cache of that
    length for every row ``b``."""
    jlog, jcache = setup["jm"].prefill(
        setup["jparams"], {"enc_embeds": jnp.asarray(emb),
                           "tokens": jnp.asarray(toks)})
    kw = {}
    if max_seq is not None:
        kw = {"cache": _padded_cache(setup["model"], toks.shape[0], max_seq,
                                     emb.shape[1]),
              "slots": torch.arange(toks.shape[0])}
    with torch.no_grad():
        logits, cache = setup["model"].prefill(
            setup["params"], {"enc_embeds": torch.from_numpy(emb),
                              "tokens": torch.from_numpy(toks)}, **kw)
    return (jlog, jcache), (logits, cache)


def test_prefill_matches_jax(setup):
    emb, toks = _inputs(setup["cfg"], seed=2)
    (jlog, jcache), (logits, cache) = _prefill(setup, emb, toks[:, :S])
    _close(logits, jlog)
    for key in CACHE_KEYS:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
        _close(cache[key], jcache[key], key)
    assert cache["pos"].tolist() == [S] * B == [int(jcache["pos"])] * B


def _pad(jcache, n):
    out = dict(jcache)
    for key in ("k", "v"):
        out[key] = jnp.pad(out[key], [(0, 0), (0, 0), (0, n), (0, 0),
                                      (0, 0)])
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded",
                                                       "padded"])
def test_decode_matches_jax(setup, padded):
    """Three decode steps. Unpadded, the cache is as long as the prompt,
    and every step writes its last row (the reference's clamped
    ``dynamic_update_slice``; the sinusoid row index clamps likewise).
    Padded to S + 3, each step writes its own row."""
    emb, toks = _inputs(setup["cfg"], seed=3, s=S + 3)
    (_, jcache), (_, cache) = _prefill(
        setup, emb, toks[:, :S], max_seq=S + 3 if padded else None)
    if padded:
        jcache = _pad(jcache, 3)
    for t in range(3):
        tok = toks[:, S + t:S + t + 1]
        jlog, jcache = setup["jm"].decode(setup["jparams"], jcache,
                                          {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            logits, cache = setup["model"].decode(
                setup["params"], cache, {"tokens": torch.from_numpy(tok)})
        _close(logits, jlog)
        for key in ("k", "v"):
            _close(cache[key], jcache[key], key)
        assert cache["pos"].tolist() == [int(jcache["pos"])] * B


def test_two_slots_decode_at_their_own_positions(setup):
    """Slots 1 and 0 of one cache 20 long prefilled alone with 9 and 16
    tokens (each into its slot: the other slot keeps its rows), then two
    batched decode steps, against JAX decoding each slot alone on its
    own cache."""
    cfg, jm, jp = setup["cfg"], setup["jm"], setup["jparams"]
    lens, M = (9, 16), 20
    emb, toks = _inputs(cfg, seed=4, s=M)
    cache = _padded_cache(setup["model"], 2, M, S_ENC)
    jcaches = []
    for b in (1, 0):
        n = lens[b]
        with torch.no_grad():
            _, cache = setup["model"].prefill(
                setup["params"],
                {"enc_embeds": torch.from_numpy(emb[b:b + 1]),
                 "tokens": torch.from_numpy(toks[b:b + 1, :n])},
                cache=cache, slots=torch.tensor([b]))
        _, jc = jm.prefill(jp, {"enc_embeds": jnp.asarray(emb[b:b + 1]),
                                "tokens": jnp.asarray(toks[b:b + 1, :n])})
        jcaches.insert(0, _pad(jc, M - n))
    assert cache["pos"].tolist() == list(lens)
    for b in range(2):
        for key in CACHE_KEYS:
            _close(cache[key][:, b:b + 1], jcaches[b][key], key)
    for t in range(2):
        tok = np.stack([toks[b, n + t:n + t + 1]
                        for b, n in enumerate(lens)])
        with torch.no_grad():
            logits, cache = setup["model"].decode(
                setup["params"], cache, {"tokens": torch.from_numpy(tok)})
        for b in range(2):
            jlog, jcaches[b] = jm.decode(
                jp, jcaches[b], {"tokens": jnp.asarray(tok[b:b + 1])})
            _close(logits[b:b + 1], jlog)
            for key in ("k", "v"):
                _close(cache[key][:, b:b + 1], jcaches[b][key], key)
    assert cache["pos"].tolist() == [n + 2 for n in lens]


def test_prefill_matches_prefill_plus_decode(setup):
    """Prefill over t + 1 tokens gives the last-position logits of a
    prefill over t tokens (cache padded to t + 1) and one decode step."""
    emb, toks = _inputs(setup["cfg"], seed=5)
    model, params = setup["model"], setup["params"]
    with torch.no_grad():
        full, _ = model.prefill(params, {
            "enc_embeds": torch.from_numpy(emb),
            "tokens": torch.from_numpy(toks)})
        _, cache = model.prefill(params, {
            "enc_embeds": torch.from_numpy(emb),
            "tokens": torch.from_numpy(toks[:, :S])},
            cache=_padded_cache(model, B, S + 1, S_ENC),
            slots=torch.arange(B))
        step, _ = model.decode(params, cache,
                               {"tokens": torch.from_numpy(toks[:, S:])})
    _close(step, full)


def test_prefill_into_a_batched_cache_needs_slots(setup):
    emb, toks = _inputs(setup["cfg"], seed=6)
    cache = _padded_cache(setup["model"], B, S + 1, S_ENC)
    with pytest.raises(ValueError, match="needs slots"):
        setup["model"].prefill(setup["params"], {
            "enc_embeds": torch.from_numpy(emb),
            "tokens": torch.from_numpy(toks[:, :S])}, cache=cache)


# ---------------------------------------------------------------------------
# Counts on the meta device
# ---------------------------------------------------------------------------


def _hlo_flops(fn, *args):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return jax_roofline.analyze_hlo_text(
        txt, jax_roofline.KERNEL_SCOPES)["flops_per_device"]


def test_step_counts_match_the_reference_hlo(setup):
    """The train step's loss and gradient, prefill and one decode step of
    2 slots, counted on the meta device, against the reference's HLO of
    the same steps: train and prefill at their pinned ``HLO_RATIO``,
    decode (the same products, plain attention over the cache) within
    ``DECODE_FLOPS_RTOL``."""
    emb, toks = _inputs(setup["cfg"], seed=6)
    jm, jp, model = setup["jm"], setup["jparams"], setup["model"]
    batch = {"enc_embeds": emb, "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
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
    tok = {"tokens": toks[:, -1:]}
    want = _hlo_flops(jm.decode, jp, jcache,
                      {k: jnp.asarray(v) for k, v in tok.items()})
    cache = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for k, s in model.cache_specs(B, S, S_ENC).items()}
    got = roofline.count_program(
        lambda p, c, b: model.decode(p, c, b), aps, cache,
        {k: torch.from_numpy(v) for k, v in tok.items()})
    assert abs(got["flops_per_device"] - want) <= DECODE_FLOPS_RTOL * want


# The port's count of whisper's steps at full width over the reference's
# ``model_flops``, which charges every parameter (encoder's and
# decoder's) against every token of both halves: an encoder layer sees
# only the frames and a decoder layer only the tokens, so the count is
# about half of it (ROADMAP Queue 3, found in the reference)
FULL_WIDTH_RATIO = {"train": 0.48885850213601784,
                    "prefill": 0.46452913853598526,
                    "decode": 0.5163337682606639}


@pytest.mark.parametrize("kind", sorted(FULL_WIDTH_RATIO))
def test_full_width_steps_count_against_model_flops(kind):
    """whisper-large-v3 at full width and depth, the reference's shapes
    of one step (encoder and decoder S/2 = 448 each at S = 896, 2
    sequences), through ``abstract_inputs`` and the step builders on
    the meta device: ``FULL_WIDTH_RATIO`` of ``model_flops``. Nothing is
    allocated."""
    cfg = get_arch(ARCH)
    model = make_model(cfg, opts=NO_REMAT)
    shape = ShapeSpec(kind, 896, 2, kind)
    args = steps.abstract_inputs(model, shape)
    fn = {"train": steps.build_train_step(model, steps.default_optimizer(
              cfg)),
          "prefill": steps.build_prefill_step(model),
          "decode": steps.build_decode_step(model)}[kind]
    got = roofline.count_program(fn, *args)
    assert got["flops_per_device"] / roofline.model_flops(cfg, shape) == \
        pytest.approx(FULL_WIDTH_RATIO[kind], rel=1e-9)
    assert all(t.is_meta for _, t in tl.iter_leaves(args[0]))


def test_configs_match_the_reference():
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size) == (32, 1280, 20, 64, 5120, 51866)


def _attention_f64(q, k, v, causal, q_offset=0):
    """Softmax attention in float64, GQA by repeat (the f64 arbiter)."""
    B, S, H, hd = q.shape
    k = k.repeat_interleave(H // k.shape[2], 2)
    v = v.repeat_interleave(H // v.shape[2], 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if causal:
        keep = torch.arange(S)[:, None] + q_offset >= torch.arange(
            k.shape[1])[None, :]
        s = s.masked_fill(~keep, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


# the f32 step's distance from float64, max over leaves of |g32 - g64| /
# (1 + |g64|), lies in these ranges: whisper's smoke model (encoder
# logits of std ~20, from the reference's fan-in rule for wq/wk) 1.10e-2
# on this batch, stablelm's 2.08e-4 (measured on the CPU)
CONDITIONING = {"whisper-large-v3": (5e-3, 5e-2),
                "stablelm-1.6b": (0.0, 1e-3)}


@pytest.mark.parametrize("arch", sorted(CONDITIONING))
def test_smoke_step_f32_conditioning(monkeypatch, arch):
    """The smoke step in f32 on the CPU (plain kernels) against the same
    step in float64 (the model's dtype and its attention widened): the
    f32 gradient's distance from exact. Whisper's is ~50x stablelm's and
    above the card-vs-CPU limit of 2e-3, so its card-vs-CPU step
    (chip_smoke.py's phase 17, tests/test_torch_cuda.py) scales its atol
    by each leaf's magnitude (its controls: the next test)."""
    from repro_torch.models import encdec as ted
    cfg = reduce_for_smoke(get_arch(arch))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, 41)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 60, cfg.d_model)).astype(np.float32))
    _, g32 = steps.value_and_grad(model, params, batch)
    monkeypatch.setitem(ttf.DTYPES, "float32", torch.float64)
    monkeypatch.setattr(ted, "flash_attention", _attention_f64)
    monkeypatch.setattr(ttf, "flash_attention", _attention_f64)
    _, g64 = steps.value_and_grad(
        model, tl.map_leaves(lambda _p, t: t.double(), params),
        {k: v.double() if v.is_floating_point() else v
         for k, v in batch.items()})
    dist = max((((a.double() - b).abs() / (1 + b.abs())).max().item()
                for (_, a), (_, b) in zip(tl.iter_leaves(g32),
                                          tl.iter_leaves(g64))))
    lo, hi = CONDITIONING[arch]
    assert lo <= dist <= hi, dist


def _smoke_step_grads(model, params, seed=7):
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(2, 41)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "enc_embeds": torch.from_numpy(rng.standard_normal(
                 (2, 60, cfg.d_model)).astype(np.float32))}
    return steps.value_and_grad(model, params, batch)[1]


def _zero_last(t):
    t = t.clone()
    t[:, -1] = 0
    return t


# faults planted in K4b's output (dq, dk, dv): a masking bug that drops
# the last key position's dk and dv, dv 1% small, dq 1% small
K4B_FAULTS = {
    "last-key-dropped": lambda dq, dk, dv: (dq, _zero_last(dk),
                                            _zero_last(dv)),
    "dv-1pct": lambda dq, dk, dv: (dq, dk, dv * 0.99),
    "dq-1pct": lambda dq, dk, dv: (dq * 0.99, dk, dv),
}


@pytest.mark.parametrize("fault", sorted(K4B_FAULTS))
def test_smoke_step_scaled_limit_fails_planted_faults(monkeypatch, fault):
    """The whisper smoke step's scaled gradient limit (atol 2e-3 of each
    leaf's largest magnitude, at least 1; rtol 2e-3: the card-vs-CPU
    check of chip_smoke.py's phase 17 and tests/test_torch_cuda.py)
    still fails a wrong step: the step with a fault planted in K4b's
    output (its plain version on the CPU) puts gradient elements out of
    it against the same step without. The card repeats these controls
    in phase 17."""
    from repro_torch.kernels import ops
    cfg = reduce_for_smoke(get_arch(ARCH))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    good = _smoke_step_grads(model, params)
    bwd = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd", lambda *a, **k:
                        K4B_FAULTS[fault](*bwd(*a, **k)))
    bad = _smoke_step_grads(model, params)
    n_out = 0
    for (_, a), (_, b) in zip(tl.iter_leaves(bad), tl.iter_leaves(good)):
        atol = 2e-3 * max(1.0, b.abs().max().item())
        n_out += int(((a - b).abs() > atol + 2e-3 * b.abs()).sum())
    assert n_out > 0
