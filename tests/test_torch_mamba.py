"""The port's ssm family (Mamba-2) against the JAX package on the same
inputs and weights: the SSD scan's plain version (K5's CPU path) against
``repro.models.mamba.ssd_scan_ref`` and the Pallas kernel, the block's
layers and their gradients, the training loss, prefill / decode and the
caches, the flat layout, and the serving engine's tokens (the scan's
backward alone: tests/test_torch_ssd_bwd.py).

Tolerances: the scan as tests/test_kernels.py:56 (1e-3 in float32, 5e-2
in bfloat16, for y and the final state); the layers and the model as
tests/test_torch_model.py (``LAYER_TOL`` 1e-5, ``MODEL_TOL`` 1e-4, f32:
the two frameworks sum in other orders); a block's gradients 1e-4; the
loss's gradients 2e-3, ``GRAD_TOL`` of tests/test_torch_training.py."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed.sharding import Dist
from repro.kernels import ops as jax_ops
from repro.models import make_model as jax_make_model
from repro.models import mamba as jm
from repro.runtime.learner import _flat_io
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.models import make_model
from repro_torch.models import mamba as tm
from repro_torch.models.layers import iter_leaves, map_leaves
from repro_torch.models.transformer import layer_params
from repro_torch.serving.engine import InferenceEngine
from repro_torch.weights import flat_layout, params_from_flat

ARCH = "mamba2-1.3b"
SSD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
OPTS = {"remat": "none"}
MAX_SEQ = 64


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _scan_inputs(B, S, H, P, G, N, seed=0):
    """tests/test_kernels.py:47-51's inputs, made with numpy."""
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, P)) * 0.5,
        np.log1p(np.exp(rng.standard_normal((B, S, H)))),     # softplus
        rng.standard_normal(H) * 0.5,
        rng.standard_normal((B, S, G, N)) * 0.3,
        rng.standard_normal((B, S, G, N)) * 0.3)]


def _both(arrays, dtype):
    """The same values in both packages; x, b and c in ``dtype``."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    cast = (True, False, False, True, True)
    t = [torch.from_numpy(a).to(tdt if c else torch.float32)
         for a, c in zip(arrays, cast)]
    j = [jnp.asarray(a).astype(jdt if c else jnp.float32)
         for a, c in zip(arrays, cast)]
    return t, j


SCAN_SHAPES = [
    (1, 128, 2, 16, 1, 16, 32),       # tests/test_kernels.py:41-45
    (2, 256, 4, 32, 2, 16, 64),
    (1, 128, 4, 64, 1, 32, 128),
    (1, 100, 2, 16, 1, 16, 32),       # ragged tail
    (2, 7, 2, 16, 1, 16, 32),         # shorter than a chunk
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_jax_ref(B, S, H, P, G, N, chunk, dtype):
    t, j = _both(_scan_inputs(B, S, H, P, G, N), dtype)
    y, state = ops.ssd_scan(*t, chunk=chunk)
    y_ref, state_ref = jm.ssd_scan_ref(*j, chunk)
    assert y.dtype == t[0].dtype and tuple(y.shape) == (B, S, H, P)
    assert state.dtype == torch.float32 and \
        tuple(state.shape) == (B, H, P, N)
    tol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(state), _np(state_ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES[:3])
def test_ssd_scan_plain_matches_pallas_kernel(B, S, H, P, G, N, chunk):
    """Against the Pallas kernel in interpret mode (f32, S % chunk == 0;
    it returns no state)."""
    t, j = _both(_scan_inputs(B, S, H, P, G, N, seed=1), "float32")
    y, _ = ops.ssd_scan(*t, chunk=chunk)
    y_k = jax_ops.ssd_scan(*j, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_k), atol=1e-3, rtol=1e-3)


def test_ssd_scan_plain_chunk_invariance():
    """tests/test_kernels.py:122: the state carries across 8 and 4
    chunks alike (slow decay couples far positions)."""
    x, _, _, b, c = _scan_inputs(1, 512, 1, 8, 1, 8, seed=2)
    args = [torch.from_numpy(x), torch.full((1, 512, 1), 0.5),
            torch.full((1,), -1.0), torch.from_numpy(b),
            torch.from_numpy(c)]
    y64, s64 = ops.ssd_scan(*args, chunk=64)
    y128, s128 = ops.ssd_scan(*args, chunk=128)
    np.testing.assert_allclose(_np(y64), _np(y128), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(s64), _np(s128), atol=1e-3, rtol=1e-3)


def test_ssd_scan_rejects_bad_shapes():
    x, dt, al, b, c = map(torch.from_numpy, _scan_inputs(1, 8, 3, 4, 2, 4))
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_scan(x, dt, al, b, c, chunk=4)
    x, dt, al, b, c = map(torch.from_numpy, _scan_inputs(1, 8, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_scan(x, dt[:, :4], al, b, c, chunk=4)


# ---------------------------------------------------------------------------
# The block and the model, from one JAX-initialised flat vector
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """One JAX-initialised flat vector loaded into both packages, with
    A_log, dt_bias, D_skip, norm and the conv taps made non-constant so
    that each is tested."""
    jcfg = jax_reduce(jax_get_arch(ARCH))
    jmodel = jax_make_model(jcfg, Dist(), dict(OPTS))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    ravel, unravel = _flat_io(shapes)
    flat = np.array(ravel(jmodel.init(jax.random.PRNGKey(1))))
    cfg = reduce_for_smoke(get_arch(ARCH))
    rng = np.random.RandomState(4)
    for path, shape, off in flat_layout(cfg):
        leaf = path.split("/")[-1]
        n = int(np.prod(shape))
        if leaf in ("A_log", "dt_bias", "D_skip", "norm", "conv_x",
                    "conv_B", "conv_C"):
            flat[off:off + n] += rng.standard_normal(n) * 0.2
    jparams = unravel(jnp.asarray(flat))
    tparams = params_from_flat(flat, cfg, device="cpu")
    return jmodel, jparams, make_model(cfg), tparams, cfg, flat


def _layer(setup, l=0):
    jmodel, jparams, model, tparams, cfg, _ = setup
    jp = jax.tree.map(lambda a: a[l], jparams["blocks"]["mamba"])
    return jp, layer_params(tparams["blocks"], l)["mamba"], cfg


def test_causal_conv_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm.causal_conv(torch.from_numpy(x), torch.from_numpy(w))),
        _np(jm.causal_conv(jnp.asarray(x), jnp.asarray(w))), **LAYER_TOL)


@pytest.mark.parametrize("S", [40, 2])     # S = 2: padded conv tail
def test_mamba_block_matches_jax(setup, S):
    jp, tp, cfg = _layer(setup)
    x = np.random.RandomState(5).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    out, state, tail = tm.mamba_block(torch.from_numpy(x), tp, cfg)
    jout, jstate, jtail = jm.mamba_block(jnp.asarray(x), jp, cfg, Dist())
    k = cfg.ssm.conv_kernel
    assert tuple(tail.shape) == (2, k - 1, tail.shape[-1])
    for a, b in ((out, jout), (state, jstate), (tail, jtail)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **LAYER_TOL)
    if S < k - 1:
        assert torch.all(tail[:, :k - 1 - S] == 0)


def test_mamba_decode_matches_jax(setup):
    jp, tp, cfg = _layer(setup)
    rng = np.random.RandomState(6)
    d_in, nheads, gn, k = tm.mamba_dims(cfg)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal(
        (2, nheads, cfg.ssm.head_dim, cfg.ssm.d_state)).astype(np.float32)
    tail = rng.standard_normal((2, k - 1, d_in + 2 * gn)).astype(np.float32)
    got = tm.mamba_decode(*map(torch.from_numpy, (x,)), tp, cfg,
                          torch.from_numpy(state), torch.from_numpy(tail))
    want = jm.mamba_decode(jnp.asarray(x), jp, cfg, Dist(),
                           jnp.asarray(state), jnp.asarray(tail))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **LAYER_TOL)


def test_prefill_and_decode_match_jax(setup):
    """Prefill logits and the (ssm, conv) cache against JAX's
    ``lm_prefill`` (40 tokens: a chunk of 32 and a ragged 8), then one
    decode step against ``lm_decode``."""
    jmodel, jparams, model, params, cfg, _ = setup
    rng = np.random.RandomState(7)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = model.prefill(
        params, {"tokens": torch.from_numpy(toks).long()})
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in ("ssm", "conv"):
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape)
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **MODEL_TOL)
    assert tcache["ssm"].dtype == torch.float32
    assert tcache["pos"].tolist() == [40, 40]
    nxt = rng.randint(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
    jlog, jcache = jmodel.decode(jparams, jcache,
                                 {"tokens": jnp.asarray(nxt)})
    tlog, tcache = model.decode(params, tcache,
                                {"tokens": torch.from_numpy(nxt).long()})
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **MODEL_TOL)
    assert tcache["pos"].tolist() == [41, 41]


@pytest.mark.parametrize("S", [32, 40, 2])
def test_decode_matches_prefill(setup, S):
    """Prefill over S+1 tokens gives the last-position logits of prefill
    over S followed by one decode step (tests/test_models_smoke.py:56),
    through a batched cache written by slot."""
    _, _, model, params, cfg, _ = setup
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(2, S + 1))).long()
    full, _ = model.prefill(params, {"tokens": toks})
    cache = model.empty_cache(3, S + 1, "cpu")
    model.prefill(params, {"tokens": toks[:, :S]}, cache=cache,
                  slots=torch.tensor([2, 0]))
    assert cache["pos"].tolist() == [S, 0, S]
    step, _ = model.decode(params, cache, {"tokens": torch.stack(
        [toks[1, S:], toks[0, S:], toks[0, S:]])})
    np.testing.assert_allclose(_np(step[[2, 0]]), _np(full), **MODEL_TOL)


def test_flat_layout_matches_jax_flat_io():
    """The flat vector's leaves, shapes and order are those of JAX's
    ``_flat_io`` for full-size mamba2-1.3b."""
    jmodel = jax_make_model(jax_get_arch(ARCH), Dist(), dict(OPTS))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in leaves]
    got = [(path, shape) for path, shape, _ in flat_layout(get_arch(ARCH))]
    assert got == want
    assert got[0][0] == "blocks/ln1/w" and got[1][0] == "blocks/mamba/A_log"
    n = sum(int(np.prod(s, dtype=np.int64)) for _, s in got)
    # the config's n_params() counts two d_model norms per layer; the
    # model has ln1 (d_model) and the gated norm (d_inner) per layer, and
    # a final norm: 48 * 2048 + 2048 values more
    assert n == get_arch(ARCH).n_params() + 49 * 2048 == 1_446_505_472


@pytest.mark.parametrize("S", [64, 40])     # two chunks; a ragged tail
def test_loss_matches_jax_lm_loss(setup, S):
    """The ssm training loss (per layer ln1 -> ``mamba_block`` ->
    residual, final norm, chunked CE) against JAX's ``lm_loss``, and its
    gradient by leaf against ``jax.grad`` (autograd through ``SSDScan``
    and its plain backward here)."""
    jmodel, jparams, model, params, cfg, _ = setup
    rng = np.random.RandomState(11)
    toks = rng.randint(0, cfg.vocab_size, size=(2, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.value_and_grad(jmodel.loss)(jparams, jb)
    leaves = {path: t.detach().clone().requires_grad_()
              for path, t in iter_leaves(params)}
    tree = map_leaves(lambda path, _: leaves[path], params)
    tl = model.loss(tree, {k: torch.from_numpy(np.array(v)).long()
                           for k, v in jb.items()})
    np.testing.assert_allclose(tl.item(), float(jl), **MODEL_TOL)
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    jflat = dict(iter_leaves(jg))
    for path, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(jflat[path]), atol=2e-3,
                                   rtol=2e-3, err_msg=path)


@pytest.mark.parametrize("S", [40, 2])
def test_mamba_block_gradients_match_jax(setup, S):
    """Gradients of one block's output against ``jax.grad`` of JAX's
    ``mamba_block``: the input and every weight of the layer, through
    the conv, gating, norm and ``SSDScan`` (its plain backward here)."""
    jp, tp, cfg = _layer(setup)
    rng = np.random.RandomState(12)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jf(x_, p_):
        return jnp.sum(jm.mamba_block(x_, p_, cfg, Dist())[0] * w)
    jgx, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tps = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    out = tm.mamba_block(tx, tps, cfg)[0]
    names = sorted(tps)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              [tx] + [tps[k] for k in names])
    np.testing.assert_allclose(_np(got[0]), _np(jgx), atol=1e-4, rtol=1e-4)
    for k, g in zip(names, got[1:]):
        np.testing.assert_allclose(_np(g), _np(jgp[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

PROMPT_LENS = [40, 40, 2, 33, 7]     # chunk 32 crossed; 2 < conv window
MAX_NEW = [3, 6, 4, 5, 7]


def _serve(eng, prompts, timeout=120.0):
    reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, MAX_NEW)]
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    for r in reqs:
        assert r.wait(timeout), f"request {r.req_id} stuck: {r.status}"
    eng.drain()
    t.join(20)
    assert not t.is_alive()
    assert all(r.status == "DONE" for r in reqs)
    return [r.tokens for r in reqs]


def _alone(model, params, prompt, max_new):
    """Greedy decode of one request alone in a one-slot cache."""
    cache = model.empty_cache(1, MAX_SEQ, "cpu")
    with torch.no_grad():
        logits, _ = model.prefill(
            params, {"tokens": torch.from_numpy(prompt[None]).long()},
            cache=cache, slots=torch.tensor([0]))
        toks = [int(logits[0, -1].argmax())]
        while len(toks) < max_new:
            logits, cache = model.decode(
                params, cache, {"tokens": torch.tensor([[toks[-1]]])})
            toks.append(int(logits[0, -1].argmax()))
    return toks


def test_engine_midflight_joins_match_alone_and_jax_engine(setup):
    """5 requests over 2 slots (joins into freed slots mid-flight): each
    request's tokens equal that request decoded alone, and equal the JAX
    engine's tokens from the same flat vector."""
    _, _, _, _, cfg, flat = setup
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = InferenceEngine(cfg, capacity=2, max_seq=MAX_SEQ, device="cpu",
                          endpoint_id="ep-mamba")
    eng.start(flat)
    port = _serve(eng, prompts)
    assert eng.prefill_batches >= 4               # joins did happen
    assert eng._cache["ssm"].shape[1] == 2
    for p, m, toks in zip(prompts, MAX_NEW, port):
        assert len(toks) == m
        assert toks == _alone(eng.model, eng.params, p, m)
    jax_eng = JaxEngine(jax_reduce(jax_get_arch(ARCH)), capacity=2,
                        max_seq=MAX_SEQ, endpoint_id="ep-mamba-jax")
    jax_eng.start(flat)
    assert port == _serve(jax_eng, prompts)
    jax_eng.release()


def test_engine_default_device_is_cuda_without_fallback(monkeypatch):
    """Built without ``device=``, the mamba2 engine wants CUDA; with none
    present it raises instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(get_arch(ARCH))
