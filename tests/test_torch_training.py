"""The port's training path against the JAX package on the same inputs:
the flash forward with its row LSE and the flash backward (plain
versions, what the CPU runs and the card's K4/K4b are held against),
``FlashAttention`` through autograd, ``chunked_xent``, and the loss and
flat gradient of ``LMPlugin.flat_loss_grad`` against JAX's
``LMPlugin._flat_lg`` on JAX's own ``flat_state(0)`` (dense and ssm).

Everything in float32 on the CPU, where the point is the algorithm.
Tolerances: attention forward and LSE 2e-5 (tests/test_kernels.py:34);
attention gradients 2e-3 (tests/test_kernels.py:139-162); chunked CE
1e-5; the model's loss 1e-4 and flat gradient 2e-3 (atol and rtol; the
two frameworks sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import Dist
from repro.models.attention import _flash_fwd_lse
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro.models.attention import repeat_kv as jax_repeat_kv
from repro.models.layers import chunked_xent as jax_chunked_xent
from repro.runtime.learner import LMPlugin as JaxLMPlugin
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_attention_bwd as kfab
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import FlashAttention, flash_attention
from repro_torch.models.layers import chunked_xent
from repro_torch.runtime.learner import LMPlugin

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)

# (B, Sq, H, KV, hd, causal, q_offset): GQA, MQA, ragged S, q_offset
CASES = [
    (2, 64, 4, 4, 32, True, 0),
    (2, 48, 4, 2, 16, True, 0),         # GQA
    (1, 37, 4, 1, 32, True, 0),         # MQA, ragged
    (2, 37, 4, 2, 16, False, 0),        # ragged, non-causal
    (1, 21, 2, 2, 64, True, 5),         # q_offset
]


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def _jax_attn(q, k, v, causal, q_offset):
    H = q.shape[2]
    S = q.shape[1]
    return jax_flash_ref(q, jax_repeat_kv(k, H), jax_repeat_kv(v, H),
                         causal=causal, q_offset=q_offset, q_chunk=S,
                         k_chunk=S)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,q_offset", CASES)
def test_forward_with_lse_matches_jax(B, S, H, KV, hd, causal, q_offset):
    q, k, v, _ = _inputs(0, B, S, H, KV, hd)
    jo, jlse = _flash_fwd_lse(
        jnp.asarray(q), jax_repeat_kv(jnp.asarray(k), H),
        jax_repeat_kv(jnp.asarray(v), H), causal, q_offset, S, S, S)
    before = kfa.launches
    o, lse = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, q_offset=q_offset,
                                 return_lse=True)
    assert kfa.launches == before
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    # the same output with and without the LSE, at any chunking
    o2 = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, q_offset=q_offset,
                                 q_chunk=16, k_chunk=8)
    torch.testing.assert_close(o, o2, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,q_offset", CASES)
def test_backward_matches_jax_grad(B, S, H, KV, hd, causal, q_offset):
    """The plain flash backward (from o and lse) and ``FlashAttention``
    through autograd against ``jax.grad`` of the jnp reference."""
    q, k, v, w = _inputs(1, B, S, H, KV, hd)

    def f(q_, k_, v_):
        return jnp.sum(_jax_attn(q_, k_, v_, causal, q_offset) * w)
    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    o, lse = ops.flash_attention(tq, tk, tv, causal=causal,
                                 q_offset=q_offset, return_lse=True)
    before = kfab.launches
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, tw, causal=causal,
                                  q_offset=q_offset)
    assert kfab.launches == before
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, causal, q_offset)
    auto = torch.autograd.grad((out * tw).sum(), leaves)
    for g, want in zip(auto, got):
        torch.testing.assert_close(g, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,q_offset", [(True, 5), (False, 0)])
def test_backward_with_other_lengths_matches_jax_grad(causal, q_offset):
    """Sq != Sk (a query block against a longer key range), GQA."""
    rng = np.random.RandomState(6)
    q, do = (rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, 14, 2, 16)).astype(np.float32)
            for _ in range(2))

    def f(q_, k_, v_):
        out = jax_flash_ref(q_, jax_repeat_kv(k_, 4), jax_repeat_kv(v_, 4),
                            causal=causal, q_offset=q_offset, q_chunk=9,
                            k_chunk=14)
        return jnp.sum(out * do)
    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, q_offset=q_offset)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL)


def test_flash_attention_picks_autograd_only_when_needed():
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 1, 16, 2, 2, 16))
    assert not flash_attention(q, k, v, causal=True).requires_grad
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v, causal=True)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(qg, k, v, causal=True).grad_fn is None


def test_backward_rejects_bad_shapes():
    q, k, v, w = map(torch.from_numpy, _inputs(3, 1, 8, 2, 2, 16))
    o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :1], w, causal=True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, o[:, :4], lse, w, causal=True)
    with pytest.raises(ValueError):     # kernel path, CPU tensors
        kfab.flash_attention_bwd_cuda(q, k, v, o, lse, w, causal=True)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (16, 64)])
def test_chunked_xent_matches_jax(S, chunk):
    rng = np.random.RandomState(4)
    B, D, V = 2, 16, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    lab = rng.randint(0, V, size=(B, S)).astype(np.int32)

    def f(h_, w_):
        return jax_chunked_xent(h_, w_, jnp.asarray(lab), Dist(),
                                chunk=chunk)
    jl, (jgh, jgw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = chunked_xent(th, tw, torch.from_numpy(lab).long(), chunk=chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(AssertionError):         # S % chunk, as JAX
        chunked_xent(th[:, :S - 1], tw, torch.from_numpy(lab).long(),
                     chunk=min(chunk, S - 2) if S > 2 else 1)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen1.5-110b",
                                  "granite-20b", "minitron-8b",
                                  "mamba2-1.3b"])
def test_flat_loss_grad_matches_jax(arch):
    """Loss and flat gradient of one step from JAX's own flat_state(0):
    the port's flat order is ``_flat_io``'s, leaf for leaf. mamba2-1.3b
    crosses its chunk of 32 (64 positions) and trains through
    ``SSDScan``."""
    jp = JaxLMPlugin({"arch": arch})
    flat = jp.flat_state(0)
    tp = LMPlugin({"arch": arch}, device="cpu")
    assert tp.flat_size == flat.size
    toks = np.random.RandomState(5).randint(
        0, tp.vocab, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jp.flat_loss_grad(flat, batch)
    tl, tg = tp.flat_loss_grad(flat, batch)
    assert tg.shape == (flat.size,) and tg.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
    # the qkv biases are leaves of their own and get their own gradient
    if arch.startswith("qwen"):
        from repro_torch.weights import flat_layout
        offs = {p: (o, int(np.prod(s))) for p, s, o in
                flat_layout(tp.cfg)}
        o, n = offs["blocks/attn/bq"]
        assert np.abs(tg[o:o + n].numpy()).max() > 0


def test_flat_state_is_model_init_rounded_to_model_dtype():
    from repro_torch.weights import flat_from_params
    tp = LMPlugin({}, device="cpu")
    a = tp.flat_state(3)
    b = flat_from_params(tp.model.init(torch.Generator().manual_seed(3)))
    assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    assert not np.array_equal(a.numpy(), tp.flat_state(4).numpy())


def test_bf16_gradient_flat_is_the_stacked_gradient_widened():
    """A bf16 model (the card's training dtype) returns its flat gradient
    in bf16, with the values of autograd through the stacked param tree
    of ``params_from_flat`` widened to f32 (the reference's ravel), bit
    for bit: both differentiate one graph on the same bf16 weights. Its
    int8 push reads it as f32, so the PS lands the same params as from a
    push of the widening."""
    import dataclasses

    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.software_ps import SoftwareParameterServer
    from repro_torch.models.layers import iter_leaves
    from repro_torch.weights import params_from_flat
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("stablelm-1.6b")),
                              dtype="bfloat16")
    tp = LMPlugin({}, cfg=cfg, device="cpu")
    flat = tp.flat_state(0)
    toks = np.random.RandomState(6).randint(
        0, tp.vocab, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, g = tp.flat_loss_grad(flat, batch)
    assert g.dtype == torch.bfloat16 and g.shape == (tp.flat_size,)

    tree = params_from_flat(flat.numpy(), cfg, device="cpu")
    leaves = [t.requires_grad_() for _, t in iter_leaves(tree)]
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    want_loss = tp.model.loss(tree, b, xent_chunk=tp.XENT_CHUNK)
    want = torch.cat([x.float().reshape(-1) for x in
                      torch.autograd.grad(want_loss, leaves)])
    assert loss.item() == want_loss.item()
    assert torch.equal(g.float(), want)

    pulled = []
    for x in (g, g.float()):
        ps = SoftwareParameterServer(flat, n_shards=2, optimizer="adam",
                                     lr=1e-3, compression="int8",
                                     device="cpu")
        ps.join(0)
        assert ps.make_client(0).push(x)
        pulled.append(ps.pull(0).clone())
    assert torch.equal(*pulled)
