"""The port's attention against the JAX package on the same inputs:
``kernels.ops.flash_attention`` (plain version on the CPU) against the
Pallas kernel in interpret mode and against the jnp reference on ragged
lengths, and per-slot ``decode_attention`` against JAX per slot.

Tolerances are those of tests/test_kernels.py:34: 2e-5 in float32, 2e-2
in bfloat16 (the two frameworks round bf16 at other points)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro.models.attention import repeat_kv as jax_repeat_kv
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import decode_attention, repeat_kv

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    """The same values as JAX and torch arrays of ``dtype``."""
    j = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),       # GQA
    (1, 128, 4, 1, 128),      # MQA
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_pallas(B, S, H, KV, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(0, B, S, S, H, KV, hd), dtype)
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal,
                                   block_q=64, block_k=64)
    before = kfa.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert kfa.launches == before          # CPU tensors: plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, S, H, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("S", [7, 37])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_vs_jnp_ref(S, causal, dtype):
    B, H, KV, hd = 2, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, B, S, S, H, KV, hd), dtype)
    want = jax_flash_ref(jq, jax_repeat_kv(jk, H), jax_repeat_kv(jv, H),
                         causal=causal, q_chunk=16, k_chunk=16)
    _close(ops.flash_attention(tq, tk, tv, causal=causal), want, dtype)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_flash_attention_q_offset_vs_jnp_ref(q_offset):
    B, Sq, Sk, H, KV, hd = 1, 9, 14, 4, 4, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(2, B, Sq, Sk, H, KV, hd), "float32")
    want = jax_flash_ref(jq, jk, jv, causal=True, q_offset=q_offset,
                         q_chunk=8, k_chunk=8)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset)
    _close(got, want, "float32")


def test_plain_version_chunking_invariant():
    """The plain version gives the same result at any chunking (the
    kernel tiles differently from it)."""
    _, (tq, tk, tv) = _both(_inputs(3, 2, 37, 37, 4, 2, 16), "float32")
    a = ref.flash_attention_ref(tq, tk, tv, causal=True)
    b = ref.flash_attention_ref(tq, tk, tv, causal=True, q_chunk=8,
                                k_chunk=5)
    torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


def test_flash_attention_rejects_mixed_or_other_devices():
    _, (tq, tk, tv) = _both(_inputs(0, 1, 8, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError):             # mixed: meta and CPU
        ops.flash_attention(tq.to("meta"), tk, tv, causal=True)
    _, (q3, k2, v2) = _both(_inputs(0, 1, 8, 8, 3, 2, 16), "float32")
    with pytest.raises(ValueError):             # H % KV != 0
        ops.flash_attention(q3, k2, v2, causal=True)
    with pytest.raises(ValueError):             # kernel path, CPU tensors
        kfa.flash_attention_cuda(tq, tk, tv, causal=True)


def test_repeat_kv_matches_jax():
    k = np.random.RandomState(4).standard_normal((2, 5, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        repeat_kv(torch.from_numpy(k), 6).numpy(),
        np.asarray(jax_repeat_kv(jnp.asarray(k), 6)))


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_per_slot_lengths(H, KV, dtype):
    """Slots at different depths in one batched call equal JAX's scalar
    ``decode_attention`` run slot by slot."""
    B, S, hd = 3, 16, 16
    rng = np.random.RandomState(5)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    lengths = np.array([1, 9, 16])
    (jq, jk, jv), (tq, tk, tv) = _both([q, kc, vc], dtype)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    for b in range(B):
        want = jax_decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                                    int(lengths[b]))
        _close(got[b:b + 1], want, dtype)
