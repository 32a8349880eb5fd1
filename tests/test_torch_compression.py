"""The port's int8 wire compression (``repro_torch.core.compression``)
against the JAX package's (``repro.core.compression``) on the same
inputs, plus the scheme's own properties: error feedback is unbiased
over time, and the wire moves ~4x fewer bytes.

Tolerances as tests/test_compression.py: q equal, scales rtol 1e-6,
residual atol 1e-6; the dequantized wire view is a single product, so it
is held to the same atol. Unbiasedness over 50 rounds to amax/100, as
tests/test_compression.py:50-60."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc
from repro_torch.kernels import quantize as kq


def _vec(seed, n, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(n) * scale).astype(
        np.float32)


@pytest.mark.parametrize("n", [256, 2048])
@pytest.mark.parametrize("scale", [0.01, 1.0, 50.0])
def test_compress_with_feedback_matches_jax(n, scale):
    x, e = _vec(0, n, scale), _vec(1, n, 0.1 * scale)
    q, s, err, wire = tc.compress_with_feedback(torch.from_numpy(x),
                                                torch.from_numpy(e))
    jq, js, jerr, jwire = jc.compress_with_feedback(jnp.asarray(x),
                                                    jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)
    np.testing.assert_allclose(wire.numpy(), np.asarray(jwire), atol=1e-6)


def test_quantize_dequantize_int8_match_jax():
    x = _vec(2, 1024, 3.0)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(tc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_make_compressor_matches_jax():
    """The push-path compressor (plain version on CPU tensors) returns
    what JAX's push-path compressor returns, and can update the feedback
    buffer in place."""
    x, e = _vec(3, 2048), _vec(4, 2048, 0.1)
    fn = tc.make_compressor()
    before = kq.QUANTIZE.launches
    q, s, err = fn(torch.from_numpy(x), torch.from_numpy(e))
    jq, js, jerr = jc.make_compressor()(jnp.asarray(x), jnp.asarray(e))
    assert kq.QUANTIZE.launches == before
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)
    buf = torch.from_numpy(e.copy())
    _, _, err2 = fn(torch.from_numpy(x), buf, out_err=buf)
    assert err2 is buf and torch.equal(buf, err)


def test_error_feedback_unbiased_over_time():
    """The accumulated transmitted signal converges to the accumulated
    true signal, and matches JAX's feedback loop round by round."""
    x = _vec(5, 512)
    err, sent = torch.zeros(512), torch.zeros(512)
    jerr, jsent = jnp.zeros(512), jnp.zeros(512)
    for _ in range(50):
        _, _, err, wire = tc.compress_with_feedback(torch.from_numpy(x), err)
        sent = sent + wire
        _, _, jerr, jwire = jc.compress_with_feedback(jnp.asarray(x), jerr)
        jsent = jsent + jwire
    np.testing.assert_allclose((sent / 50).numpy(), x,
                               atol=np.abs(x).max() / 100)
    np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), atol=1e-5)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)


def test_compressed_push_wire_accounting():
    p = tc.CompressedPush(q=torch.zeros(1024, dtype=torch.int8),
                          scales=torch.zeros(4), dense_nbytes=4096)
    jp = jc.CompressedPush(q=np.zeros(1024, np.int8),
                           scales=np.zeros(4, np.float32),
                           dense_nbytes=4096)
    assert p.wire_nbytes == jp.wire_nbytes == 1024 + 16
    assert p.dense_nbytes / p.wire_nbytes > 3.9


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 1024])
def test_wire_bytes_and_padding_match_jax(n):
    assert tc.pad_to_block(n) == jc.pad_to_block(n)
    assert tc.wire_bytes(tc.pad_to_block(n)) == \
        jc.wire_bytes(jc.pad_to_block(n))
    assert tc.BLOCK == jc.BLOCK == 256
