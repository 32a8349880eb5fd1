"""The plain versions of the port's PS update (K1) and int8 wire (K2, K3)
kernels — what ``kernels.ops`` runs on CPU tensors and what the card's
kernels are held against — against the JAX package on the same inputs:
its Pallas kernels in interpret mode (``repro.kernels.ops``) and its
oracles (``repro.kernels.ref``).

Tolerances are those of tests/test_kernels.py:60-106 (params 1e-5, m/v
1e-6; over 11 rounds 1e-4 / 1e-5) and tests/test_compression.py:85-122
(q equal, scales rtol 1e-6, err atol 1e-6); dequantize is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ps_aggregate as kagg
from repro_torch.kernels import quantize as kq

SOLVERS = ["sgd", "momentum", "adam", "easgd_center", "average"]


def _state(seed, nl, f):
    rng = np.random.RandomState(seed)
    g = rng.standard_normal((nl, f)).astype(np.float32)
    p = rng.standard_normal(f).astype(np.float32)
    m = (rng.standard_normal(f) * 0.1).astype(np.float32)
    v = np.abs(rng.standard_normal(f) * 0.1).astype(np.float32)
    return g, p, m, v


def _t(*arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("nl,f", [(2, 2048), (8, 4096), (2, 9 * 256)])
def test_ps_aggregate_plain_vs_pallas(solver, nl, f):
    g, p, m, v = _state(0, nl, f)
    pk, mk, vk = jax_ops.ps_aggregate(*map(jnp.asarray, (g, p, m, v)), 3,
                                      solver=solver, lr=0.01)
    tg, tp, tm, tv = _t(g, p, m, v)
    before = kagg.launches
    out = ops.ps_aggregate(tg, tp, tm, tv, 3, solver=solver, lr=0.01)
    assert kagg.launches == before          # CPU tensors: plain version
    assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    np.testing.assert_allclose(tp.numpy(), np.asarray(pk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(mk), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vk), atol=1e-6)


@pytest.mark.parametrize("solver", SOLVERS)
def test_ps_aggregate_plain_tracks_oracles_over_rounds(solver):
    """11 rounds from zero state against the jnp oracle and the JAX CPU
    PS's in-place numpy twin (which takes adam's b^t in float64)."""
    rng = np.random.RandomState(1)
    p0 = rng.standard_normal(1536).astype(np.float32)
    tp, tm, tv = _t(p0, np.zeros(1536, np.float32),
                    np.zeros(1536, np.float32))
    pr, mr, vr = jnp.array(p0), jnp.zeros(1536), jnp.zeros(1536)
    pn, mn, vn = p0.copy(), np.zeros(1536, np.float32), \
        np.zeros(1536, np.float32)
    for step in range(1, 12):
        g = rng.standard_normal((3, 1536)).astype(np.float32)
        ops.ps_aggregate(torch.from_numpy(g), tp, tm, tv, step,
                         solver=solver, lr=0.01)
        pr, mr, vr = jax_ref.ps_aggregate_ref(jnp.array(g), pr, mr, vr,
                                              step, solver=solver, lr=0.01)
        jax_ref.ps_aggregate_np(g, pn, mn, vn, step, solver=solver, lr=0.01)
    for want_p, want_m, want_v in ((pr, mr, vr), (pn, mn, vn)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(want_p),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tm.numpy(), np.asarray(want_m),
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(want_v),
                                   atol=1e-5)


def test_ps_aggregate_reads_strided_rows():
    """A column slice of a wider receive buffer (the PS's shard view)
    gives the same update as a contiguous copy of it."""
    g, p, m, v = _state(2, 3, 1024)
    wide = torch.from_numpy(np.concatenate(
        [np.ones((3, 256), np.float32), g, np.ones((3, 256), np.float32)],
        axis=1))
    rows = wide[:, 256:256 + 1024]
    assert not rows.is_contiguous()
    a = _t(p, m, v)
    b = _t(p, m, v)
    ops.ps_aggregate(rows, *a, 2, solver="adam", lr=0.01)
    ops.ps_aggregate(rows.contiguous(), *b, 2, solver="adam", lr=0.01)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_ps_aggregate_rejects_bad_input():
    g, p, m, v = _t(*_state(3, 2, 256))
    with pytest.raises(ValueError):
        ops.ps_aggregate(g, p, m, v, 1, solver="adagrad")
    with pytest.raises(ValueError):
        ops.ps_aggregate(g, p[:128], m, v, 1)
    with pytest.raises(TypeError):
        ops.ps_aggregate(g.double(), p, m, v, 1)
    with pytest.raises(ValueError):     # kernel path, CPU tensors
        kagg.ps_aggregate_cuda(g, p, m, v, 1, solver="sgd", lr=0.1, b1=0.9,
                               b2=0.999, eps=1e-8, momentum=0.9, beta=0.9)


def _quant_inputs(n, seed, ties=False):
    rng = np.random.RandomState(seed)
    if not ties:
        x = rng.standard_normal(n).astype(np.float32)
        e = (rng.standard_normal(n) * 0.1).astype(np.float32)
        return x, e
    # y = x + err holds exact ties (k + 0.5) * scale; each block's absmax
    # is 127 * scale so the scale is exact; err = 0 on the tie positions
    scale = np.float32(0.25)
    y = ((rng.randint(-126, 126, size=n) + 0.5) * scale).astype(np.float32)
    y[::256] = 127 * scale
    e = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    e[::2] = 0.0
    return (y - e).astype(np.float32), e


@pytest.mark.parametrize("n", [256, 1024, 8192])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ties", [False, True])
def test_quantize_plain_vs_pallas_and_oracle(n, seed, ties):
    x, e = _quant_inputs(n, seed, ties)
    qk, sk, ek = jax_ops.quantize_ef(jnp.asarray(x), jnp.asarray(e))
    qr, sr, er = jax_ref.quantize_ref(jnp.asarray(x), jnp.asarray(e))
    before = kq.QUANTIZE.launches
    q, s, ne = ops.quantize_ef(torch.from_numpy(x), torch.from_numpy(e))
    assert kq.QUANTIZE.launches == before
    assert q.dtype == torch.int8 and s.shape == (n // 256,)
    for wq, ws, we in ((qk, sk, ek), (qr, sr, er)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
        np.testing.assert_allclose(ne.numpy(), np.asarray(we), atol=1e-6)
    if ties:
        # every tie position rounds half to even
        assert (q.numpy()[2::2][np.arange(1, n // 2) % 128 != 0] % 2
                == 0).all()


def test_quantize_ties_round_half_to_even():
    """y / scale = k + 0.5 exactly: q is the even neighbour, as
    ``jnp.round`` gives, never the one ``floor(x + 0.5)`` gives."""
    y = np.zeros(256, np.float32)
    y[0] = 127.0                        # scale = 1 exactly
    y[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    q, s, ne = ops.quantize_ef(torch.from_numpy(y), torch.zeros(256))
    assert s.item() == 1.0
    assert q[:6].tolist() == [127, 0, 2, 2, 0, -2]
    assert ne[1:6].tolist() == [0.5, -0.5, 0.5, -0.5, -0.5]


def test_quantize_bf16_input_is_its_f32_widening():
    x, e = _quant_inputs(1024, 3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.quantize_ef(xb, torch.from_numpy(e))
    want = ops.quantize_ef(xb.float(), torch.from_numpy(e))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the same function as JAX's x.astype(f32) + err on a bf16 x
    qj, sj, ej = jax_ref.quantize_ref(jnp.asarray(x).astype(jnp.bfloat16),
                                      jnp.asarray(e))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(qj))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ej), atol=1e-6)


def test_quantize_writes_new_err_in_place():
    x, e = _quant_inputs(512, 4)
    err = torch.from_numpy(e.copy())
    q, s, ne = ops.quantize_ef(torch.from_numpy(x), err, out_err=err)
    assert ne is err
    _, _, want = ref.quantize_ref(torch.from_numpy(x), torch.from_numpy(e))
    assert torch.equal(err, want)


@pytest.mark.parametrize("n", [256, 4096])
def test_dequantize_plain_vs_pallas(n):
    x, e = _quant_inputs(n, 5)
    q, s, _ = jax_ref.quantize_ref(jnp.asarray(x), jnp.asarray(e))
    want = np.asarray(jax_ops.dequantize(q, s))
    tq = torch.from_numpy(np.asarray(q).copy())
    ts = torch.from_numpy(np.asarray(s).copy())
    before = kq.DEQUANTIZE.launches
    np.testing.assert_array_equal(ops.dequantize(tq, ts).numpy(), want)
    np.testing.assert_array_equal(
        ref.dequantize_ref(tq, ts).numpy(),
        np.asarray(jax_ref.dequantize_ref(q, s)))
    # into a row of a wider buffer (the PS receive row), tail untouched
    rows = torch.full((2, n), 3.0)
    out = ops.dequantize(tq, ts, out=rows[1])
    assert out.data_ptr() == rows[1].data_ptr()
    np.testing.assert_array_equal(rows[1].numpy(), want)
    assert (rows[0] == 3.0).all()
    assert kq.DEQUANTIZE.launches == before


def test_wire_ops_reject_bad_input():
    with pytest.raises(ValueError):
        ops.quantize_ef(torch.zeros(300), torch.zeros(300))
    with pytest.raises(TypeError):
        ops.quantize_ef(torch.zeros(256, dtype=torch.float16),
                        torch.zeros(256))
    with pytest.raises(ValueError):
        ops.dequantize(torch.zeros(512, dtype=torch.int8), torch.zeros(3))
    with pytest.raises(ValueError):     # kernel path, CPU tensors
        kq.quantize_ef_cuda(torch.zeros(256), torch.zeros(256))
