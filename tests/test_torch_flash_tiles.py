"""A CPU rehearsal of the tile order of the bf16 tensor-core flash kernels
(kernels/csrc/flash_attention.cu ``flash_fwd_kernel_tc`` and
flash_attention_bwd.cu ``flash_bwd_dq_tc_kernel`` /
``flash_bwd_dkv_tc_kernel``), held against the JAX package.

The emulation below walks the tiles as the kernels do: blocks of 128
rows split into two warpgroups of 64; key tiles of 128 (hd 64) or 64
(hd 128) in the forward and 64 in the dq kernel; key blocks of 128 and
query tiles of 64 (32 at hd 128) in the dk/dv kernel, which walks the
query heads of its KV head; online softmax per key tile; tiles above a
warpgroup's diagonal skipped and only the diagonal and ragged tiles
masked, with the kernels' own predicates; P and dS rounded to bf16 as
the operands of the next product (``round_ops``), every sum in f32.

The reference is ``repro.models.attention.flash_attention_ref`` and the
gradients of JAX's custom-VJP flash attention through it, from the same
numpy inputs. Tolerances: with the bf16 operand rounding off, in f32,
atol = rtol = 1e-5 (only the order of f32 sums differs); with it on,
atol = rtol = 2e-2 for O and relative L2 <= 2e-2 per gradient, the
limits the card's bf16 checks use (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro.models.attention import repeat_kv as jax_repeat_kv

NEG_INF = -1e30
WG = 64                       # rows per warpgroup
BWD_REL_L2 = 2e-2


def _tiles(hd):
    """(fwd key tile, dk/dv query tile) of the kernels at head dim hd."""
    return (128 if hd == 64 else 64), (64 if hd == 64 else 32)


def _bf16(x, on):
    return x.to(torch.bfloat16).float() if on else x


def _pad_rows(x, r0, n, total):
    """Rows [r0, r0 + n) of x (.., S, hd), zero past `total` (the
    kernels' zero-filled copies)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    m = max(0, min(n, total - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


def emulate_fwd(q, k, v, *, causal, q_offset=0, round_ops=True,
                visits=None, tile_hd=None):
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd) f32 -> o (B, H, Sq, hd), lse
    (B, H, Sq). ``visits`` collects (warpgroup first row, key tile start)
    of every tile a warpgroup multiplies. ``tile_hd`` > hd: the tiles are
    that wide, their columns past hd zero-filled as the kernel's copies
    fill them (hd 112 in the hd-128 tiles), the scale hd^-0.5 of the real
    head dim, and only hd output columns kept."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    if tile_hd is not None and tile_hd > hd:
        def pad(t):
            return torch.nn.functional.pad(t, (0, tile_hd - hd))
        o, lse = _emulate_fwd(pad(q), pad(k), pad(v), causal=causal,
                              q_offset=q_offset, round_ops=round_ops,
                              visits=visits, scale=scale)
        return o[..., :hd], lse
    return _emulate_fwd(q, k, v, causal=causal, q_offset=q_offset,
                        round_ops=round_ops, visits=visits, scale=scale)


def _emulate_fwd(q, k, v, *, causal, q_offset, round_ops, visits, scale):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    BK, _ = _tiles(hd)
    kh = k.repeat_interleave(H // KV, dim=1)          # GQA by index
    vh = v.repeat_interleave(H // KV, dim=1)
    o = torch.zeros_like(q)
    lse = torch.zeros(B, H, Sq)
    for q0 in range(0, Sq, 2 * WG):
        k_end = min(Sk, min(q0 + 2 * WG, Sq) + q_offset) if causal else Sk
        for w0 in (q0, q0 + WG):
            if w0 >= Sq:
                continue                              # padding rows only
            wg_end = min(w0 + WG, Sq) + q_offset if causal else Sk
            wg_all = w0 + 1 + q_offset if causal else Sk
            rows = torch.arange(w0, w0 + WG)
            qr = _pad_rows(q, w0, WG, Sq)
            m = torch.full((B, H, WG), NEG_INF)
            l = torch.zeros(B, H, WG)
            acc = torch.zeros(B, H, WG, hd)
            for k0 in range(0, k_end, BK):
                if k0 >= wg_end:
                    continue                          # above the diagonal
                if visits is not None:
                    visits.append((w0, k0))
                s = qr @ _pad_rows(kh, k0, BK, Sk).transpose(-1, -2) * scale
                if k0 + BK > Sk or k0 + BK > wg_all:  # diagonal or ragged
                    cols = torch.arange(k0, k0 + BK)
                    ok = cols[None, :] < Sk
                    if causal:
                        ok = ok & (cols[None, :] <= rows[:, None] + q_offset)
                    s = torch.where(ok, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + _bf16(p, round_ops) @ \
                    _pad_rows(vh, k0, BK, Sk)
                m = m_new
            n = min(WG, Sq - w0)
            denom = torch.clamp(l, min=1e-30)
            o[:, :, w0:w0 + n] = (acc / denom[..., None])[:, :, :n]
            lse[:, :, w0:w0 + n] = (m + torch.log(denom))[:, :, :n]
    return o, lse


def emulate_bwd(q, k, v, o, lse, do, *, causal, q_offset=0,
                round_ops=True, tile_hd=None):
    """(dq, dk, dv) in the kernels' tile order; layouts and ``tile_hd``
    as emulate_fwd (the zero columns of q, k, v, o and dO add nothing to
    S, dP or delta, and only hd gradient columns are kept)."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    if tile_hd is not None and tile_hd > hd:
        def pad(t):
            return torch.nn.functional.pad(t, (0, tile_hd - hd))
        grads = _emulate_bwd(*(pad(t) for t in (q, k, v, o)), lse, pad(do),
                             causal=causal, q_offset=q_offset,
                             round_ops=round_ops, scale=scale)
        return tuple(g[..., :hd] for g in grads)
    return _emulate_bwd(q, k, v, o, lse, do, causal=causal,
                        q_offset=q_offset, round_ops=round_ops, scale=scale)


def _emulate_bwd(q, k, v, o, lse, do, *, causal, q_offset, round_ops,
                 scale):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    _, BQT = _tiles(hd)
    BK = 64
    delta = (do * o).sum(-1)                          # (B, H, Sq), f32
    kh = k.repeat_interleave(group, dim=1)
    vh = v.repeat_interleave(group, dim=1)
    # dq kernel: blocks of 128 query rows, key tiles of 64
    dq = torch.zeros_like(q)
    for q0 in range(0, Sq, 2 * WG):
        k_end = min(Sk, min(q0 + 2 * WG, Sq) + q_offset) if causal else Sk
        for w0 in (q0, q0 + WG):
            if w0 >= Sq:
                continue
            wg_end = min(w0 + WG, Sq) + q_offset if causal else Sk
            wg_all = w0 + 1 + q_offset if causal else Sk
            rows = torch.arange(w0, w0 + WG)
            qr, dor = _pad_rows(q, w0, WG, Sq), _pad_rows(do, w0, WG, Sq)
            lr = _pad_rows(lse[..., None], w0, WG, Sq)
            dr = _pad_rows(delta[..., None], w0, WG, Sq)
            acc = torch.zeros(B, H, WG, hd)
            for k0 in range(0, k_end, BK):
                if k0 >= wg_end:
                    continue
                kt = _pad_rows(kh, k0, BK, Sk)
                s = qr @ kt.transpose(-1, -2)
                dp = dor @ _pad_rows(vh, k0, BK, Sk).transpose(-1, -2)
                p = torch.exp(s * scale - lr)
                if k0 + BK > Sk or k0 + BK > wg_all:
                    cols = torch.arange(k0, k0 + BK)
                    ok = cols[None, :] < Sk
                    if causal:
                        ok = ok & (cols[None, :] <= rows[:, None] + q_offset)
                    p = torch.where(ok, p, 0.0)
                ds = p * (dp - dr) * scale
                acc = acc + _bf16(ds, round_ops) @ kt
            n = min(WG, Sq - w0)
            dq[:, :, w0:w0 + n] = acc[:, :, :n]
    # dk/dv kernel: blocks of 128 keys per KV head, walking the group's
    # query heads and the query tiles from the first that sees the block
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for k0 in range(0, Sk, 2 * WG):
        q_begin = max(0, k0 - q_offset) if causal else 0
        for w0 in (k0, k0 + WG):
            if w0 >= Sk:
                continue
            keys = torch.arange(w0, w0 + WG)
            kr, vr = _pad_rows(k, w0, WG, Sk), _pad_rows(v, w0, WG, Sk)
            dka = torch.zeros(B, KV, WG, hd)
            dva = torch.zeros(B, KV, WG, hd)
            for j in range(group):
                heads = torch.arange(KV) * group + j
                for qs0 in range(q_begin, Sq, BQT):
                    if causal and qs0 + BQT - 1 + q_offset < w0:
                        continue                      # sees no key here
                    qt = _pad_rows(q[:, heads], qs0, BQT, Sq)
                    dot = _pad_rows(do[:, heads], qs0, BQT, Sq)
                    lt = _pad_rows(lse[:, heads, :, None], qs0, BQT, Sq)
                    dlt = _pad_rows(delta[:, heads, :, None], qs0, BQT, Sq)
                    st = kr @ qt.transpose(-1, -2)    # keys x queries
                    dpt = vr @ dot.transpose(-1, -2)
                    p = torch.exp(st * scale - lt.transpose(-1, -2))
                    if qs0 + BQT > Sq or w0 + WG > Sk or \
                            (causal and w0 + WG - 1 > qs0 + q_offset):
                        qi = torch.arange(qs0, qs0 + BQT)
                        ok = (qi[None, :] < Sq) & (keys[:, None] < Sk)
                        if causal:
                            ok = ok & (keys[:, None] <= qi[None, :] + q_offset)
                        p = torch.where(ok, p, 0.0)
                    ds = p * (dpt - dlt.transpose(-1, -2)) * scale
                    dva = dva + _bf16(p, round_ops) @ dot
                    dka = dka + _bf16(ds, round_ops) @ qt
            n = min(WG, Sk - w0)
            dk[:, :, w0:w0 + n] = dka[:, :, :n]
            dv[:, :, w0:w0 + n] = dva[:, :, :n]
    return dq, dk, dv


def _inputs(seed, B, Sq, Sk, H, KV, hd, bf16_values):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
             (B, Sq, H, hd))]
    if bf16_values:        # what the kernel is given: bf16 values
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in arrs]
    return arrs


def _jax_reference(q, k, v, do, H, causal, q_offset):
    """O and (dq, dk, dv) from JAX's flash attention and its custom VJP
    (GQA heads repeated, so the repeat's VJP sums each group)."""
    def f(q, k, v):
        return jax_flash_ref(q, jax_repeat_kv(k, H), jax_repeat_kv(v, H),
                             causal=causal, q_offset=q_offset,
                             q_chunk=64, k_chunk=64)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _bhsd(a):
    return torch.from_numpy(a).permute(0, 2, 1, 3).contiguous()


def _bshd(t):
    return t.permute(0, 2, 1, 3).numpy()


CASES = [
    # B, Sq, Sk, H, KV, hd, causal, q_offset
    (1, 200, 200, 4, 2, 64, True, 0),      # two q blocks, ragged key tile
    (2, 37, 37, 2, 1, 64, True, 0),        # shorter than one tile, MQA
    (1, 23, 41, 4, 2, 64, True, 9),        # Sq != Sk, q_offset
    (1, 150, 150, 2, 2, 128, True, 0),     # hd 128 tiles
    (1, 96, 130, 4, 2, 128, False, 0),     # not causal, ragged keys
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset", CASES)
@pytest.mark.parametrize("round_ops", [False, True])
def test_tile_emulation_vs_jax(B, Sq, Sk, H, KV, hd, causal, q_offset,
                               round_ops):
    q, k, v, do = _inputs(0, B, Sq, Sk, H, KV, hd, bf16_values=round_ops)
    want_o, want_g = _jax_reference(q, k, v, do, H, causal, q_offset)
    tq, tk, tv, tdo = (_bhsd(a) for a in (q, k, v, do))
    o, lse = emulate_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                         round_ops=round_ops)
    got = emulate_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                      q_offset=q_offset, round_ops=round_ops)
    if not round_ops:
        np.testing.assert_allclose(_bshd(o), want_o, atol=1e-5, rtol=1e-5)
        for g, w in zip(got, want_g):
            np.testing.assert_allclose(_bshd(g), w, atol=1e-5, rtol=1e-5)
        return
    np.testing.assert_allclose(_bshd(o), want_o, atol=2e-2, rtol=2e-2)
    for g, w in zip(got, want_g):
        rel = np.linalg.norm(_bshd(g) - w) / np.linalg.norm(w)
        assert rel <= BWD_REL_L2, rel


# kimi-k2's head dim 112 in the hd-128 tiles (columns 112..127 zero):
# B, Sq, Sk, H, KV, causal, q_offset
CASES_112 = [
    (1, 150, 150, 8, 1, True, 0),          # two q blocks, ragged key tile
    (2, 37, 37, 4, 2, True, 0),            # shorter than one tile
    (1, 23, 141, 4, 1, False, 0),          # not causal, ragged keys
    (1, 23, 41, 4, 2, True, 9),            # Sq != Sk, q_offset
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", CASES_112)
@pytest.mark.parametrize("round_ops", [False, True])
def test_tile_emulation_at_head_dim_112_vs_jax(B, Sq, Sk, H, KV, causal,
                                                q_offset, round_ops):
    """The forward's hd-128 tiles with head dim 112's zero-filled columns
    and the scale 112^-0.5 against JAX's flash attention at hd 112."""
    q, k, v, do = _inputs(1, B, Sq, Sk, H, KV, 112, bf16_values=round_ops)
    want_o, _ = _jax_reference(q, k, v, do, H, causal, q_offset)
    tq, tk, tv = (_bhsd(a) for a in (q, k, v))
    o, _ = emulate_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                       round_ops=round_ops, tile_hd=128)
    assert o.shape[-1] == 112
    tol = 1e-5 if not round_ops else 2e-2
    np.testing.assert_allclose(_bshd(o), want_o, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", CASES_112)
@pytest.mark.parametrize("round_ops", [False, True])
def test_bwd_tile_emulation_at_head_dim_112_vs_jax(B, Sq, Sk, H, KV, causal,
                                                    q_offset, round_ops):
    """K4b's hd-128 tiles (dk/dv query tiles of 32) with head dim 112's
    zero-filled columns and the scale 112^-0.5 against the gradients of
    JAX's custom-VJP flash attention at hd 112: f32 at 1e-5 with the
    rounding off, relative L2 <= 2e-2 per gradient with it on."""
    q, k, v, do = _inputs(2, B, Sq, Sk, H, KV, 112, bf16_values=round_ops)
    _, want_g = _jax_reference(q, k, v, do, H, causal, q_offset)
    tq, tk, tv, tdo = (_bhsd(a) for a in (q, k, v, do))
    o, lse = emulate_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                         round_ops=round_ops, tile_hd=128)
    got = emulate_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                      q_offset=q_offset, round_ops=round_ops, tile_hd=128)
    for g, w in zip(got, want_g):
        assert g.shape[-1] == 112
        if not round_ops:
            np.testing.assert_allclose(_bshd(g), w, atol=1e-5, rtol=1e-5)
        else:
            rel = np.linalg.norm(_bshd(g) - w) / np.linalg.norm(w)
            assert rel <= BWD_REL_L2, rel


# head dim 128 with a wide group, as granite-20b's 48 query heads on one
# KV head: the dk/dv kernel's key block walks every head of its group
# (12 or 8 here) and each head's query tiles of 32, summing them in one
# accumulator. B, Sq, Sk, H, KV, causal, q_offset
CASES_128_WIDE = [
    (1, 150, 150, 12, 1, True, 0),         # group 12, MQA, two key blocks
    (1, 96, 130, 12, 1, False, 0),         # group 12, not causal, ragged
    (1, 150, 150, 16, 2, True, 0),         # group 8 on two KV heads
    (2, 70, 70, 8, 1, False, 0),           # group 8, not causal, B 2
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", CASES_128_WIDE)
@pytest.mark.parametrize("round_ops", [False, True])
def test_tile_emulation_at_head_dim_128_wide_group_vs_jax(
        B, Sq, Sk, H, KV, causal, q_offset, round_ops):
    """K4's hd-128 tiles (key tiles of 64) with 8 or 12 query heads on a
    KV head against JAX's flash attention: f32 at 1e-5 with the rounding
    off, atol = rtol = 2e-2 with it on."""
    q, k, v, do = _inputs(3, B, Sq, Sk, H, KV, 128, bf16_values=round_ops)
    want_o, _ = _jax_reference(q, k, v, do, H, causal, q_offset)
    tq, tk, tv = (_bhsd(a) for a in (q, k, v))
    o, _ = emulate_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                       round_ops=round_ops)
    tol = 1e-5 if not round_ops else 2e-2
    np.testing.assert_allclose(_bshd(o), want_o, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", CASES_128_WIDE)
@pytest.mark.parametrize("round_ops", [False, True])
def test_bwd_tile_emulation_at_head_dim_128_wide_group_vs_jax(
        B, Sq, Sk, H, KV, causal, q_offset, round_ops):
    """K4b's hd-128 tiles (dq key tiles of 64; dk/dv key blocks of 128
    walking the group's heads in query tiles of 32) with 8 or 12 query
    heads on a KV head against the gradients of JAX's custom-VJP flash
    attention: f32 at 1e-5 with the rounding off, relative L2 <= 2e-2 per
    gradient with it on."""
    q, k, v, do = _inputs(4, B, Sq, Sk, H, KV, 128, bf16_values=round_ops)
    _, want_g = _jax_reference(q, k, v, do, H, causal, q_offset)
    tq, tk, tv, tdo = (_bhsd(a) for a in (q, k, v, do))
    o, lse = emulate_fwd(tq, tk, tv, causal=causal, q_offset=q_offset,
                         round_ops=round_ops)
    got = emulate_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                      q_offset=q_offset, round_ops=round_ops)
    for g, w in zip(got, want_g):
        if not round_ops:
            np.testing.assert_allclose(_bshd(g), w, atol=1e-5, rtol=1e-5)
        else:
            rel = np.linalg.norm(_bshd(g) - w) / np.linalg.norm(w)
            assert rel <= BWD_REL_L2, rel


@pytest.mark.parametrize("Sq,Sk,hd,q_offset", [(300, 300, 64, 0),
                                               (23, 41, 64, 9),
                                               (150, 150, 128, 0)])
def test_tile_emulation_skips_exactly_the_tiles_above_the_diagonal(
        Sq, Sk, hd, q_offset):
    """A warpgroup multiplies a key tile iff one of its rows sees a key
    of it: no tile above the diagonal is loaded, none needed is skipped."""
    q = torch.zeros(1, 1, Sq, hd)
    k = torch.zeros(1, 1, Sk, hd)
    visits = []
    emulate_fwd(q, k, k, causal=True, q_offset=q_offset, visits=visits)
    BK, _ = _tiles(hd)
    want = {(w0, k0) for w0 in range(0, Sq, WG) for k0 in range(0, Sk, BK)
            if k0 <= min(w0 + WG, Sq) - 1 + q_offset}
    assert sorted(visits) == sorted(want)
