"""A CPU rehearsal of the tile walk of the bf16 tensor-core SSD scan
(kernels/csrc/ssd_scan.cu ``ssd_chunk_cb_tc``, ``ssd_chunk_state_tc``,
``ssd_state_carry`` and ``ssd_chunk_scan_tc``), held against the JAX
package.

The emulation below walks the tiles as the kernels do: per chunk, the
block scan of dt * A; C.B^T per group in 64 x 64 tiles on or below the
diagonal (rows padded to whole tiles, rows past the chunk zero-filled);
each chunk's state over position tiles of 64 from the scaled x; the
carry across chunks in f32, each chunk's incoming state kept for the
scan; y per 64-row t tile: the inter term C_t . S_in^T scaled by
exp(cum_t), then every s tile at or below t's, s tiles above it skipped
and only the diagonal and ragged tiles masked, with the kernels' own
predicates (s <= t < valid), before the exp. The operands the kernels
round to bf16 (W, the scaled x and S_in) are rounded here when
``round_ops`` is on; every sum is in f32.

The reference is ``repro.models.mamba.ssd_scan_ref`` from the same numpy
inputs. Tolerances: with the rounding off, in f32, atol = rtol = 1e-4
and relative L2 <= 1e-5: only the order of f32 sums differs, but inside
a chunk of 256 the cumulative log decay reaches a few hundred, where one
f32 ulp is ~3e-5, and exp(cum_t - cum_s) carries that as a relative
error (at (1, 300, chunk 256) JAX's f32 y is 2.8e-5 and this walk's
4.7e-5 from the same function in float64), so 1e-5 elementwise is below
f32's own error there. With the rounding on (and x, b, c given as bf16
values, as the kernel is), atol = rtol = 5e-2, the JAX kernel test's
bf16 limit (tests/test_kernels.py:56).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_scan_ref as jax_ssd_scan_ref

T = 64                        # tile edge: t rows, s positions, n rows
BF16_TOL = 5e-2
F32_TOL = 1e-4                # elementwise atol = rtol, rounding off
F32_REL_L2 = 1e-5             # relative L2, rounding off


def _bf16(x, on):
    return x.to(torch.bfloat16).float() if on else x


def _rows(x, r0, n, total):
    """Rows [r0, r0 + n) of x (.., S, D), zero at or past `total` (the
    kernels' zero-filled copies)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    m = max(0, min(n, total - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


def emulate(x, dt, a_log, b, c, chunk, round_ops=True, visits=None):
    """x (B, S, H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N), f32 ->
    (y (B, S, H, P), state (B, H, P, N)). ``visits`` collects (chunk, t
    tile, s tile, masked) of every W.x product the scan kernel issues."""
    nb, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    hg = H // G
    Q = min(chunk, S)
    nc, nt = -(-S // Q), -(-min(chunk, S) // T)
    qp = nt * T
    A = -torch.exp(a_log)
    xh = x.permute(0, 2, 1, 3)                 # (B, H, S, P)
    bg = b.permute(0, 2, 1, 3)                 # (B, G, S, N)
    cg = c.permute(0, 2, 1, 3)
    dth = dt.permute(0, 2, 1)                  # (B, H, S)
    chunks = []
    for ci in range(nc):
        base = ci * Q
        qv = min(Q, S - base)
        dtc = torch.zeros(nb, H, qp)
        dtc[..., :qv] = dth[..., base:base + qv]
        cum = torch.cumsum(dtc * A[None, :, None], -1)   # block scan
        bc, cc, xc = bg[:, :, base:], cg[:, :, base:], xh[:, :, base:]
        # ssd_chunk_cb_tc: CB[t][s] per group, tiles ts <= tt
        cb = torch.zeros(nb, G, qp, qp)
        for tt in range(nt):
            if tt * T >= qv:
                continue
            ct = _rows(cc, tt * T, T, qv)
            for ts in range(tt + 1):
                cb[..., tt * T:(tt + 1) * T, ts * T:(ts + 1) * T] = \
                    ct @ _rows(bc, ts * T, T, qv).transpose(-1, -2)
        # ssd_chunk_state_tc: contrib[n][p] over position tiles of 64
        last = cum[..., qv - 1]
        contrib = torch.zeros(nb, H, N, P)
        for s0 in range(0, qv, T):
            pos = torch.arange(s0, s0 + T)
            f = torch.where(pos < qv, dtc[..., pos] *
                            torch.exp(last[..., None] - cum[..., pos]), 0.0)
            xs = _bf16(_rows(xc, s0, T, qv) * f[..., None], round_ops)
            bt = _rows(bc, s0, T, qv).repeat_interleave(hg, dim=1)
            contrib = contrib + bt.transpose(-1, -2) @ xs
        chunks.append(dict(base=base, qv=qv, cum=cum, dtc=dtc, cb=cb,
                           contrib=contrib, last=last))
    # ssd_state_carry: f32 carry; the scan's S_in rounded to bf16
    carry = torch.zeros(nb, H, N, P)
    for ch in chunks:
        ch["s_in"] = _bf16(carry, round_ops)
        carry = carry * torch.exp(ch["last"])[..., None, None] + \
            ch["contrib"]
    state = carry.transpose(-1, -2)            # (B, H, P, N)
    # ssd_chunk_scan_tc: y per 64-row t tile
    y = torch.zeros(nb, H, S, P)
    for ci, ch in enumerate(chunks):
        base, qv, cum = ch["base"], ch["qv"], ch["cum"]
        cb = ch["cb"].repeat_interleave(hg, dim=1)
        xc = xh[:, :, base:]
        for tt in range(nt):
            t0 = tt * T
            if t0 >= qv:
                continue
            s_end = min(t0 + T, qv)
            rows = torch.arange(t0, t0 + T)
            ct = torch.where(rows < s_end, cum[..., rows], 0.0)
            acc = torch.zeros(nb, H, T, P)
            if ci > 0:                         # the incoming state's term
                c_t = _rows(cg[:, :, base:], t0, T, qv)
                acc = c_t.repeat_interleave(hg, dim=1) @ ch["s_in"]
                acc = acc * torch.exp(ct)[..., None]
            for j in range(tt + 1):
                s0 = j * T
                cols = torch.arange(s0, s0 + T)
                masked = j == tt or t0 + T > qv
                if visits is not None:
                    visits.append((ci, tt, j, masked))
                diff = ct[..., :, None] - cum[..., None, cols]
                if masked:                     # before the exp
                    ok = (cols[None, :] <= rows[:, None]) & \
                        (rows[:, None] < qv)
                    diff = torch.where(ok, diff, float("-inf"))
                w = cb[..., t0:t0 + T, s0:s0 + T] * torch.exp(diff) * \
                    ch["dtc"][..., None, cols]
                acc = acc + _bf16(w, round_ops) @ _rows(xc, s0, T, qv)
            n = min(T, qv - t0)
            y[:, :, base + t0:base + t0 + n] = acc[:, :, :n]
    return y.permute(0, 2, 1, 3), state


def _inputs(seed, B, S, H, P, G, N, bf16_values):
    """tests/test_kernels.py:47-51's distributions, made with numpy."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    b = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    if bf16_values:           # what the kernel is given: bf16 x, b, c
        x, b, c = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (x, b, c))
    return x, dt, a_log, b, c


CASES = [
    # B, S, H, P, G, N, chunk
    (1, 300, 2, 64, 1, 128, 256),     # ragged tail at chunk 256
    (1, 33, 2, 64, 1, 64, 256),       # shorter than a chunk
    (2, 2, 2, 64, 1, 64, 256),        # two positions
    (1, 7, 2, 64, 2, 128, 256),       # seven positions, G = 2
    (2, 200, 4, 64, 2, 64, 64),       # G = 2, four chunks, ragged
    (1, 384, 2, 64, 2, 128, 128),     # three chunks of two t tiles
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES)
@pytest.mark.parametrize("round_ops", [False, True])
def test_tile_emulation_vs_jax(B, S, H, P, G, N, chunk, round_ops):
    arrs = _inputs(0, B, S, H, P, G, N, bf16_values=round_ops)
    want_y, want_state = (np.asarray(a) for a in jax_ssd_scan_ref(
        *(jnp.asarray(a) for a in arrs), chunk))
    y, state = emulate(*(torch.from_numpy(a) for a in arrs), chunk,
                       round_ops=round_ops)
    tol = BF16_TOL if round_ops else F32_TOL
    for got, want in ((y.numpy(), want_y), (state.numpy(), want_state)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        if round_ops:         # the bf16 operands do round: not exact
            assert F32_REL_L2 < rel < BF16_TOL, rel
        else:
            assert rel <= F32_REL_L2, rel


@pytest.mark.parametrize("S,chunk", [(300, 256), (33, 256), (700, 256),
                                     (200, 64)])
def test_tile_walk_skips_exactly_the_tiles_above_the_diagonal(S, chunk):
    """The scan multiplies an s tile iff a valid row of the t tile sees a
    position of it, and masks a tile iff one of its (t, s) pairs is
    outside s <= t < valid: no tile above the diagonal is issued, none
    needed is skipped, and an unmasked tile needs no mask."""
    x, dt, a_log, b, c = (torch.from_numpy(a) for a in
                          _inputs(1, 1, S, 1, 64, 1, 64, False))
    visits = []
    emulate(x, dt, a_log, b, c, chunk, visits=visits)
    Q = min(chunk, S)
    want = {}
    for ci in range(-(-S // Q)):
        qv = min(Q, S - ci * Q)
        for t0 in range(0, qv, T):
            for s0 in range(0, Q, T):
                rows = range(t0, min(t0 + T, qv))
                if any(s0 <= t for t in rows):
                    bad = any(not (s <= t < qv) for t in range(t0, t0 + T)
                              for s in range(s0, s0 + T))
                    want[(ci, t0 // T, s0 // T)] = bad
    assert {v[:3]: v[3] for v in visits} == want
    assert len(visits) == len(want)
