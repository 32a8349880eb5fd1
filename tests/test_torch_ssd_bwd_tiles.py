"""A CPU rehearsal of the tile walk of the bf16 tensor-core SSD scan
backward (kernels/csrc/ssd_scan_bwd.cu, the ``ssd_bwd_*_tc`` kernels),
held against the JAX package.

The emulation below walks the tiles as the kernels do:

* ``ssd_bwd_states_tc``: each chunk's own state, sum_s B_s (x_s dt_s
  e^{last - cum_s}), and the own term of dS_out, sum_t C_t (dy_t
  e^{cum_t}), over position tiles of 64, the scaled x and dy rounded to
  bf16; ``ssd_bwd_carry_tc``: the forward and reverse carries in f32,
  dlast = <dS_out, S_out> and the carry's term of da_log from the f32
  states, S_in and dS_out kept in bf16 ([p][n]) for the products.
* ``ssd_bwd_dbx_tc`` (one s tile, the t tiles at or after it) and
  ``ssd_bwd_dc_tc`` (one t tile, the s tiles at or before it), each over
  a slice of HEAD_SLICE heads of one group: G = dy . x^T over P with dt
  applied after the product, CB = C . B^T over N, both f32; the masked
  decay L = e^{cum_t - cum_s} (masked to s <= t < valid before the exp on
  the diagonal and ragged tiles only); the f32 tile E = CB L G dt_s, whose
  row sums (dc kernel) and column sums (dbx kernel) give C_t . dC_t and
  xdt_s . dxdt_s of the chunk without the rounded products, and whose
  pair sum E (cum_t - cum_s) gives da_log's intra term; the weighted
  products dC += W B, dB += W^T C, dxdt += (CB L)^T dy with W = G dt_s L
  and CB L rounded to bf16; the state terms (e^{cum_t} dy_t . S_in,
  e^{last - cum_s} x_s dt_s . dS_out^T, B_s . dS_out) with the scaled dy
  and x rounded to bf16. dB and dC sum over the slice's heads in
  registers; each slice writes its partial, and the group sum adds the
  slices in order.
* ``ssd_bwd_finalize_tc``: dcum = (row sum + state term) - dt (column sum
  + state term) (+ dlast at the chunk's last position), dl its reverse
  cumulative sum, ddt = x . dxdt + dl A; da_log sums the terms of every
  (b, chunk) in order.

Tolerances. The walk is an exact identity of the gradient: with the
rounding off, in float64, it equals the port's plain backward run in
float64 (autodiff of the plain scan) at atol = rtol = 1e-9. JAX's scan
computes in float32 whatever its inputs (``repro/models/mamba.py:100``),
so the float64 check cannot be made against it; with the rounding off in
float32 the walk is held against ``jax.vjp`` of the JAX scan at
``SSD_TOL``'s 1e-3 (tests/test_kernels.py:56), and with the rounding on
(bf16-valued x, b, c, dy, as the kernels are given) at K5B_TOL's 2e-2 of
the card's tests, elementwise for every gradient. The largest errors of
ddt and da_log against the float64 plain backward are printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels import ref

T = 64                        # tile edge: positions, and P
HEAD_SLICE = 4                # heads of one group a dbx / dc block walks
F32_TOL = 1e-3                # SSD_TOL in float32
K5B_TOL = 2e-2                # tests/test_torch_cuda.py, bf16
F64_TOL = 1e-9
GRADS = ("dx", "ddt", "da_log", "db", "dc")


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _rnd(x, on, split=True):
    """A computed operand as the kernels give it to the tensor cores: a
    bf16 pair hi + lo (two products; with ``split`` off, hi alone)."""
    if not on:
        return x
    hi = _bf16(x)
    return hi + _bf16(x - hi) if split else hi


def _rows(x, r0, n, total):
    """Rows [r0, r0 + n) of x (.., S, D), zero at or past `total` (the
    kernels' zero-filled copies)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    m = max(0, min(n, total - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


def _decay(cum_r, cum_k, rows, cols, qv, masked, row_is_t):
    """(L, l) of a tile: l = cum_t - cum_s, L = e^l, both 0 where a masked
    tile's (t, s) is outside s <= t < qv (tested before the exp)."""
    l = cum_r[..., :, None] - cum_k[..., None, :]
    if not row_is_t:
        l = -l
    if not masked:
        return torch.exp(l), l
    t, s = (rows[:, None], cols[None, :]) if row_is_t else \
        (cols[None, :], rows[:, None])
    ok = (s <= t) & (t < qv)
    l = torch.where(ok, l, torch.zeros_like(l))
    return torch.where(ok, torch.exp(l), torch.zeros_like(l)), l


def emulate_bwd(x, dt, a_log, b, c, dy, dstate, chunk, round_ops=True,
                visits=None, head_slice=HEAD_SLICE, split=True):
    """x (B, S, H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N), dy
    (B, S, H, P), dstate (B, H, P, N) or None, all in one float dtype ->
    (dx, ddt, da_log, db, dc). ``visits`` collects (kernel, chunk, own
    tile, other tile, masked) of every tile pair the dbx ("col") and dc
    ("row") kernels multiply, once per head slice."""
    nb, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    hg = H // G
    Q = min(chunk, S)
    nc, nt = -(-S // Q), -(-Q // T)
    qp = nt * T
    f = x.dtype
    A = -torch.exp(a_log)
    xh, dyh = x.permute(0, 2, 1, 3), dy.permute(0, 2, 1, 3)   # (B, H, S, P)
    bg, cg = b.permute(0, 2, 1, 3), c.permute(0, 2, 1, 3)     # (B, G, S, N)
    dth = dt.permute(0, 2, 1)                                 # (B, H, S)
    grp = torch.arange(H) // hg
    ar = torch.arange(qp)

    # ssd_bwd_states_tc: per chunk, the block scan of dt * A, the own state
    # [p][n] and dS_out's own term U [p][n], position tiles of 64
    ch = []
    for ci in range(nc):
        base, qv = ci * Q, min(Q, S - ci * Q)
        dtc = torch.zeros(nb, H, qp, dtype=f)
        dtc[..., :qv] = dth[..., base:base + qv]
        cum = torch.cumsum(dtc * A[None, :, None], -1)
        last = cum[..., qv - 1]
        own = torch.zeros(nb, H, P, N, dtype=f)
        u = torch.zeros(nb, H, P, N, dtype=f)
        for s0 in range(0, qv, T):
            pos = ar[s0:s0 + T]
            ok = pos < qv
            fs = torch.where(ok, dtc[..., pos] * torch.exp(
                last[..., None] - cum[..., pos]), 0.0)
            ft = torch.where(ok, torch.exp(cum[..., pos]), 0.0)
            xs = _rnd(_rows(xh[:, :, base:], s0, T, qv) * fs[..., None],
                      round_ops, split)
            ds = _rnd(_rows(dyh[:, :, base:], s0, T, qv) * ft[..., None],
                      round_ops, split)
            own = own + xs.transpose(-1, -2) @ _rows(bg[:, grp, base:], s0,
                                                     T, qv)
            u = u + ds.transpose(-1, -2) @ _rows(cg[:, grp, base:], s0, T,
                                                 qv)
        ch.append(dict(base=base, qv=qv, cum=cum, dtc=dtc, last=last,
                       own=own, u=u))
    # ssd_bwd_carry_tc: f32 carries, [p][n]; dlast and the carry's term of
    # da_log from the f32 states; the bf16 copies the products read
    s_in = torch.zeros(nb, H, P, N, dtype=f)
    for k in ch:
        k["s_in"] = s_in
        s_in = s_in * torch.exp(k["last"])[..., None, None] + k["own"]
        k["s_out"] = s_in
    g = torch.zeros(nb, H, P, N, dtype=f) if dstate is None else dstate
    for ci in range(nc - 1, -1, -1):
        k = ch[ci]
        k["dsout"] = g
        k["dlast"] = (g * k["s_out"]).sum((-1, -2))
        k["kterm"] = k["last"] * torch.exp(k["last"]) * (
            g * k["s_in"]).sum((-1, -2))
        g = g * torch.exp(k["last"])[..., None, None] + k["u"]
    for k in ch:
        k["s_in_b"], k["dsout_b"] = (_rnd(k[n], round_ops, split)
                                     for n in ("s_in", "dsout"))

    nsl = -(-hg // head_slice)
    dx = torch.zeros(nb, H, S, P, dtype=f)
    xdx, dac, cdc, dar = (torch.zeros(nb, H, S, dtype=f) for _ in range(4))
    dbp = torch.zeros(nb, G, nsl, S, N, dtype=f)
    dcp = torch.zeros(nb, G, nsl, S, N, dtype=f)
    slices = [(gi, sl, range(gi * hg + sl * head_slice,
                             gi * hg + min(hg, (sl + 1) * head_slice)))
              for gi in range(G) for sl in range(nsl)]
    for ci, k in enumerate(ch):
        base, qv, cum, dtc = k["base"], k["qv"], k["cum"], k["dtc"]
        last = k["last"]
        # ssd_bwd_dbx_tc: one s tile, the t tiles at or after it
        for js in range(nt):
            s0 = js * T
            if s0 >= qv:
                continue
            rows = ar[s0:s0 + T]
            sval = rows < qv
            for gi, sl, heads in slices:
                b_s = _rows(bg[:, gi, base:], s0, T, qv)
                dB = torch.zeros(nb, T, N, dtype=f)
                for h in heads:
                    x_s = _rows(xh[:, h, base:], s0, T, qv)
                    cs, dts = cum[:, h, rows], dtc[:, h, rows]
                    ls = torch.where(sval, last[:, h, None] - cs, 0.0)
                    es = torch.where(sval, torch.exp(ls), 0.0)
                    dso = k["dsout_b"][:, h]                  # [p][n]
                    dxdt = (b_s @ dso.transpose(-1, -2)) * es[..., None]
                    xst = (x_s * dxdt).sum(-1)
                    dB = dB + _rnd(x_s * (dts * es)[..., None],
                                   round_ops, split) @ dso
                    colsum = torch.zeros(nb, T, dtype=f)
                    for it in range(js, nt):
                        t0 = it * T
                        if t0 >= qv:
                            continue
                        cols = ar[t0:t0 + T]
                        masked = it == js or t0 + T > qv or s0 + T > qv
                        if visits is not None and h == heads[0]:
                            visits.append(("col", ci, js, it, masked))
                        dy_t = _rows(dyh[:, h, base:], t0, T, qv)
                        c_t = _rows(cg[:, gi, base:], t0, T, qv)
                        gt = x_s @ dy_t.transpose(-1, -2)      # [s][t]
                        cbt = b_s @ c_t.transpose(-1, -2)
                        L, _ = _decay(cs, cum[:, h, cols], rows, cols, qv,
                                      masked, row_is_t=False)
                        cbl = cbt * L
                        colsum = colsum + (cbl * gt).sum(-1)
                        w = gt * dts[..., None] * L
                        dxdt = dxdt + _rnd(cbl, round_ops, split) @ dy_t
                        dB = dB + _rnd(w, round_ops, split) @ c_t
                    n = min(T, qv - s0)
                    sel = slice(base + s0, base + s0 + n)
                    xdx[:, h, sel] = (colsum + xst)[:, :n]
                    dac[:, h, sel] = (ls * dts * xst)[:, :n]
                    dx[:, h, sel] = (dxdt * dts[..., None])[:, :n]
                dbp[:, gi, sl, base + s0:base + s0 + min(T, qv - s0)] = \
                    dB[:, :min(T, qv - s0)]
        # ssd_bwd_dc_tc: one t tile, the s tiles at or before it
        for tt in range(nt):
            t0 = tt * T
            if t0 >= qv:
                continue
            rows = ar[t0:t0 + T]
            tval = rows < qv
            for gi, sl, heads in slices:
                c_t = _rows(cg[:, gi, base:], t0, T, qv)
                dC = torch.zeros(nb, T, N, dtype=f)
                for h in heads:
                    dy_t = _rows(dyh[:, h, base:], t0, T, qv)
                    ct = torch.where(tval, cum[:, h, rows], 0.0)
                    rs = torch.zeros(nb, T, dtype=f)
                    pair = torch.zeros(nb, T, dtype=f)
                    if ci > 0:                # the incoming state's terms
                        sin = k["s_in_b"][:, h]               # [p][n]
                        y = c_t @ sin.transpose(-1, -2)        # [t][p]
                        et = torch.exp(ct)
                        cst = et * (dy_t * y).sum(-1)
                        dC = dC + _rnd(dy_t * et[..., None],
                                       round_ops, split) @ sin
                        rs, pair = cst, ct * cst
                    for j in range(tt + 1):
                        s0 = j * T
                        cols = ar[s0:s0 + T]
                        masked = j == tt or t0 + T > qv
                        if visits is not None and h == heads[0]:
                            visits.append(("row", ci, tt, j, masked))
                        x_s = _rows(xh[:, h, base:], s0, T, qv)
                        b_s = _rows(bg[:, gi, base:], s0, T, qv)
                        gm = dy_t @ x_s.transpose(-1, -2)      # [t][s]
                        cbm = c_t @ b_s.transpose(-1, -2)
                        L, l = _decay(ct, cum[:, h, cols], rows, cols, qv,
                                      masked, row_is_t=True)
                        w = gm * dtc[:, h, None, cols] * L
                        e = cbm * w
                        rs = rs + e.sum(-1)
                        pair = pair + (e * l).sum(-1)
                        dC = dC + _rnd(w, round_ops, split) @ b_s
                    n = min(T, qv - t0)
                    sel = slice(base + t0, base + t0 + n)
                    cdc[:, h, sel] = rs[:, :n]
                    dar[:, h, sel] = pair[:, :n]
                dcp[:, gi, sl, base + t0:base + t0 + min(T, qv - t0)] = \
                    dC[:, :min(T, qv - t0)]
    # ssd_bwd_finalize_tc, the group sum over slices in order, da_log
    ddt = torch.zeros(nb, H, S, dtype=f)
    da_log = torch.zeros(H, dtype=f)
    parts = torch.zeros(nb, H, nc, dtype=f)
    for ci, k in enumerate(ch):
        base, qv = k["base"], k["qv"]
        sel = slice(base, base + qv)
        dcum = cdc[:, :, sel] - dth[:, :, sel] * xdx[:, :, sel]
        dcum[..., qv - 1] += k["dlast"]
        dl = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
        ddt[:, :, sel] = xdx[:, :, sel] + dl * A[None, :, None]
        parts[:, :, ci] = (dar[:, :, sel] + dac[:, :, sel]).sum(-1) + \
            k["kterm"]
    for bi in range(nb):
        for ci in range(nc):
            da_log = da_log + parts[bi, :, ci]
    db = dbp[:, :, 0]
    dc = dcp[:, :, 0]
    for sl in range(1, nsl):
        db, dc = db + dbp[:, :, sl], dc + dcp[:, :, sl]
    out = (dx.permute(0, 2, 1, 3), ddt.permute(0, 2, 1), da_log,
           db.permute(0, 2, 1, 3), dc.permute(0, 2, 1, 3))
    if round_ops:             # dx, db and dc are written in bf16
        out = tuple(_bf16(o) if n in ("dx", "db", "dc") else o
                    for n, o in zip(GRADS, out))
    return out


def _inputs(seed, B, S, H, P, G, N, bf16_values):
    """x, dt, a_log, b, c as tests/test_kernels.py:47-51 makes them (a_log
    around -0.5, as the card's K5b tests), dy and dstate N(0, 1), all
    with numpy; x, b, c and dy bf16 values when the kernels' rounding is
    emulated."""
    rng = np.random.RandomState(seed)
    arrs = [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, P)) * 0.5,
        np.log1p(np.exp(rng.standard_normal((B, S, H)))),     # softplus
        -0.5 + rng.standard_normal(H) * 0.1,
        rng.standard_normal((B, S, G, N)) * 0.3,
        rng.standard_normal((B, S, G, N)) * 0.3,
        rng.standard_normal((B, S, H, P)),
        rng.standard_normal((B, H, P, N)))]
    if bf16_values:
        for i in (0, 3, 4, 5):
            arrs[i] = torch.from_numpy(arrs[i]).to(
                torch.bfloat16).float().numpy()
    return arrs


def _jax_vjp(arrs, chunk, with_dstate):
    j = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(lambda *a: jax_ssd_scan_ref(*a, chunk), *j[:5])
    ds = j[6] if with_dstate else jnp.zeros_like(j[6])
    return [np.asarray(g) for g in vjp((j[5], ds))]


CASES = [
    # B, S, H, P, G, N, chunk
    (1, 300, 4, 64, 1, 128, 256),     # ragged tail at chunk 256
    (2, 512, 2, 64, 1, 64, 256),      # two whole chunks, N 64
    (1, 200, 8, 64, 2, 64, 64),       # G = 2, ragged, chunk 64
    (1, 130, 12, 64, 1, 64, 128),     # three head slices, the last short
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES)
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["dstate-zero", "dstate"])
def test_tile_walk_in_float64_equals_the_plain_backward(B, S, H, P, G, N,
                                                        chunk, with_dstate):
    """Rounding off, float64: the tile walk, its E-tile route to dcum and
    da_log included, is an exact identity of the gradient."""
    arrs = _inputs(0, B, S, H, P, G, N, bf16_values=False)
    x, dt, a_log, b, c, dy, dstate = (torch.from_numpy(a).double()
                                      for a in arrs)
    ds = dstate if with_dstate else None
    got = emulate_bwd(x, dt, a_log, b, c, dy, ds, chunk, round_ops=False)
    want = ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, ds, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F64_TOL,
                                   rtol=F64_TOL, err_msg=name)


def _limit_ratio(got, exact):
    """{gradient: the largest |got - exact| / (atol + rtol |exact|)} at
    K5B_TOL: at most 1 passes the card's elementwise check."""
    return {n: ((g.double() - w).abs() / (K5B_TOL + K5B_TOL * w.abs()))
            .max().item() for n, g, w in zip(GRADS, got, exact)}


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES[:2])
@pytest.mark.parametrize("round_ops", [False, True],
                         ids=["exact-ops", "bf16-ops"])
def test_tile_walk_vs_jax(B, S, H, P, G, N, chunk, round_ops):
    """Float32, as the kernels: rounding off within SSD_TOL of jax.vjp;
    rounding on (bf16-valued inputs) within K5B_TOL of it, and within
    K5B_TOL of the float64 plain backward (the card's check), every
    gradient elementwise. The largest errors against the float64 plain
    backward are printed."""
    arrs = _inputs(1, B, S, H, P, G, N, bf16_values=round_ops)
    x, dt, a_log, b, c, dy, dstate = (torch.from_numpy(a) for a in arrs)
    got = emulate_bwd(x, dt, a_log, b, c, dy, dstate, chunk,
                      round_ops=round_ops)
    want = _jax_vjp(arrs, chunk, True)
    tol = K5B_TOL if round_ops else F32_TOL
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol,
                                   err_msg=name)
    exact = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dt, a_log, b, c,
                                                         dy, dstate)),
                                 chunk=chunk)
    errs = {n: (g.double() - w).abs().max().item()
            for n, g, w in zip(GRADS, got, exact)}
    print(f"(B, S, H, P, G, N, chunk) = {(B, S, H, P, G, N, chunk)}, "
          f"round_ops {round_ops}: max abs err vs the float64 plain "
          f"backward: " + ", ".join(f"{n} {e:.3e}" for n, e in
                                    errs.items()))
    if round_ops:
        ratio = _limit_ratio(got, exact)
        assert max(ratio.values()) <= 1.0, ratio


def test_single_bf16_operands_would_leave_the_card_tolerance():
    """Why every computed operand (W, CB L, the scaled x and dy, S_in,
    dS_out) enters its product as a bf16 pair hi + lo: rounded once to
    bf16, the walk's gradients leave K5B_TOL elementwise against the
    float64 plain backward (the card's check); split, the largest error
    is the bf16 rounding of the outputs dx, db and dc themselves."""
    arrs = _inputs(1, 1, 300, 4, 64, 1, 128, bf16_values=True)
    x, dt, a_log, b, c, dy, dstate = (torch.from_numpy(a) for a in arrs)
    exact = ref.ssd_scan_bwd_ref(*(t.double() for t in (x, dt, a_log, b, c,
                                                         dy, dstate)),
                                 chunk=256)
    ratios = {}
    for split in (False, True):
        got = emulate_bwd(x, dt, a_log, b, c, dy, dstate, 256, split=split)
        ratios[split] = _limit_ratio(got, exact)
        print(f"operands {'hi + lo' if split else 'bf16'}: largest error "
              f"/ (atol + rtol |want|) at K5B_TOL: " + ", ".join(
                  f"{n} {r:.3f}" for n, r in ratios[split].items()))
    assert max(ratios[False].values()) > 1.0
    assert max(ratios[True].values()) <= 0.25


@pytest.mark.parametrize("S,chunk", [(300, 256), (33, 256), (700, 256),
                                     (200, 64), (130, 128)])
def test_tile_walk_visits_exactly_the_tiles_on_or_below_the_diagonal(
        S, chunk):
    """The dbx kernel multiplies the t tiles at or after its s tile and the
    dc kernel the s tiles at or before its t tile, both only where a valid
    position of the own tile meets one of the other (s <= t < valid); a
    tile is masked iff one of its (t, s) pairs falls outside that."""
    arrs = _inputs(2, 1, S, 1, 64, 1, 64, bf16_values=False)
    x, dt, a_log, b, c, dy, _ = (torch.from_numpy(a) for a in arrs)
    visits = []
    emulate_bwd(x, dt, a_log, b, c, dy, None, chunk, round_ops=False,
                visits=visits)
    Q = min(chunk, S)
    want = {}
    for ci in range(-(-S // Q)):
        qv = min(Q, S - ci * Q)
        for a0 in range(0, Q, T):
            for o0 in range(0, Q, T):
                # col: own tile s (a0), other t (o0); row: own t, other s
                for kind, (s0, t0) in (("col", (a0, o0)),
                                       ("row", (o0, a0))):
                    pairs = [(s, t) for s in range(s0, s0 + T)
                             for t in range(t0, t0 + T)]
                    if any(s <= t < qv for s, t in pairs):
                        bad = any(not (s <= t < qv) for s, t in pairs)
                        want[(kind, ci, a0 // T, o0 // T)] = bad
    assert {v[:4]: v[4] for v in visits} == want
    assert len(visits) == len(want)
