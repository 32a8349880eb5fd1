"""The backward of the SSD chunked scan (K5b's CPU path) against the JAX
package: the plain ``ssd_scan_bwd_ref`` / ``ops.ssd_scan_bwd`` against
``jax.vjp`` of ``repro.models.mamba.ssd_scan_ref``, ``SSDScan`` through
autograd, the chooser in ``models.mamba.ssd_scan``, the op's checks, and
a CPU rehearsal of the CUDA kernel's passes (``csrc/ssd_scan_bwd.cu``:
the chunk states, the reverse carry, dxdt, the per-head dC/dB with G
masked before the exp, the log-decay identity and the group and
da_log sums) against the plain version.

Tolerances: ``SSD_TOL`` of tests/test_kernels.py:56 (1e-3 in float32,
5e-2 in bfloat16, atol = rtol) for the gradients against JAX; 1e-5
(atol = rtol) for ``SSDScan`` against the plain backward, which run the
same float32 arithmetic; ``SSD_TOL`` in float32 for the rehearsal, which
sums in float64 in the kernel's order against the plain version's
float32 (da_log, a sum over every position, differs by up to ~6e-4
relative); 1e-9 for the rehearsal against the plain version run in
float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan_bwd as kssdb
from repro_torch.models import mamba as tm

SSD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
SCAN_SHAPES = [                       # tests/test_torch_mamba.py
    (1, 128, 2, 16, 1, 16, 32),
    (2, 256, 4, 32, 2, 16, 64),
    (1, 128, 4, 64, 1, 32, 128),
    (1, 100, 2, 16, 1, 16, 32),       # ragged tail
    (2, 7, 2, 16, 1, 16, 32),         # shorter than a chunk
]
GRADS = ("dx", "ddt", "da_log", "db", "dc")


def _inputs(B, S, H, P, G, N, seed=0):
    """x, dt, a_log, b, c as tests/test_kernels.py:47-51 makes them, then
    dy and dstate, all with numpy."""
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, P)) * 0.5,
        np.log1p(np.exp(rng.standard_normal((B, S, H)))),     # softplus
        rng.standard_normal(H) * 0.5,
        rng.standard_normal((B, S, G, N)) * 0.3,
        rng.standard_normal((B, S, G, N)) * 0.3,
        rng.standard_normal((B, S, H, P)),
        rng.standard_normal((B, H, P, N)))]


def _torch(arrays, dtype):
    """x, b, c and dy in ``dtype``; dt, a_log and dstate in f32."""
    cast = (True, False, False, True, True, True, False)
    return [torch.from_numpy(a).to(getattr(torch, dtype) if c
                                   else torch.float32)
            for a, c in zip(arrays, cast)]


def _jax_vjp(arrays, dtype, chunk, dstate):
    cast = (True, False, False, True, True, True)
    j = [jnp.asarray(a).astype(getattr(jnp, dtype) if c else jnp.float32)
         for a, c in zip(arrays, cast)]
    _, vjp = jax.vjp(lambda *a: jm.ssd_scan_ref(*a, chunk), *j[:5])
    return vjp((j[5], jnp.asarray(dstate)))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["dstate-zero", "dstate"])
def test_plain_backward_matches_jax_vjp(B, S, H, P, G, N, chunk, dtype,
                                        with_dstate):
    arrays = _inputs(B, S, H, P, G, N)
    x, dt, a_log, b, c, dy, dstate = _torch(arrays, dtype)
    ds = arrays[6] if with_dstate else np.zeros_like(arrays[6])
    before = kssdb.launches
    got = ops.ssd_scan_bwd(x, dt, a_log, b, c, dy,
                           dstate if with_dstate else None, chunk=chunk)
    assert kssdb.launches == before
    want = _jax_vjp(arrays[:6], dtype, chunk, ds)
    tol = SSD_TOL[dtype]
    for name, g, w, inp in zip(GRADS, got, want, (x, dt, a_log, b, c)):
        assert g.dtype == inp.dtype and g.shape == inp.shape, name
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)
    # the plain version by name takes dstate zeros as None
    if not with_dstate:
        again = ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy,
                                     torch.zeros_like(dstate), chunk=chunk)
        for g, a in zip(got, again):
            assert torch.equal(g, a)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES[1:4])
def test_ssdscan_apply_equals_the_plain_backward(B, S, H, P, G, N, chunk):
    """``SSDScan`` on the CPU: its forward is the plain scan, and
    autograd through it (a loss of y alone: dstate None; a loss of y and
    the state) gives the plain backward's gradients."""
    x, dt, a_log, b, c, dy, dstate = _torch(_inputs(B, S, H, P, G, N, 1),
                                            "float32")
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, b, c)]
    y, state = tm.SSDScan.apply(*leaves, chunk)
    y0, state0 = ops.ssd_scan(x, dt, a_log, b, c, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(state, state0)
    for use_state in (False, True):
        loss = (y * dy).sum() + ((state * dstate).sum() if use_state else 0)
        got = torch.autograd.grad(loss, leaves, retain_graph=True)
        want = ops.ssd_scan_bwd(x, dt, a_log, b, c, dy,
                                dstate if use_state else None, chunk=chunk)
        for name, g, w in zip(GRADS, got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5,
                                       msg=name)


def test_chooser_takes_autograd_only_when_needed():
    x, dt, a_log, b, c, _, _ = _torch(_inputs(1, 40, 2, 16, 1, 16, 2),
                                      "float32")
    y, state = tm.ssd_scan(x, dt, a_log, b, c, chunk=32)
    assert y.grad_fn is None and state.grad_fn is None
    xg = x.clone().requires_grad_()
    y, state = tm.ssd_scan(xg, dt, a_log, b, c, chunk=32)
    assert "SSDScan" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert tm.ssd_scan(xg, dt, a_log, b, c, chunk=32)[0].grad_fn is None


def test_backward_rejects_bad_shapes():
    x, dt, a_log, b, c, dy, dstate = _torch(_inputs(1, 8, 2, 4, 1, 4),
                                            "float32")
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(x, dt, a_log, b, c, dy[:, :4], chunk=4)
    with pytest.raises(ValueError, match="dstate"):
        ops.ssd_scan_bwd(x, dt, a_log, b, c, dy, dstate[:, :1], chunk=4)
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_scan_bwd(x[:, :, :1], dt[:, :, :1], a_log[:1],
                         torch.cat([b, b], 2), torch.cat([c, c], 2),
                         dy[:, :, :1], chunk=4)
    with pytest.raises(ValueError):        # kernel path, CPU tensors
        kssdb.ssd_scan_bwd_cuda(x, dt, a_log, b, c, dy, chunk=4)


# ---------------------------------------------------------------------------
# A CPU rehearsal of the kernel's passes (csrc/ssd_scan_bwd.cu)
# ---------------------------------------------------------------------------


def _kernel_passes(x, dt, a_log, b, c, dy, dstate, chunk):
    """The gradients as the CUDA kernel computes them, pass by pass, in
    float64: cum per chunk; the chunk states S_in (own state, forward
    carry) and dS_out (dy.C^T per chunk, reverse carry from dstate);
    dlast = <dS_out, S_out>; dxdt; per head dC and dB with G = dy.xdt^T
    masked before the exp; dcum = C.dC - xdt.dxdt (+ dlast at the last
    valid position), its reverse cumulative sum dl, ddt = x.dxdt + dl A;
    db/dc summed over each group's heads; da_log term by term, each
    exponent times its term's derivative (pair through xdt, inter through
    e^cum_t, the carry's kterm), which equals A sum dl dt."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    hg = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    x, dt, b, c, dy = (t.double() for t in (x, dt, b, c, dy))
    A = -torch.exp(a_log.double())
    grp = torch.arange(H) // hg
    bh, ch = b[:, :, grp], c[:, :, grp]                  # (B, S, H, N)
    bounds = [(k * Q, min(S, k * Q + Q)) for k in range(nc)]
    cum = torch.zeros(B, S, H, dtype=torch.float64)
    for s0, s1 in bounds:
        cum[:, s0:s1] = torch.cumsum(dt[:, s0:s1] * A, dim=1)
    last = [cum[:, s1 - 1] for _, s1 in bounds]          # (B, H)
    s_in = torch.zeros(B, H, nc + 1, N, P, dtype=torch.float64)
    for k, (s0, s1) in enumerate(bounds):
        f = dt[:, s0:s1] * torch.exp(last[k][:, None] - cum[:, s0:s1])
        own = torch.einsum("bshn,bshp->bhnp", bh[:, s0:s1],
                           x[:, s0:s1] * f[..., None])
        s_in[:, :, k + 1] = s_in[:, :, k] * torch.exp(
            last[k])[..., None, None] + own
    dsout = torch.zeros(B, H, nc, N, P, dtype=torch.float64)
    g = (torch.zeros(B, H, N, P, dtype=torch.float64) if dstate is None
         else dstate.double().transpose(2, 3))
    dsout[:, :, nc - 1] = g
    for k in range(nc - 2, -1, -1):
        s0, s1 = bounds[k + 1]
        u = torch.einsum("bshn,bshp->bhnp", ch[:, s0:s1], dy[:, s0:s1]
                         * torch.exp(cum[:, s0:s1])[..., None])
        g = g * torch.exp(last[k + 1])[..., None, None] + u
        dsout[:, :, k] = g
    dlast = (dsout * s_in[:, :, 1:]).sum(dim=(3, 4))     # (B, H, nc)
    lasts = torch.stack(last, dim=2)                     # (B, H, nc)
    dA = (lasts * torch.exp(lasts) * (dsout * s_in[:, :, :-1]).sum(
        dim=(3, 4))).sum(dim=(0, 2))                     # kterm
    dxdt = torch.zeros(B, S, H, P, dtype=torch.float64)
    dch = torch.zeros(B, S, H, N, dtype=torch.float64)
    dbh = torch.zeros(B, S, H, N, dtype=torch.float64)
    for k, (s0, s1) in enumerate(bounds):
        q = s1 - s0
        cm = cum[:, s0:s1]
        keep = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, :, :,
                                                             None]
        diff = cm[:, :, None, :] - cm[:, None, :, :]     # [b][t][s][h]
        E = torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)
        CB = torch.einsum("btgn,bsgn->btsg", c[:, s0:s1],
                          b[:, s0:s1])[..., grp]
        ll = last[k][:, None] - cm                       # (B, q, H)
        el = torch.exp(ll)
        own = el[..., None] * torch.einsum("bshn,bhnp->bshp", bh[:, s0:s1],
                                           dsout[:, :, k])
        dxdt[:, s0:s1] = torch.einsum("btsh,bthp->bshp", CB * E,
                                      dy[:, s0:s1]) + own
        accw = torch.einsum("btsh,bthp->bshp", CB * E * torch.where(
            keep, diff, 0.0), dy[:, s0:s1]) + ll[..., None] * own
        dA += (accw * x[:, s0:s1]).sum(-1).mul(dt[:, s0:s1]).sum(
            dim=(0, 1))                                  # pair
        GE = torch.einsum("bthp,bshp->btsh", dy[:, s0:s1], x[:, s0:s1]) \
            * dt[:, s0:s1][:, None] * E                  # dy_t . xdt_s
        inter = torch.exp(cm)[..., None] * torch.einsum(
            "bthp,bhnp->bthn", dy[:, s0:s1], s_in[:, :, k])
        dch[:, s0:s1] = torch.einsum("btsh,bshn->bthn", GE,
                                     bh[:, s0:s1]) + inter
        dA += ((inter * ch[:, s0:s1]).sum(-1) * cm).sum(dim=(0, 1))
        dbh[:, s0:s1] = torch.einsum("btsh,bthn->bshn", GE, ch[:, s0:s1]) \
            + (el * dt[:, s0:s1])[..., None] * torch.einsum(
                "bshp,bhnp->bshn", x[:, s0:s1], dsout[:, :, k])
    xdx = (dxdt * x).sum(-1)
    dcum = (dch * ch).sum(-1) - dt * xdx
    ddt = torch.zeros(B, S, H, dtype=torch.float64)
    for k, (s0, s1) in enumerate(bounds):
        dcum[:, s1 - 1] += dlast[:, :, k]
        dl = torch.flip(torch.cumsum(torch.flip(dcum[:, s0:s1], [1]), 1),
                        [1])
        ddt[:, s0:s1] = xdx[:, s0:s1] + dl * A
    return (dxdt * dt[..., None], ddt, dA,
            dbh.reshape(B, S, G, hg, N).sum(3),
            dch.reshape(B, S, G, hg, N).sum(3))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES + [
    (1, 300, 4, 8, 2, 8, 64),         # G = 2, five chunks, ragged
    (2, 96, 4, 8, 1, 8, 32),          # three whole chunks
])
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["dstate-zero", "dstate"])
def test_kernel_passes_match_the_plain_backward(B, S, H, P, G, N, chunk,
                                                with_dstate):
    x, dt, a_log, b, c, dy, dstate = _torch(_inputs(B, S, H, P, G, N, 2),
                                            "float32")
    ds = dstate if with_dstate else None
    got = _kernel_passes(x, dt, a_log, b, c, dy, ds, chunk)
    want = ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, ds, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=SSD_TOL["float32"],
                                   rtol=SSD_TOL["float32"], err_msg=name)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_SHAPES + [
    (1, 300, 4, 8, 2, 8, 64),         # G = 2, five chunks, ragged
])
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["dstate-zero", "dstate"])
def test_plain_backward_in_float64_equals_the_kernel_passes(
        B, S, H, P, G, N, chunk, with_dstate):
    """On float64 inputs the plain backward runs in float64 (the card's
    tests hold K5b against it there): it equals the float64 rehearsal of
    the kernel's passes, da_log's term-by-term sum included."""
    x, dt, a_log, b, c, dy, dstate = (
        torch.from_numpy(a).double() for a in _inputs(B, S, H, P, G, N, 3))
    ds = dstate if with_dstate else None
    got = ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, ds, chunk=chunk)
    want = _kernel_passes(x, dt, a_log, b, c, dy, ds, chunk)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-9,
                                   rtol=1e-9, err_msg=name)
