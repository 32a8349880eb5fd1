"""Plain PyTorch versions of the port's kernels.

The CPU path of each wrapper and the yardstick ``chip_smoke.py`` holds
each kernel against on the card. Nothing on the main path calls them
when a card is present.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                        q_chunk: int = 512, k_chunk: int = 1024,
                        return_lse: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H % KV == 0
    -> (B, Sq, H, hd).

    The function of kernels/csrc/flash_attention.cu, written as
    ``repro.models.attention.flash_attention_ref`` writes it: online
    softmax over k-chunks inside a loop over q-chunks, f32 scores and
    accumulator, masked scores -1e30, padded keys masked by the valid
    length, p rounded to the value type before P.V, and the normaliser
    1/max(l, 1e-30). Query i attends to keys j <= i + q_offset when
    ``causal``. GQA heads are repeated here (the kernel indexes them).

    With ``return_lse`` it also returns the row log-sum-exp
    ``m + log(max(l, 1e-30))`` (B, H, Sq) f32, as ``_flash_fwd_lse``
    (repro/models/attention.py:166-211)."""
    B, sq, H, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if kv != H:
        k = k.repeat_interleave(H // kv, dim=2)
        v = v.repeat_interleave(H // kv, dim=2)
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    pq, pk = (-sq) % q_chunk, (-sk) % k_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    scale = hd ** -0.5
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, sq + pq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].float()
        qpos = q0 + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        for k0 in range(0, sk + pk, k_chunk):
            kj = k[:, k0:k0 + k_chunk]
            vj = v[:, k0:k0 + k_chunk]
            kpos = k0 + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqhd,bchd->bhqc", qi, kj.float()) * scale
            mask = kpos[None, :] < sk                        # kv padding
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqc,bchd->bhqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        denom = torch.clamp(l, min=1e-30)
        outs.append((acc / denom[..., None]).to(q.dtype).transpose(1, 2))
        lses.append(m + torch.log(denom))                    # (B,H,cq)
    out = torch.cat(outs, dim=1)[:, :sq]
    if not return_lse:
        return out
    return out, torch.cat(lses, dim=2)[:, :, :sq].contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool,
                            q_offset: int = 0, q_chunk: int = 512):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` from its output
    ``o`` and row log-sum-exp ``lse`` (B, H, Sq): the function of
    kernels/csrc/flash_attention_bwd.cu, written as JAX's custom VJP
    ``_flash_vjp_bwd`` (repro/models/attention.py:232-291) writes it:
    ``delta = rowsum(dO * O)`` in f32, P recomputed as
    ``exp(s * scale - lse)`` and 0 where masked, ``dS = P (dP - delta)
    scale``, every product in f32. Loops over q-chunks (JAX also loops
    over k-chunks); GQA by index: each KV head's dk/dv sum over its group
    of query heads. Returns the gradients in the input types."""
    B, sq, H, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = H // kv
    scale = hd ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=dev)
    delta = (do.float() * o.float()).sum(-1)                 # (B,Sq,H)
    dq = torch.empty((B, sq, H, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, sk, kv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, sk, kv, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        q1 = min(sq, q0 + q_chunk)
        n = q1 - q0
        qi = q[:, q0:q1].float().reshape(B, n, kv, g, hd)
        doi = do[:, q0:q1].float().reshape(B, n, kv, g, hd)
        lsei = lse[:, :, q0:q1].reshape(B, kv, g, n)
        di = delta[:, q0:q1].permute(0, 2, 1).reshape(B, kv, g, n)
        s = torch.einsum("bqkgd,bskd->bkgqs", qi, kf) * scale
        p = torch.exp(s - lsei[..., None])
        if causal:
            qpos = torch.arange(q0, q1, device=dev) + q_offset
            mask = qpos[:, None] >= kpos[None, :]
            p = torch.where(mask, p, 0.0)
        dv += torch.einsum("bkgqs,bqkgd->bskd", p, doi)
        dp = torch.einsum("bqkgd,bskd->bkgqs", doi, vf)
        ds = p * (dp - di[..., None]) * scale
        dq[:, q0:q1] = torch.einsum("bkgqs,bskd->bqkgd", ds,
                                    kf).reshape(B, n, H, hd)
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The Mamba-2 SSD chunked scan (K5) and its backward (K5b)
# ---------------------------------------------------------------------------


def ssd_scan_ref(x, dt, a_log, b, c, *, chunk: int):
    """x (B, S, H, P); dt (B, S, H) after softplus; a_log (H,); b/c
    (B, S, G, N) with H % G == 0 -> (y (B, S, H, P) in x's dtype, final
    state (B, H, P, N) f32).

    The function of kernels/csrc/ssd_scan.cu, written as
    ``repro.models.mamba.ssd_scan_ref`` writes it: ``chunk = min(chunk,
    S)``; a ragged tail padded with dt = 0 (identity steps); ``A =
    -exp(a_log)``; xdt = x * dt in f32; per chunk the inclusive cumulative
    log decay ``cum``, the masked quadratic form ``(C B^T) *
    exp(cum_t - cum_s)`` for s <= t (exp of -inf above the diagonal),
    the incoming state decayed to each position, and the carry
    ``state * exp(cum_Q) + sum_s exp(cum_Q - cum_s) xdt_s B_s^T``. B/C
    groups are repeated to heads here (the kernel indexes them).

    Float64 inputs are computed, and the state returned, in float64: the
    exact value the kernels' f32 sums are held against on the card."""
    nb, seq, h, p = x.shape
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    chunk = min(chunk, seq)
    pad = (-seq) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    A = -torch.exp(a_log.to(ct))                             # (H,)
    dt = dt.to(ct)
    xdt = x.to(ct) * dt[..., None]                           # (B,S',H,P)
    bf, cf = b.to(ct), c.to(ct)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((nb, h, p, n), dtype=ct, device=x.device)
    ys = []
    for s0 in range(0, seq + pad, chunk):
        xq = xdt[:, s0:s0 + chunk]                           # (B,Q,H,P)
        bq, cq = bf[:, s0:s0 + chunk], cf[:, s0:s0 + chunk]  # (B,Q,G,N)
        cum = torch.cumsum(dt[:, s0:s0 + chunk] * A, dim=1)  # (B,Q,H)
        dec = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H)
        dec = torch.exp(torch.where(tri[None, :, :, None], dec,
                                    float("-inf")))
        scores = torch.einsum("bqgn,bsgn->bqsg", cq, bq)
        scores = scores.repeat_interleave(hg, dim=3)         # (B,Q,Q,H)
        y_intra = torch.einsum("bqsh,bshp->bqhp", scores * dec, xq)
        ch = cq.repeat_interleave(hg, dim=2)                 # (B,Q,H,N)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", ch, state)
        y_inter = y_inter * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)               # (B,Q,H)
        bh = bq.repeat_interleave(hg, dim=2)
        s_chunk = torch.einsum("bqhp,bqh,bqhn->bhpn", xq, tail, bh)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :seq]
    return y.to(x.dtype), state


def ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, dstate=None, *, chunk: int):
    """Gradients (dx, ddt, da_log, db, dc) of ``ssd_scan_ref`` from the
    output gradient ``dy`` (x's shape) and ``dstate``, the final state's
    (B, H, P, N) f32, zeros when None: the function of
    kernels/csrc/ssd_scan_bwd.cu, taken as JAX takes it, by autodiff of
    the plain scan (``jax.vjp`` of ``repro.models.mamba.ssd_scan_ref``).
    Each gradient comes back in its input's dtype; float64 inputs are
    differentiated in float64."""
    leaves = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
    with torch.enable_grad():
        y, state = ssd_scan_ref(*leaves, chunk=chunk)
        if dstate is None:
            dstate = torch.zeros_like(state)
        return torch.autograd.grad((y, state), leaves,
                                   (dy.to(y.dtype), dstate.to(state.dtype)))


# ---------------------------------------------------------------------------
# The int8 wire (K2, K3) and the PS update (K1)
# ---------------------------------------------------------------------------

QBLOCK = 256          # values per int8 scale (repro/kernels/quantize.py:20)


def quantize_blocks(y, block: int = QBLOCK):
    """y (N,) f32 with N % block == 0 -> (q int8 (N,), scale f32
    (N/block,)): per-block absmax scale ``amax / 127``, ``q =
    clip(round_half_even(y / max(scale, 1e-30)), -127, 127)``, as
    ``repro.core.compression.quantize_int8``."""
    yb = y.float().reshape(-1, block)
    amax = yb.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(yb / torch.clamp(scale[:, None], min=1e-30))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_ref(q, scales, block: int = QBLOCK, out=None):
    """x = q * scale per block, in f32 (K3's function). Written into
    ``out`` (N,) f32 when given."""
    qb = q.reshape(-1, block).float()
    if out is None:
        return (qb * scales[:, None]).reshape(-1)
    torch.mul(qb, scales[:, None], out=out.view(-1, block))
    return out


def quantize_ref(x, err):
    """K2's function (``repro/kernels/ref.py:quantize_ref``): ``y = x +
    err`` in f32 (x f32 or bf16), then (q, scales, new_err = y - q *
    scale)."""
    y = x.float() + err.float()
    q, scale = quantize_blocks(y)
    return q, scale, (y - dequantize_ref(q, scale)).to(err.dtype)


def ps_aggregate_ref(rows, params, m, v, step, *, solver: str = "adam",
                     lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, momentum: float = 0.9,
                     beta: float = 0.9):
    """K1's function, in place: mean of ``rows`` (NL, F) over learners in
    f32, then one solver step on params/m/v (F,) f32, which are updated
    where they lie (``repro/kernels/ref.py:64-122``). Adam's bias
    corrections take ``b ** step`` in f32, as the Pallas kernel and the
    jnp oracle do. Returns (params, m, v)."""
    g = rows.float().mean(dim=0)
    if solver == "sgd":
        params.sub_(lr * g)
    elif solver == "momentum":
        m.mul_(momentum).add_(g)
        params.sub_(lr * m)
    elif solver == "adam":
        t = torch.tensor(float(step), dtype=torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
        vh = v / (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
        params.sub_(lr * mh / (torch.sqrt(vh) + eps))
    elif solver == "easgd_center":
        params.add_(beta * g)
    elif solver == "average":
        params.copy_(g)
    else:
        raise ValueError(solver)
    return params, m, v
