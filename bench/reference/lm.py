"""The plain reference of the decoder the port trains and serves, in
float32, written from the model's semantics: token embedding; per layer a
pre-norm RMSNorm, rotate-half RoPE, causal softmax attention with grouped
KV heads and an output projection, a residual add, a second RMSNorm and
a SwiGLU MLP (dense) or top-k experts (moe), a residual add; a final
RMSNorm and an untied head.

The moe layer routes in f32 (softmax over the experts, the top k by a
stable descending sort, the gates renormalised) and keeps, for each
expert, the first ``capacity`` routed (token, slot) pairs in the order
token * k + slot; a dropped pair adds nothing. A prefill's capacity is
``ceil(T k cf / E)`` rounded up to a multiple of 8 (at least 8) over the
T tokens of the whole prefill batch; a decoded token is never dropped.

Every product goes through ``mm``: f32 with TF32 off, or, for the
control, both operands rounded to fp8 e4m3 first (one absmax scale per
row of the left operand and per column of the right; the gradient
passes straight through the rounding).

Imports torch and numpy only: nothing of the program or of JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

FP8_MAX = 448.0
Q_CHUNK = 512            # query rows of attention scored at a time


def strict_f32() -> None:
    """No TF32 in any f32 product of the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        a, b = _fp8(a, -1), _fp8(b, -2)
    return a @ b


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (S, H, hd), positions (S,): rotate-half RoPE, f32 angles."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, prec):
    """q (S, H, hd), k/v (S, KV, hd), causal -> (S, H, hd)."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    kh = k.repeat_interleave(g, dim=1).transpose(0, 1)       # (H, S, hd)
    vh = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = []
    for s0 in range(0, S, Q_CHUNK):
        s1 = min(S, s0 + Q_CHUNK)
        sc = mm(qh[:, s0:s1], kh[:, :s1].transpose(1, 2), prec) \
            * hd ** -0.5
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(cols > rows, float("-inf"))
        out.append(mm(torch.softmax(sc, dim=-1), vh[:, :s1], prec))
    return torch.cat(out, 1).transpose(0, 1)


def capacity(n_tokens: int, top_k: int, experts: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * top_k * cf / experts))
    return max(8, -(-c // 8) * 8)


def route(x2d, router, top_k):
    """(expert (T, k), gate (T, k)) in f32."""
    probs = torch.softmax(x2d @ router, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    return idx, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)


def route_margin(x2d, router, top_k):
    """(T,) the router's margin: the k-th expert's probability less the
    next one's. Near 0 a rounding can swap the two experts."""
    probs = torch.sort(torch.softmax(x2d @ router, dim=-1), dim=-1,
                       descending=True).values
    return probs[:, top_k - 1] - probs[:, top_k]


def moe_ffn(x2d, get: Callable, layer: int, spec, cap: Optional[int],
            prec: str):
    """x2d (T, D) f32 -> (T, D): each kept pair adds its gate times its
    expert's SwiGLU of the token. ``cap`` None keeps every pair."""
    T, k = x2d.shape[0], spec.top_k
    idx, gate = route(x2d, get("blocks/moe/router", (layer,)), k)
    flat_e = idx.reshape(-1)
    out = torch.zeros_like(x2d)
    for e in range(spec.experts):
        pairs = torch.nonzero(flat_e == e).reshape(-1)       # ascending
        if cap is not None:
            pairs = pairs[:cap]
        if pairs.numel() == 0:
            continue
        tok = pairs // k
        xe = x2d[tok]
        wg = get("blocks/moe/wg", (layer, e))
        wu = get("blocks/moe/wu", (layer, e))
        h = torch.nn.functional.silu(mm(xe, wg, prec)) * mm(xe, wu, prec)
        del wg, wu
        y = mm(h, get("blocks/moe/wd", (layer, e)), prec)
        out.index_add_(0, tok, y * gate.reshape(-1)[pairs][:, None])
    return out


def dense_ffn(x, get, layer, prec):
    h = torch.nn.functional.silu(mm(x, get("blocks/mlp/wg", (layer,)), prec)) \
        * mm(x, get("blocks/mlp/wu", (layer,)), prec)
    return mm(h, get("blocks/mlp/wd", (layer,)), prec)


def attn_block(h, get, layer, spec, prec):
    """h (S, D) -> h + attention of its normed rows."""
    S, D = h.shape
    x = rms_norm(h, get("blocks/ln1/w", (layer,)), spec.eps)
    pos = torch.arange(S, device=h.device)
    q = mm(x, get("blocks/attn/wq", (layer,)).reshape(D, -1), prec) \
        .view(S, spec.heads, spec.hd)
    kk = mm(x, get("blocks/attn/wk", (layer,)).reshape(D, -1), prec) \
        .view(S, spec.kv, spec.hd)
    vv = mm(x, get("blocks/attn/wv", (layer,)).reshape(D, -1), prec) \
        .view(S, spec.kv, spec.hd)
    o = attention(rope(q, pos, spec.theta), rope(kk, pos, spec.theta), vv,
                  prec)
    return h + mm(o.reshape(S, -1),
                  get("blocks/attn/wo", (layer,)).reshape(-1, D), prec)


# ---------------------------------------------------------------------------
# serving: the logits of a prefill batch's prompts and served tokens
# ---------------------------------------------------------------------------


def serve_logits(spec, get: Callable, prompts: Sequence[np.ndarray],
                 served: Dict[int, np.ndarray], prec: str = "f32",
                 device="cpu", margins: Optional[dict] = None
                 ) -> Dict[int, torch.Tensor]:
    """One prefill batch: ``prompts`` of equal length P, prefilled
    together; ``served[b]`` the tokens member b was served. Returns, for
    each b in ``served``, the f32 logits (n_b, V) that predict its served
    tokens (positions P-1 .. P+n_b-2 of prompt + served[:-1]). The
    prompt rows of all members share one capacity; served rows are
    never dropped. ``margins``, where given, gets for each b in
    ``served`` the smallest router margin over the layers at each of
    those positions (``route_margin``)."""
    P = len(prompts[0])
    seqs = [np.concatenate([p, served[b][:-1]]) if b in served else p
            for b, p in enumerate(prompts)]
    emb = get("embed", ())
    hs = [emb[torch.as_tensor(s.astype(np.int64), device=device)]
          for s in seqs]
    del emb
    for l in range(spec.layers):
        hs = [attn_block(h, get, l, spec, prec) for h in hs]
        xs = [rms_norm(h, get("blocks/ln2/w", (l,)), spec.eps) for h in hs]
        if spec.family == "moe":
            if margins is not None:
                router = get("blocks/moe/router", (l,))
                for b in served:
                    m = route_margin(xs[b][P - 1:], router, spec.top_k)
                    margins[b] = m if l == 0 else torch.minimum(
                        margins[b], m)
            head = torch.cat([x[:P] for x in xs])
            cap = capacity(head.shape[0], spec.top_k, spec.experts,
                           spec.capacity_factor)
            y_head = moe_ffn(head, get, l, spec, cap, prec)
            tails = [x[P:] for x in xs]
            y_tail = (moe_ffn(torch.cat(tails), get, l, spec, None, prec)
                      if sum(t.shape[0] for t in tails) else None)
            t0 = 0
            for b, h in enumerate(hs):
                n = h.shape[0] - P
                h[:P] += y_head[b * P:(b + 1) * P]
                if n:
                    h[P:] += y_tail[t0:t0 + n]
                    t0 += n
        else:
            hs = [h + dense_ffn(x, get, l, prec) for h, x in zip(hs, xs)]
        del xs
    wf, head_w = get("final_norm/w", ()), get("head", ())
    out = {b: mm(rms_norm(hs[b][P - 1:], wf, spec.eps), head_w, prec)
           for b in served}
    return out


# ---------------------------------------------------------------------------
# training: loss and flat gradient of one sequence
# ---------------------------------------------------------------------------


def loss_and_grad(spec, theta: torch.Tensor, tokens: np.ndarray,
                  labels: np.ndarray, prec: str = "f32"):
    """Mean next-token cross-entropy of one batch (B, S) under the flat
    f32 weights ``theta`` (the layout of ``bench.weights``) and its flat
    f32 gradient. Each layer is recomputed in the backward, to hold the
    reference's memory to one layer's activations."""
    from torch.utils.checkpoint import checkpoint
    from bench.weights import flat_offsets

    flat = theta.detach().clone().requires_grad_()
    offs = flat_offsets(spec)

    def leaf(path):
        off, shape = offs[path]
        return flat[off: off + math.prod(shape)].view(shape)

    def get(path, idx):
        t = leaf(path)
        return t[idx] if idx else t

    def layer(h, l):
        h = attn_block(h, get, l, spec, prec)
        x = rms_norm(h, get("blocks/ln2/w", (l,)), spec.eps)
        return h + dense_ffn(x, get, l, prec)

    dev = theta.device
    toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    labs = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    total = 0.0
    for b in range(toks.shape[0]):
        h = leaf("embed")[toks[b]]
        for l in range(spec.layers):
            h = checkpoint(layer, h, l, use_reentrant=False)
        h = rms_norm(h, leaf("final_norm/w"), spec.eps)
        logits = mm(h, leaf("head"), prec)
        total = total + torch.nn.functional.cross_entropy(
            logits, labs[b], reduction="sum")
    loss = total / labs.numel()
    loss.backward()
    return float(loss.detach()), flat.grad.detach()
