"""Mixture-of-Experts with sort-based dispatch on one card: the
counterpart of the single-shard path of ``repro.models.moe``
(moe.py:30-131). The expert-parallel paths (moe.py:139-228) need a mesh,
which the port does not have yet.

Dispatch as the reference's: an f32 router, softmax, top-k with gates
renormalised; the routed (token, expert) pairs sorted stably by expert,
each pair's rank within its expert, pairs at ``rank >= capacity``
dropped; the kept tokens gathered into an ``(E, capacity, D)`` buffer;
three batched products (SwiGLU); a gate-weighted combine in f32.

Where the mechanism differs, by design:
  * top-k is a stable descending ``torch.sort`` and its first k columns:
    ``jax.lax.top_k`` puts the lower index first among equal values,
    ``torch.topk`` promises no order;
  * ``mode="drop"`` scatters write the dropped pairs into one extra
    sentinel row, which is sliced off: no data-dependent shape and no
    host sync, so the path runs on the meta device (``count_program``)
    and a decode step never waits on the card;
  * the combine gathers instead of scattering: each (token, j) pair finds
    its slot through the inverse of the sort permutation (the zero
    sentinel row for a dropped pair) and the k contributions are summed
    in order j = 0..k-1. CUDA's ``index_add_`` sums with atomics in no
    fixed order, so a scatter would make same-seed engines disagree. For
    k = 2 the sum equals the reference's bit for bit; for k > 2 it
    differs in rounding only;
  * ``moe_block`` takes an explicit ``capacity``: a batched decode step
    passes ``decode_capacity(B)`` (see there).
``moe_ref`` is a plain per-expert loop written from the semantics, the
yardstick of the tests and of ``chip_smoke.py``; the model never calls
it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import ParamDef


def replication_factor(moe: MoEConfig, dist=None) -> int:
    """Copies of each expert (``moe.py:32-40``): with a ``Dist`` whose
    "model" axis outnumbers the experts, that axis over the expert count,
    else 1. The port's dispatch (``moe_block``) runs one card, so it runs
    with 1; a larger factor only shapes the param defs whose specs
    ``distributed/sharding.py`` computes."""
    ms = dist.model_size if dist is not None else 1
    if ms <= 1 or dist.expert_axis is None or moe.n_experts >= ms:
        return 1
    return ms // moe.n_experts


def moe_param_defs(cfg: ArchConfig, scan_dims=(), dist=None) -> dict:
    """router (D, E), wg/wu (E, D, Fe), wd (E, Fe, D) on the leading
    ``scan_dims``, E times ``replication_factor(moe, dist)`` for the
    experts. In flat order: router, wd, wg, wu."""
    moe = cfg.moe
    ev = moe.n_experts * replication_factor(moe, dist)
    lead = tuple(scan_dims)
    ldim = tuple("layers" for _ in lead)
    d, fe = cfg.d_model, moe.d_ff_expert
    return {
        "router": ParamDef(lead + (d, moe.n_experts),
                           ldim + ("embed", "expert_out")),
        "wg": ParamDef(lead + (ev, d, fe), ldim + ("expert", "embed", "eff")),
        "wu": ParamDef(lead + (ev, d, fe), ldim + ("expert", "embed", "eff")),
        "wd": ParamDef(lead + (ev, fe, d), ldim + ("expert", "eff", "embed")),
    }


def _capacity(n_tokens: int, top_k: int, ev: int, cf: float) -> int:
    """Slots per expert: ceil(T k cf / E), at least 8, rounded up to a
    multiple of 8."""
    c = int(math.ceil(n_tokens * top_k * cf / ev))
    return max(8, -(-c // 8) * 8)


def decode_capacity(n_slots: int) -> int:
    """Slots per expert for one decode step of ``n_slots`` slots.

    The reference's engine decodes each slot as its own call of one
    token (``jax.vmap(decode_one)``): capacity 8 and k distinct experts,
    so no pair is ever dropped. A batched step keeps that: an expert
    gets at most one pair per slot, so a capacity of at least
    ``n_slots`` drops nothing and no slot's token is dropped for
    another's. ``_capacity(n_slots, ...)``, which the reference's batched
    ``model.decode`` uses, drops once an expert draws more than its
    share among many slots; the two agree whenever that drops nothing.
    """
    return max(8, -(-n_slots // 8) * 8)


def _route(x2d, router_w, moe: MoEConfig):
    """x2d (T, D) -> (expert (T*k,), gate (T*k,) f32, token (T*k,)), in
    flat pair order t*k + j."""
    t = x2d.shape[0]
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    # stable descending sort: the lower expert index first among ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :moe.top_k], idx[:, :moe.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    token = torch.arange(t, device=x2d.device)[:, None].expand(idx.shape)
    return idx.reshape(-1), gate.reshape(-1), token.reshape(-1)


def _fill_buffers(x2d, expert_v, gate, token, ev: int, cap: int):
    """Sort-based capacity dispatch. Returns (buf (ev*cap, D), tok_of_slot
    (ev*cap,) with ``T*k`` for an empty slot, gate_of_slot (ev*cap,) f32,
    slot_of_pair (T*k,) with ``ev*cap`` for a dropped pair)."""
    tk = expert_v.shape[0]
    dev = x2d.device
    order = torch.argsort(expert_v, stable=True)
    se = expert_v[order]
    # rank of each routed pair within its expert
    starts = torch.searchsorted(se, torch.arange(ev, device=dev,
                                                 dtype=se.dtype))
    rank = torch.arange(tk, device=dev) - starts[se]
    sentinel = ev * cap
    slot = torch.where(rank < cap, se * cap + rank,
                       torch.full_like(se, sentinel))
    d = x2d.shape[-1]
    # dropped pairs all land in the sentinel row, sliced off below
    buf = torch.zeros((sentinel + 1, d), dtype=x2d.dtype, device=dev) \
        .index_copy(0, slot, x2d[token[order]])
    tok_of_slot = torch.full((sentinel + 1,), tk, dtype=torch.int64,
                             device=dev).index_copy(0, slot, token[order])
    gate_of_slot = torch.zeros((sentinel + 1,), dtype=torch.float32,
                               device=dev).index_copy(0, slot, gate[order])
    slot_of_pair = torch.empty_like(slot).index_copy(0, order, slot)
    return (buf[:sentinel], tok_of_slot[:sentinel], gate_of_slot[:sentinel],
            slot_of_pair)


def _expert_mlp(buf_e, wg, wu, wd):
    """buf_e (E, C, D); wg/wu (E, D, Fe); wd (E, Fe, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(buf_e, wg)) * torch.bmm(buf_e, wu)
    return torch.bmm(h, wd)


def _combine(y_slots, slot_of_pair, gate, n_tokens: int, top_k: int):
    """(T, D) f32: sum over j of gate[t, j] * y[slot of (t, j)], in order
    j = 0..k-1; a dropped pair reads the zero sentinel row."""
    d = y_slots.shape[-1]
    y = torch.cat([y_slots.float(), y_slots.new_zeros((1, d),
                                                      dtype=torch.float32)])
    contrib = (y[slot_of_pair] * gate[:, None]).view(n_tokens, top_k, d)
    out = contrib[:, 0]
    for j in range(1, top_k):
        out = out + contrib[:, j]
    return out


def moe_block(x, params, cfg: ArchConfig, capacity: Optional[int] = None):
    """x (B, S, D) -> (B, S, D): the reference's ``_moe_single``. The
    capacity defaults to ``_capacity(B*S, ...)``; a decode step passes
    ``decode_capacity(B)``."""
    moe = cfg.moe
    b, s, d = x.shape
    ev = moe.n_experts * replication_factor(moe)
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    cap = capacity or _capacity(t, moe.top_k, ev, moe.capacity_factor)
    ei, gi, ti = _route(x2d, params["router"], moe)
    buf, _, _, slot_of_pair = _fill_buffers(x2d, ei, gi, ti, ev, cap)
    y = _expert_mlp(buf.view(ev, cap, d), params["wg"], params["wu"],
                    params["wd"]).reshape(ev * cap, d)
    out = _combine(y, slot_of_pair, gi, t, moe.top_k)
    return out.reshape(b, s, d).to(x.dtype)


def moe_ref(x, params, cfg: ArchConfig, capacity: Optional[int] = None):
    """The plain version of ``moe_block``, from the semantics: for each
    expert, the first ``capacity`` of its (token, j) pairs in flat order
    t*k + j are kept; each kept token goes through that expert's SwiGLU
    (in x's dtype, as the block's products) and is summed gate-weighted
    in f32. Returns (out (B, S, D), dropped pairs). Loops and host syncs
    freely: only tests and ``chip_smoke.py`` call it."""
    moe = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t, k = x2d.shape[0], moe.top_k
    cap = capacity or _capacity(t, k, moe.n_experts, moe.capacity_factor)
    probs = torch.softmax(x2d.float() @ params["router"].float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    dropped = 0
    flat_idx = idx.reshape(-1)
    for e in range(moe.n_experts):
        pairs = torch.nonzero(flat_idx == e).flatten()     # flat order
        dropped += max(0, pairs.numel() - cap)
        pairs = pairs[:cap]
        if pairs.numel() == 0:
            continue
        tok, j = pairs // k, pairs % k
        xe = x2d[tok]
        h = F.silu(xe @ params["wg"][e]) * (xe @ params["wu"][e])
        y = (h @ params["wd"][e]).float()
        out.index_add_(0, tok, y * gate[tok, j][:, None])
    return out.view(b, s, d).to(x.dtype), dropped
