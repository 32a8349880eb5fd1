"""Mixture-of-Experts with sort-based dispatch: the counterpart of
``repro.models.moe``, on one card (``_moe_single``, moe.py:30-131) and
expert-parallel on a ``torch.distributed`` mesh (moe.py:138-228).

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

Expert parallelism (EP). With an ``ExpertParallel`` context (built by
``distributed.steps`` for a ``Dist`` whose ``expert_axis`` is "model")
the experts, E * r of them with ``r = replication_factor``, are split in
contiguous blocks over the mesh's "model" dim, each rank holding its
E * r / model experts whole along D and Fe. The reference's
``_gather_fsdp`` (moe.py:138) is ``steps._gather_tree``'s gather of the
expert leaves over their FSDP axes only, at the step's start like every
other leaf. The two bodies follow the reference's ``shard_map``s:

  * train / prefill (``s % model == 0 and s > 1``, s the whole
    sequence): each rank routes its slice of the sequence (local token
    index t, copy ``(t k + j) % r`` of an expert), fills the (E r, cap, D)
    buffer with ``cap = _capacity(local tokens, k, E r, cf)``, sends each
    rank its experts' rows with one all-to-all, runs its experts on the
    rows of every source, and returns them with a second all-to-all;
  * decode (every other shape, S = 1 among them): every rank routes all
    of its rows, runs only its own experts (a pair routed elsewhere goes
    to the sentinel expert ``E r / model`` and is dropped here), and the
    f32 combine is summed over "model" with an all-reduce.

Where the reference's rows arrive replicated over "model" (``fsdp_tp``,
or ``zero3_sp`` where the step is not sequence-parallel), the train body
first takes the rank's slice of the sequence (``SplitSeq``: its backward
all-gathers the slices' gradients) and all-gathers the output after it
(``GatherSplit``: its backward hands each rank its own slice of the
gradient, which every rank holds alike; a reduce-scatter would count it
``model`` times). The router's gradient and, in the decode body, x's
are partial sums over "model" (each rank sees its slice or its experts):
``CopyIn`` all-reduces them in the backward, so every leaf but the
experts has the same gradient on every "model" rank, as the steps
expect. An expert's gradient lives on its owner only: the all-to-all's
backward has brought every rank's tokens to it. Under sequence
parallelism (``ExpertParallel.sliced``) the rows are the rank's slice
already and the step's gradient sums over "model" cover the router.
The collectives are the functional ones (``all_to_all_single_autograd``,
all-gather, all-reduce), so ``analysis.roofline.ProgramCounter`` counts
them. The EP bodies take no ``capacity``: like the reference's, they
size it from their local tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch.mesh import wait
from repro_torch.models.layers import ParamDef


def replication_factor(moe: MoEConfig, dist=None) -> int:
    """Copies of each expert (``moe.py:32-40``): with a ``Dist`` whose
    "model" axis (the expert axis) outnumbers the experts, that axis over
    the expert count, else 1. Raises ``ValueError`` where neither divides
    the other, as the reference asserts."""
    ms = dist.model_size if dist is not None else 1
    if ms <= 1 or dist.expert_axis is None:
        return 1
    if moe.n_experts >= ms:
        if moe.n_experts % ms:
            raise ValueError(f"{moe.n_experts} experts do not split over a "
                             f"\"model\" axis of {ms}")
        return 1
    if ms % moe.n_experts:
        raise ValueError(f"a \"model\" axis of {ms} does not hold whole "
                         f"copies of {moe.n_experts} experts")
    return ms // moe.n_experts


def is_expert_leaf(path: str) -> bool:
    """Whether the param at ``path`` ("blocks/moe/wg", ...) is an expert
    weight (wg, wu, wd of a moe block), whose leading non-layer dim is the
    experts'."""
    parts = path.split("/")
    return "moe" in parts[:-1] and parts[-1] in ("wg", "wu", "wd")


@dataclass(frozen=True)
class ExpertParallel:
    """This rank's place in the expert-parallel group, the mesh's "model"
    dim: ``group`` (the functional collectives' (mesh, dim index)),
    ``rank`` its index and ``size`` the group's ranks, ``r`` the copies
    of each expert (``replication_factor``), ``fsdp`` the FSDP axes left
    to the expert weights (the reference's ``fsdp`` in ``moe_block``:
    ``steps._gather_tree`` gathers an expert leaf over these alone), and
    ``sliced``:
    the rows handed in are already the rank's slice of the sequence (a
    sequence-parallel ``zero3_sp`` step), so the train body runs on them
    as they are."""
    group: object
    rank: int
    size: int
    r: int
    fsdp: Tuple[str, ...] = ()
    sliced: bool = False


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


def _route(x2d, router_w, moe: MoEConfig, r: int = 1):
    """x2d (T, D) -> (expert (T*k,), gate (T*k,) f32, token (T*k,)), in
    flat pair order t*k + j. With ``r`` copies of each expert, pair
    (t, j) goes to copy ``(t k + j) % r`` of its expert, expert index
    ``e r + copy`` (``moe.py:72-76``)."""
    t = x2d.shape[0]
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    # stable descending sort: the lower expert index first among ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :moe.top_k], idx[:, :moe.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    if r > 1:
        pair = (torch.arange(t, device=x2d.device)[:, None] * moe.top_k
                + torch.arange(moe.top_k, device=x2d.device)[None, :])
        idx = idx * r + pair % r
    token = torch.arange(t, device=x2d.device)[:, None].expand(idx.shape)
    return idx.reshape(-1), gate.reshape(-1), token.reshape(-1)


def _fill_buffers(x2d, expert_v, gate, token, ev: int, cap: int):
    """Sort-based capacity dispatch. Returns (buf (ev*cap, D), tok_of_slot
    (ev*cap,) with ``T*k`` for an empty slot, gate_of_slot (ev*cap,) f32,
    slot_of_pair (T*k,) with ``ev*cap`` for a dropped pair). A pair whose
    expert is ``ev`` (the EP decode body's sentinel expert: another
    rank's) sorts last and is dropped."""
    tk = expert_v.shape[0]
    dev = x2d.device
    order = torch.argsort(expert_v, stable=True)
    se = expert_v[order]
    # rank of each routed pair within its expert
    starts = torch.searchsorted(se, torch.arange(ev + 1, device=dev,
                                                 dtype=se.dtype))
    rank = torch.arange(tk, device=dev) - starts[se]
    sentinel = ev * cap
    slot = torch.where((rank < cap) & (se < ev), se * cap + rank,
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


def moe_block(x, params, cfg: ArchConfig, capacity: Optional[int] = None,
              ep: Optional[ExpertParallel] = None):
    """x (B, S, D) -> (B, S, D). Without ``ep``: the reference's
    ``_moe_single`` on one card; the capacity defaults to
    ``_capacity(B*S, ...)``, and a decode step passes
    ``decode_capacity(B)``. With ``ep``: the expert-parallel bodies (the
    module docstring), ``params`` holding the rank's experts; x is the
    rank's rows, its slice of the sequence where ``ep.sliced``."""
    if ep is not None:
        return _moe_ep(x, params, cfg, ep)
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


# ---------------------------------------------------------------------------
# Expert parallelism on a mesh (moe.py:138-228)
# ---------------------------------------------------------------------------


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _all_gather(x, dim, group):
    funcol = _funcol()
    ag = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return wait(ag(x.contiguous(), dim, group))


def _all_to_all(x, group):
    """x (n * m, ...) -> (n * m, ...): block i of n equal blocks on dim 0
    goes to rank i of the group, and block j of the result came from rank
    j; its backward is the same exchange of the gradient."""
    return wait(_funcol().all_to_all_single_autograd(x.contiguous(), None,
                                                     None, group))


class CopyIn(torch.autograd.Function):
    """The identity forward; the backward all-reduces (sums) the gradient
    over the group: for an input every rank holds alike whose uses on
    each rank make a partial gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return wait(_funcol().all_reduce(g.contiguous(), "sum",
                                         ctx.group)), None


class ReduceOut(torch.autograd.Function):
    """The all-reduce (sum) of partial outputs over the group; the
    backward hands the gradient, which every rank holds alike, to each
    rank's part as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return wait(_funcol().all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class SplitSeq(torch.autograd.Function):
    """x (B, S, ...) every rank holds alike -> the rank's slice (B, S / n,
    ...); the backward all-gathers the slices' gradients, so every rank
    has the whole gradient."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        n = x.shape[1] // ep.size
        return x.narrow(1, ep.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.ep.group), None


class GatherSplit(torch.autograd.Function):
    """Every rank's slice (B, S / n, ...) -> the whole (B, S, ...) on every
    rank; the backward gives each rank its own slice of the gradient,
    which every rank holds alike."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        return _all_gather(x, 1, ep.group)

    @staticmethod
    def backward(ctx, g):
        ep = ctx.ep
        n = g.shape[1] // ep.size
        return g.narrow(1, ep.rank * n, n), None


def _ep_dispatch(x, rw, wg, wu, wd, moe: MoEConfig, ep: ExpertParallel):
    """The train / prefill body (``moe.py:166-198``): x (b, s, D) this
    rank's tokens, wg/wu/wd its experts -> (b, s, D)."""
    b, s, d = x.shape
    ev = moe.n_experts * ep.r
    e_local = ev // ep.size
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    cap = _capacity(t, moe.top_k, ev, moe.capacity_factor)
    ei, gi, ti = _route(x2d, rw, moe, ep.r)
    buf, _, _, slot_of_pair = _fill_buffers(x2d, ei, gi, ti, ev, cap)
    # (ms, e_local, cap, D): block i goes to rank i; back, block j came
    # from rank j; group the rows by local expert
    recv = _all_to_all(buf, ep.group)
    recv = recv.view(ep.size, e_local, cap, d).transpose(0, 1) \
        .reshape(e_local, ep.size * cap, d)
    y = _expert_mlp(recv, wg, wu, wd)
    y = y.view(e_local, ep.size, cap, d).transpose(0, 1).reshape(ev * cap, d)
    y = _all_to_all(y, ep.group)
    out = _combine(y, slot_of_pair, gi, t, moe.top_k)
    return out.view(b, s, d).to(x.dtype)


def _ep_local(x, rw, wg, wu, wd, moe: MoEConfig, ep: ExpertParallel):
    """The decode body (``moe.py:200-228``) before its sum over "model":
    x (b, s, D) every rank's alike -> (b s, D) f32, the contributions of
    this rank's experts."""
    d = x.shape[-1]
    ev = moe.n_experts * ep.r
    e_local = ev // ep.size
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    cap = _capacity(t, moe.top_k, ev, moe.capacity_factor)
    ei, gi, ti = _route(x2d, rw, moe, ep.r)
    mine = torch.div(ei, e_local, rounding_mode="floor") == ep.rank
    # another rank's expert -> the sentinel expert e_local, dropped here
    ei_l = torch.where(mine, ei % e_local, torch.full_like(ei, e_local))
    gi_l = torch.where(mine, gi, torch.zeros_like(gi))
    buf, _, _, slot_of_pair = _fill_buffers(x2d, ei_l, gi_l, ti, e_local,
                                            cap)
    y = _expert_mlp(buf.view(e_local, cap, d), wg, wu, wd) \
        .reshape(e_local * cap, d)
    return _combine(y, slot_of_pair, gi_l, t, moe.top_k)


def _moe_ep(x, params, cfg: ArchConfig, ep: ExpertParallel):
    """The reference's sharded ``moe_block`` on this rank: the train body
    where the whole sequence divides over "model" and is longer than one
    token, else the decode body (the module docstring)."""
    moe = cfg.moe
    b, s, d = x.shape
    rw, w = params["router"], (params["wg"], params["wu"], params["wd"])
    whole = s * ep.size if ep.sliced else s
    if whole % ep.size == 0 and whole > 1:
        if ep.sliced:
            return _ep_dispatch(x, rw, *w, moe, ep)
        out = _ep_dispatch(SplitSeq.apply(x, ep), CopyIn.apply(rw, ep.group),
                           *w, moe, ep)
        return GatherSplit.apply(out, ep)
    if ep.sliced:
        raise ValueError("a sequence-parallel slice always takes the "
                         "train body")
    out = _ep_local(CopyIn.apply(x, ep.group), CopyIn.apply(rw, ep.group),
                    *w, moe, ep)
    return ReduceOut.apply(out, ep.group).view(b, s, d).to(x.dtype)


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
