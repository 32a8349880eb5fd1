"""Attention: the flash kernels for prefill and training, decode
attention against a compact per-slot cache, and ``repeat_kv``.

Layouts are those of ``repro.models.attention``: q/k/v (B, S, H|KV, hd),
caches (B, S, KV, hd). Prefill goes through ``kernels.ops.flash_attention``
(the CUDA kernel on the card, GQA by index), where the JAX model calls
its jnp ``flash_attention_ref`` on pre-repeated heads. Training goes
through ``FlashAttention``, whose forward is the same kernel with its
row log-sum-exp and whose backward is the flash backward kernel (K4b),
the counterpart of JAX's custom VJP ``_flash_vjp`` (attention.py:214-296).
Decode stays plain PyTorch, as the JAX decode is plain jnp.

``sp_flash_attention`` is the ``zero3_sp`` policy's sequence-parallel
attention (``attention.py:133-164``): queries sharded on the sequence
over "model", the compact K/V (KV heads, not repeated) all-gathered over
"model" inside it (``GatherSeq``: the backward reduce-scatters dK/dV),
and the flash kernels run on the rank's slice with ``q_offset = rank *
S_local`` and GQA by index, where the reference repeats the KV heads and
runs its jnp flash inside a ``shard_map``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import wait

NEG_INF = -1e30


def repeat_kv(k, n_heads: int):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head H//KV times."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


class FlashAttention(torch.autograd.Function):
    """Flash attention with a flash backward: the forward saves q, k, v,
    o and the row LSE (O(S) memory, no S x S matrix), the backward
    recomputes P from them. GQA by index in both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        o, lse = ops.flash_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd). Differentiable
    through ``FlashAttention`` when autograd needs a gradient; otherwise
    (prefill under ``no_grad``) the forward kernel alone, with no LSE."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset)
    return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


@dataclass(frozen=True)
class SeqParallel:
    """This rank's place in a sequence-parallel group (the "model" dim of
    a ``zero3_sp`` mesh): ``group`` the functional collectives' group
    (mesh, dim index), ``rank`` its index in it, ``size`` its ranks. Each
    rank holds the ``rank``-th of ``size`` equal slices of the
    sequence."""
    group: object
    rank: int
    size: int


class GatherSeq(torch.autograd.Function):
    """x (B, S_local, ...) -> (B, S_local * size, ...): every rank's slice
    in rank order (an all-gather on dim 1). Its backward is the
    reduce-scatter of the gradient on dim 1 (sum): each slice's gradient
    from every rank's use of it."""

    @staticmethod
    def forward(ctx, x, sp: SeqParallel):
        import torch.distributed._functional_collectives as funcol
        ctx.sp = sp
        return wait(funcol.all_gather_tensor(x.contiguous(), 1, sp.group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return wait(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", 1, ctx.sp.group)), None


def gather_seq(x, sp: SeqParallel):
    """``GatherSeq`` of ``x``; ``x`` itself on a group of one rank."""
    if sp.size == 1:
        return x
    return GatherSeq.apply(x, sp)


def sp_flash_attention(q, k, v, sp: SeqParallel, *, causal: bool):
    """Sequence-parallel attention: q (B, S/n, H, hd) this rank's slice
    of the queries, k/v (B, S_kv/n, KV, hd) its slice of the compact keys
    and values -> (B, S/n, H, hd). K/V are gathered over the group (any
    head count: heads are not split), and ``flash_attention`` runs with
    the slice's causal offset ``rank * S/n``. No reduction of the output:
    the wo projection contracts whole heads."""
    kf = gather_seq(k, sp)
    vf = gather_seq(v, sp)
    return flash_attention(q, kf, vf, causal=causal,
                           q_offset=sp.rank * q.shape[1])


def decode_attention(q, k_cache, v_cache, length):
    """Single-step attention against a compact cache.

    q (B,1,H,hd); k_cache/v_cache (B,S,KV,hd); length (B,) integer: slot
    b sees cache positions < length[b]. The JAX function takes one scalar
    length and runs per slot under ``vmap``; here each slot carries its
    own, so slots at different depths decode in one batched call."""
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    g = H // KV
    qf = q.reshape(B, 1, KV, g, hd).float()
    scale = hd ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    visible = pos[None, :] < length.reshape(B, 1)                 # (B,S)
    s = torch.where(visible[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd).to(q.dtype)
