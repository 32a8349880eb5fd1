"""Shared layers: param definitions, norms, RoPE/M-RoPE, MLP, embedding,
chunked cross-entropy, last-token logits. Plain functions on tensors; parameter trees are nested
dicts of tensors, the counterpart of ``repro.models.layers``."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# Parameter definition machinery
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    """Abstract parameter: shape + logical dim names + init spec."""
    shape: Tuple[int, ...]
    dims: Tuple[str, ...]
    init: str = "normal"         # normal | zeros | ones | const:<v>
    scale: float = 1.0           # fan-in style scale multiplier

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} vs dims {self.dims}")


# top-level keys of a param tree whose leaves stack the layers on their
# leading dim
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def is_stacked(path: str) -> bool:
    """Whether the leaf at ``path`` of a model's param tree stacks the
    layers on its leading dim."""
    return path.split("/")[0] in STACKED


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) in ``jax.tree.flatten`` order: dict keys sorted,
    depth first. Paths join keys with ``/`` (``blocks/attn/wq``)."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from iter_leaves(val, path + "/")
        else:
            yield path, val


def leaf_at(tree, path: str):
    """The leaf of ``tree`` at an ``iter_leaves`` path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def map_leaves(fn, tree):
    """Same nesting as ``tree``, each leaf replaced by ``fn(path, leaf)``,
    called in ``iter_leaves`` order."""
    def go(t, prefix):
        return {k: (go(t[k], f"{prefix}{k}/") if isinstance(t[k], dict)
                    else fn(f"{prefix}{k}", t[k]))
                for k in sorted(t)}
    return go(tree, "")


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype) -> Dict:
    """Materialise a parameter tree on ``generator.device``.

    Same rule as JAX's ``init_params``: normal leaves draw f32 N(0, 1)
    scaled by ``scale / sqrt(fan_in)`` with ``fan_in = shape[-2]`` (also
    on layer-stacked ``(L, ...)`` shapes), then cast. Torch cannot
    reproduce ``jax.random``, so the distributions match but the numbers
    do not; parity tests carry JAX's weights across instead."""
    return map_leaves(lambda _path, d: init_leaf(d, generator, dtype),
                      defs)            # draws in flatten order


# f32 elements drawn at a time by ``init_leaf``: 256 MiB, or one matrix
# of the leaf's last two dims where that is larger
INIT_DRAW_ELEMS = 1 << 26


def init_leaf(d: ParamDef, generator: torch.Generator,
              dtype: torch.dtype):
    """One leaf of ``init_params``, drawn from ``generator``.

    A normal leaf is drawn into a tensor of ``dtype`` a group of its
    trailing matrices (``shape[-2:]``) at a time, each group in f32
    scaled in place, so its transients stay at ``INIT_DRAW_ELEMS`` f32
    values or one matrix (a grok-1 expert's (6144, 32768): 0.8 GB),
    whatever the leaf's size. A leaf of at most that many values is one
    draw, as ``randn(shape)``."""
    device = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init.startswith("const:"):
        return torch.full(d.shape, float(d.init[6:]), dtype=dtype,
                          device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(1, fan_in))
    inner = d.shape[-2:]
    out = torch.empty(d.shape, dtype=dtype, device=device)
    rows = out.view(-1, *inner)
    step = max(1, INIT_DRAW_ELEMS // max(1, math.prod(inner)))
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        a = torch.randn((n, *inner), generator=generator,
                        dtype=torch.float32, device=device)
        rows[i:i + n].copy_(a.mul_(std))
    return out


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back — the cast points of the JAX layers)
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE (rotate-half layout, f32 angles)
# ---------------------------------------------------------------------------


def _rope_angles(positions, half: int, theta: float):
    """positions (...,) -> cos/sin (..., half)."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None):
    """x (B, S, H, hd); positions (B, S) or (3, B, S) for M-RoPE."""
    hd = x.shape[-1]
    half = hd // 2
    if mrope_sections is None:
        cos, sin = _rope_angles(positions, half, theta)      # (B,S,half)
    else:
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope sections {mrope_sections} must sum "
                             f"to head_dim/2 = {half}")
        cs, ss = [], []
        for i, sec in enumerate(mrope_sections):
            # section i rotates with positions[i] (t/h/w)
            freq_lo = sum(mrope_sections[:i])
            idx = torch.arange(sec, device=positions.device) + freq_lo
            freqs = torch.exp(-math.log(theta) * idx.float() / half)
            ang = positions[i].float()[..., None] * freqs
            cs.append(torch.cos(ang))
            ss.append(torch.sin(ang))
        cos = torch.cat(cs, -1)
        sin = torch.cat(ss, -1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    dt = x.dtype
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     -1).to(dt)


def sinusoid_positions(seq: int, d_model: int, dtype=torch.float32,
                       device=None, start: int = 0):
    """Whisper-style sinusoidal embeddings (seq, d_model): ``[sin, cos]``
    of ``pos * exp(-ln(10000) k / max(1, half - 1))``, k < half, in f32,
    then cast (``repro/models/layers.py:135-141``); rows ``start`` to
    ``start + seq - 1`` (a sequence-parallel slice's)."""
    half = d_model // 2
    pos = torch.arange(start, start + seq, dtype=torch.float32,
                       device=device)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10000.0) * k / max(1, half - 1))
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# MLP, embedding, logits
# ---------------------------------------------------------------------------


def gated_mlp(x, wg, wu, wd):
    """SwiGLU MLP. x (B,S,D); wg/wu (D,F); wd (F,D)."""
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def embed_tokens(tokens, table):
    """tokens (B, S) integer; table (V, D) -> (B, S, D)."""
    return F.embedding(tokens, table)


def _xent_chunk(h, w_head, labels):
    """Summed next-token CE of one sequence chunk: f32 logits
    ``h.to(w_head.dtype) @ w_head``, then ``logsumexp - gold``."""
    logits = (h.to(w_head.dtype) @ w_head).float()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def chunked_xent(h, w_head, labels, chunk: int = 512):
    """h (B,S,D), w_head (D,V), labels (B,S) -> scalar mean CE
    (``repro/models/layers.py:199-230``, no z-loss, no vocab sharding).

    Loops over sequence chunks; each chunk's (B, chunk, V) logits live
    only inside it and are recomputed in the backward
    (``torch.utils.checkpoint``, where JAX uses ``jax.checkpoint``)."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        total = total + checkpoint(_xent_chunk, h[:, s0:s0 + chunk], w_head,
                                   labels[:, s0:s0 + chunk],
                                   use_reentrant=False)
    return total / (B * S)


def last_token_logits(h_last, w_head):
    """h_last (B, 1, D) -> f32 logits (B, 1, V)."""
    return (h_last @ w_head).float()


# ---------------------------------------------------------------------------
# Rematerialisation of a layer body (the reference's ``_remat``)
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "dots", "full")
DEFAULT_REMAT = "full"     # the reference's DEFAULT_OPTS["remat"]


def check_remat(mode: str) -> str:
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r} is not one of {REMAT_MODES}")
    return mode


def _dots_policy(_ctx, op, *_args, **_kwargs):
    """Save the outputs of the matrix products, recompute everything
    else, the hand-written kernels' outputs included: JAX's
    ``checkpoint_policies.checkpoint_dots``, which saves ``dot_general``
    only."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default,
              aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_body(fn, mode: str):
    """``fn`` (a layer body) under the reference's ``remat`` option
    (``repro/models/transformer.py:262-268``): ``none`` as it is;
    ``full`` keeps only the body's inputs for the backward and reruns it
    there (``torch.utils.checkpoint``); ``dots`` keeps the outputs of its
    matrix products too and reruns the rest. A rerun launches the
    body's kernels (K4, K5) again. The numbers are the same in every
    mode, and without autograd (prefill, decode, ``no_grad``) every mode
    runs ``fn`` as it is. A layer draws no random numbers, so no RNG
    state is kept."""
    check_remat(mode)
    if mode == "none":
        return fn

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {"context_fn": _dots_context} if mode == "dots" else {}
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return body
