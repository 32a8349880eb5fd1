"""Decoder-only LM, dense and moe families, the vlm family (fed with
tokens or with frontend ``embeds`` and their M-RoPE positions), the
attention-free ssm family (Mamba-2) and the Jamba-style hybrid: param
defs, the training loss, prefill and decode. The counterpart of
``repro.models.transformer``; the encdec family's stacks are
``models.encdec``, which uses the norms and attention sub-blocks here.

Differences from the JAX module, by design:
  * layers run in a Python loop over the stacked ``(L, ...)`` weights
    (JAX scans them); the hybrid's periods and their layers likewise,
    indexing its two-level ``(periods, n, ...)`` stacks with
    ``layer_params`` (no weight is copied);
  * prefill attention calls ``kernels.ops.flash_attention`` (the CUDA
    kernel on the card, GQA by index) where JAX calls the jnp
    ``flash_attention_ref`` on repeated heads (transformer.py:218);
  * under autograd, attention is ``FlashAttention``: the same forward
    kernel with its row LSE and the flash backward kernel, where JAX
    differentiates the jnp reference;
  * the loss takes the stacked block weights either as ``(L, ...)``
    tensors or as per-layer lists (``layer_params`` indexes both), so a
    trainer can hand each layer's weights in as its own leaf;
  * the cache carries a per-slot position vector ``pos`` (B,), and decode
    writes each slot at its own position: one batched call replaces the
    serving engine's ``jit(vmap(decode_one))``;
  * caches are updated in place (JAX returns new, donated buffers), and
    prefill can write its K/V (ssm: its state and conv tail) straight
    into chosen slots of a batched cache;
  * the ssm family runs the SSD scan through ``models.mamba.ssd_scan``
    (K5 on the card; under autograd ``SSDScan``, with the K5b backward)
    where JAX calls the jnp ``ssd_scan_ref`` and differentiates it;
  * the moe family's FFN is ``models.moe.moe_block``: on one card the
    reference's ``_moe_single``, and on a mesh whose expert axis is
    "model" its expert-parallel bodies, through an ``ep`` argument (a
    ``models.moe.ExpertParallel``) of the loss, prefill and decode,
    which ``distributed.steps`` passes as it passes ``sp``; a batched
    decode step on one card gives each expert
    ``moe.decode_capacity(B)`` slots, at least one per slot, so no slot's
    token is dropped, as in the serving engine's per-slot
    ``vmap(decode_one)``. The reference's batched ``lm_decode`` uses
    ``_capacity(B, ...)`` and agrees whenever that drops nothing. The
    hybrid's MoE layers decode the same way;
  * ``zero3_sp``'s sequence parallelism (``_use_sp``, ``transformer.py:
    156-166, 194-208``) is an argument of the loss, ``sp`` (a
    ``models.attention.SeqParallel``), which ``distributed.steps``
    passes when the batch it hands in is the rank's slice of the
    sequence (with its global ``positions``): attention then runs
    ``sp_flash_attention``. The dense, moe and vlm families take it;
    ``SP_FAMILIES`` are those, as ``_use_sp`` says.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.errors import UserError
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import ExpertParallel
from repro_torch.models.attention import (SeqParallel, decode_attention,
                                         flash_attention,
                                         sp_flash_attention)
from repro_torch.models.layers import (ParamDef, apply_rope, chunked_xent,
                                       embed_tokens, gated_mlp,
                                       last_token_logits, layer_norm,
                                       remat_body, rms_norm)

PORTED_FAMILIES = ("dense", "vlm", "ssm", "moe", "hybrid", "encdec")
# families whose attention runs sequence-parallel under zero3_sp (the SSD
# scan needs its whole sequence per rank)
SP_FAMILIES = ("dense", "moe", "vlm")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise UserError(
            f"{cfg.arch_id!r}: the {cfg.family} family is not yet ported "
            f"to repro_torch (ported: {', '.join(PORTED_FAMILIES)})")


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def cache_dtype(cfg: ArchConfig) -> torch.dtype:
    """bf16 caches for bf16 models; the model dtype otherwise (f32 smoke
    configs), as ``repro.models.transformer._cache_dtype``."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else model_dtype(cfg)


# ---------------------------------------------------------------------------
# Param defs (same tree, shapes and init rules as the JAX module)
# ---------------------------------------------------------------------------


def norm_param_defs(cfg: ArchConfig, scan_dims=()) -> dict:
    ld = tuple("layers" for _ in scan_dims)
    defs = {"w": ParamDef(scan_dims + (cfg.d_model,), ld + ("norm",),
                          init="ones")}
    if cfg.family == "encdec":   # whisper uses LayerNorm
        defs["b"] = ParamDef(scan_dims + (cfg.d_model,), ld + ("norm",),
                             init="zeros")
    return defs


def attn_param_defs(cfg: ArchConfig, scan_dims=()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ld = tuple("layers" for _ in scan_dims)
    defs = {
        "wq": ParamDef(scan_dims + (d, h, hd), ld + ("embed", "heads", "hd")),
        "wk": ParamDef(scan_dims + (d, kv, hd), ld + ("embed", "kv", "hd")),
        "wv": ParamDef(scan_dims + (d, kv, hd), ld + ("embed", "kv", "hd")),
        "wo": ParamDef(scan_dims + (h, hd, d), ld + ("heads", "hd", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(scan_dims + (h, hd), ld + ("heads", "hd"),
                              init="zeros")
        defs["bk"] = ParamDef(scan_dims + (kv, hd), ld + ("kv", "hd"),
                              init="zeros")
        defs["bv"] = ParamDef(scan_dims + (kv, hd), ld + ("kv", "hd"),
                              init="zeros")
    return defs


def mlp_param_defs(cfg: ArchConfig, scan_dims=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    ld = tuple("layers" for _ in scan_dims)
    return {
        "wg": ParamDef(scan_dims + (d, f), ld + ("embed", "ff")),
        "wu": ParamDef(scan_dims + (d, f), ld + ("embed", "ff")),
        "wd": ParamDef(scan_dims + (f, d), ld + ("ff", "embed")),
    }


def n_periods(cfg: ArchConfig) -> int:
    """The hybrid's periods of ``attn_period`` layers."""
    return cfg.n_layers // cfg.attn_period


def _hybrid_param_defs(cfg: ArchConfig, dist=None) -> dict:
    """The reference's ``_hybrid_param_defs``: per period, one attention
    layer and ``per - 1`` mamba layers, each followed by an FFN, MoE at
    odd local index j and SwiGLU at even j."""
    per, np_ = cfg.attn_period, n_periods(cfg)
    n_moe = per // 2
    return {
        "attn": attn_param_defs(cfg, (np_,)),
        "attn_ln": norm_param_defs(cfg, (np_,)),
        "mamba": mam.mamba_param_defs(cfg, (np_, per - 1)),
        "mamba_ln": norm_param_defs(cfg, (np_, per - 1)),
        "ffn_ln": norm_param_defs(cfg, (np_, per)),
        "moe": moe_mod.moe_param_defs(cfg, (np_, n_moe), dist),
        "mlp": mlp_param_defs(cfg, (np_, per - n_moe)),
    }


def decoder_param_defs(cfg: ArchConfig, dist=None) -> dict:
    """The param-def tree of a decoder. A ``Dist`` changes it only
    through moe expert replication (``moe.replication_factor``)."""
    check_ported(cfg)
    L = cfg.n_layers
    if cfg.family == "ssm":
        blocks = {"ln1": norm_param_defs(cfg, (L,)),
                  "mamba": mam.mamba_param_defs(cfg, (L,))}
    elif cfg.family == "hybrid":
        blocks = _hybrid_param_defs(cfg, dist)
    else:
        blocks = {"ln1": norm_param_defs(cfg, (L,)),
                  "ln2": norm_param_defs(cfg, (L,)),
                  "attn": attn_param_defs(cfg, (L,))}
        if cfg.is_moe and cfg.moe.layout == "all":
            blocks["moe"] = moe_mod.moe_param_defs(cfg, (L,), dist)
        else:
            blocks["mlp"] = mlp_param_defs(cfg, (L,))
    return {
        "blocks": blocks,
        "final_norm": norm_param_defs(cfg),
        "head": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
    }


def layer_params(blocks: Dict, l: int) -> Dict:
    """Layer ``l``'s weights: views of the layer-stacked ``(L, ...)``
    block weights, or entry ``l`` of per-layer lists. On the hybrid's
    blocks it gives period ``l``, whose stacks it indexes again."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------


def norm_apply(x, p, cfg: ArchConfig):
    """LayerNorm where the leaf has a bias (the encdec family's), else
    RMSNorm."""
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def _qkv(h, p, cfg: ArchConfig, positions):
    B, S, D = h.shape
    q = (h @ p["wq"].reshape(D, -1)).view(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["wv"].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    sections = cfg.mrope_sections if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def _out_proj(out, p, cfg: ArchConfig):
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)


def attn_prefill(h, p, cfg: ArchConfig, positions, causal: bool = True,
                 sp: Optional[SeqParallel] = None):
    """Full-sequence attention (prefill, and the training loss, where
    autograd differentiates it through the flash kernels); returns (out,
    (k, v)) with k after RoPE, both in the cache dtype. With ``sp``, ``h``
    and ``positions`` are the rank's slice of the sequence and attention
    is ``sp_flash_attention`` (k, v stay the slice's)."""
    q, k, v = _qkv(h, p, cfg, positions)
    if sp is not None:
        out = sp_flash_attention(q, k, v, sp, causal=causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    cd = cache_dtype(cfg)
    return _out_proj(out, p, cfg), (k.to(cd), v.to(cd))


def cache_update(cache, new, pos):
    """Write new (B,1,KV,hd) into cache (B,S,KV,hd) in place, slot b at
    position pos[b]. A position past the end writes the last row, as
    JAX's ``dynamic_update_slice`` clamps its start (free serving slots
    keep counting up)."""
    B, S = cache.shape[:2]
    idx = pos.clamp(max=S - 1)
    cache[torch.arange(B, device=cache.device), idx] = \
        new[:, 0].to(cache.dtype)
    return cache


def attn_decode(h, p, cfg: ArchConfig, pos, kc, vc):
    """h (B,1,D); pos (B,); kc/vc (B,S,KV,hd), updated in place."""
    positions = pos.reshape(-1, 1)
    if cfg.mrope:
        positions = positions.expand(3, *positions.shape)
    q, k, v = _qkv(h, p, cfg, positions)
    cache_update(kc, k, pos)
    cache_update(vc, v, pos)
    out = decode_attention(q, kc, vc, pos + 1)
    return _out_proj(out, p, cfg), kc, vc


def ffn_apply(h, bp, cfg: ArchConfig, capacity: Optional[int] = None,
              ep: Optional[ExpertParallel] = None):
    """The block's FFN: the moe block where the layer has one
    (``capacity`` slots per expert, by default ``moe._capacity`` of the
    tokens; expert-parallel with ``ep``), else the SwiGLU MLP."""
    if "moe" in bp:
        return moe_mod.moe_block(h, bp["moe"], cfg, capacity, ep)
    return gated_mlp(h, bp["mlp"]["wg"], bp["mlp"]["wu"], bp["mlp"]["wd"])


def hybrid_stack(h, blocks, cfg: ArchConfig, attn, mamba,
                 capacity: Optional[int] = None,
                 ep: Optional[ExpertParallel] = None, remat: str = "none"):
    """The hybrid's layers in order (the reference's ``_hybrid_period``,
    period after period): in period p, layer j = 0 mixes with
    ``attn(p, x, weights)`` and layer j >= 1 with ``mamba(p, j - 1, x,
    weights)``, x the normed residual; each mixer's output is added to
    the residual, then the layer's FFN (``moe_block`` with ``capacity``
    at odd j, sub-index (j - 1) // 2, expert-parallel with ``ep``;
    SwiGLU at even j, sub-index j // 2). The callbacks write the caches
    of prefill and decode. ``remat`` wraps each period, as the
    reference's ``_hybrid_loss`` wraps its scan body."""
    def period(h, p):
        bp = layer_params(blocks, p)
        for j in range(cfg.attn_period):
            if j == 0:
                x = norm_apply(h, bp["attn_ln"], cfg)
                h = h + attn(p, x, bp["attn"])
            else:
                x = norm_apply(h, layer_params(bp["mamba_ln"], j - 1), cfg)
                h = h + mamba(p, j - 1, x, layer_params(bp["mamba"], j - 1))
            x = norm_apply(h, layer_params(bp["ffn_ln"], j), cfg)
            if j % 2:
                h = h + moe_mod.moe_block(
                    x, layer_params(bp["moe"], (j - 1) // 2), cfg, capacity,
                    ep)
            else:
                mp = layer_params(bp["mlp"], j // 2)
                h = h + gated_mlp(x, mp["wg"], mp["wu"], mp["wd"])
        return h
    period = remat_body(period, remat)
    for p in range(n_periods(cfg)):
        h = period(h, p)
    return h


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _inputs_to_h(params, batch, cfg: ArchConfig):
    """Hidden states (B, S, D) and RoPE positions of ``batch``: its
    ``embeds`` (a stub frontend's, cast to the model dtype) or its
    embedded ``tokens``; its ``positions`` ((B, S), or (3, B, S) for
    M-RoPE), else 0..S-1 (broadcast to (3, B, S) for M-RoPE)
    (``transformer.py:300-316``)."""
    if "embeds" in batch:
        h = batch["embeds"].to(model_dtype(cfg))
    else:
        h = embed_tokens(batch["tokens"], params["embed"])
    B, S = h.shape[:2]
    return h, _positions(batch, B, S, cfg, h.device)


def cache_shapes(cfg: ArchConfig, B: int, S: int) -> Dict[str, Tuple]:
    """(shape, dtype) of each cache leaf, as ``repro.models.model``'s
    ``cache_specs``: dense k/v (L, B, S, KV, hd) in the cache dtype; ssm
    state (L, B, H, P, N) f32 and conv tail (L, B, K-1, d_in + 2 G N) in
    the model dtype; the hybrid's k/v per period (np, B, S, KV, hd) and
    its state and tail per mamba layer (np, per - 1, B, ...); pos (B,)
    int64, one position per slot."""
    hybrid = cfg.family == "hybrid"
    out = {}
    if cfg.family != "ssm":
        n_attn = n_periods(cfg) if hybrid else cfg.n_layers
        out["k"] = out["v"] = ((n_attn, B, S, cfg.n_kv_heads, cfg.hd),
                               cache_dtype(cfg))
    if cfg.family in ("ssm", "hybrid"):
        d_in, nheads, gn, k = mam.mamba_dims(cfg)
        s = cfg.ssm
        lead = ((n_periods(cfg), cfg.attn_period - 1) if hybrid
                else (cfg.n_layers,))
        out["ssm"] = (lead + (B, nheads, s.head_dim, s.d_state),
                      torch.float32)
        out["conv"] = (lead + (B, k - 1, d_in + 2 * gn), model_dtype(cfg))
    out["pos"] = ((B,), torch.int64)
    return out


def lm_prefill(params, batch, cfg: ArchConfig, *,
               cache: Optional[Dict] = None, slots=None,
               ep: Optional[ExpertParallel] = None):
    """Prefill ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S,
    D) with optional ``positions``. Returns (logits (B,1,V) f32, cache).

    With ``cache=None`` a new cache (``cache_shapes(cfg, B, S)``) is
    built, as JAX's ``lm_prefill`` returns. With a batched cache and
    ``slots`` (B,) row b goes straight into slot ``slots[b]``: its K/V
    at positions 0..S-1 (positions past S keep what they held, which
    decode masks), its ssm state and conv tail, or the hybrid's both;
    its ``pos`` becomes S. ``ep``: the moe layers run expert-parallel
    (``moe.moe_block``)."""
    h, positions = _inputs_to_h(params, batch, cfg)
    B, S = h.shape[:2]
    dev = h.device
    blocks = params["blocks"]
    if cache is None:
        cache = {k: (torch.zeros if k == "pos" else torch.empty)(
                     shape, dtype=dt, device=dev)
                 for k, (shape, dt) in cache_shapes(cfg, B, S).items()}
        slots = torch.arange(B, device=dev)
    elif slots is None:
        raise ValueError("lm_prefill into a batched cache needs slots")
    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            out, state, tail = mam.mamba_block(x, bp["mamba"], cfg)
            h = h + out
            cache["ssm"][l, slots] = state
            cache["conv"][l, slots] = tail
    elif cfg.family == "hybrid":
        def attn(p, x, w):
            a, (k, v) = attn_prefill(x, w, cfg, positions)
            cache["k"][p, slots, :S] = k
            cache["v"][p, slots, :S] = v
            return a

        def mamba(p, i, x, w):
            out, state, tail = mam.mamba_block(x, w, cfg)
            cache["ssm"][p, i, slots] = state
            cache["conv"][p, i, slots] = tail
            return out
        h = hybrid_stack(h, blocks, cfg, attn, mamba, ep=ep)
    else:
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            a, (k, v) = attn_prefill(x, bp["attn"], cfg, positions)
            h = h + a
            x = norm_apply(h, bp["ln2"], cfg)
            h = h + ffn_apply(x, bp, cfg, ep=ep)
            cache["k"][l, slots, :S] = k
            cache["v"][l, slots, :S] = v
    cache["pos"][slots] = S
    h = norm_apply(h, params["final_norm"], cfg)
    logits = last_token_logits(h[:, -1:], params["head"])
    return logits, cache


def lm_decode(params, cache, batch, cfg: ArchConfig,
              ep: Optional[ExpertParallel] = None):
    """One decode step for every slot. batch: tokens (B,1), or (not the
    hybrid, as in the reference) embeds (B,1,D). cache: as
    ``cache_shapes``, updated in place (pos advances by one). Returns
    (logits (B,1,V) f32, cache). RoPE's position is each slot's cache
    position, in all three M-RoPE sections (``attn_decode``). With ``ep``
    the moe layers run expert-parallel, their capacity the reference's
    ``_capacity`` of the rank's tokens."""
    if "embeds" in batch and cfg.family != "hybrid":
        h = batch["embeds"].to(model_dtype(cfg))
    else:
        h = embed_tokens(batch["tokens"], params["embed"])
    pos = cache["pos"]
    blocks = params["blocks"]
    capacity = moe_mod.decode_capacity(h.shape[0]) if cfg.is_moe else None
    if cfg.family == "hybrid":
        def attn(p, x, w):
            return attn_decode(x, w, cfg, pos, cache["k"][p],
                               cache["v"][p])[0]

        def mamba(p, i, x, w):
            out, state, tail = mam.mamba_decode(
                x, w, cfg, cache["ssm"][p, i], cache["conv"][p, i])
            cache["ssm"][p, i] = state
            cache["conv"][p, i] = tail
            return out
        h = hybrid_stack(h, blocks, cfg, attn, mamba, capacity, ep)
    else:
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            if cfg.family == "ssm":
                out, state, tail = mam.mamba_decode(
                    x, bp["mamba"], cfg, cache["ssm"][l], cache["conv"][l])
                h = h + out
                cache["ssm"][l] = state
                cache["conv"][l] = tail
                continue
            a, _, _ = attn_decode(x, bp["attn"], cfg, pos, cache["k"][l],
                                  cache["v"][l])
            h = h + a
            x = norm_apply(h, bp["ln2"], cfg)
            h = h + ffn_apply(x, bp, cfg, capacity, ep)
    cache["pos"] = pos + 1
    h = norm_apply(h, params["final_norm"], cfg)
    return last_token_logits(h, params["head"]), cache


def _positions(batch, B: int, S: int, cfg: ArchConfig, dev):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=dev).expand(B, S)
        if cfg.mrope:
            positions = positions.expand(3, B, S)
    return positions


def lm_loss(params, batch, cfg: ArchConfig, xent_chunk: int = 512,
            sp: Optional[SeqParallel] = None,
            ep: Optional[ExpertParallel] = None, remat: str = "none"):
    """Next-token CE loss (``transformer.py:272-332`` and
    ``_hybrid_loss``). batch: tokens (B, S), labels (B, S)[, positions].
    Embed; per layer, dense and moe: norm -> attention (RoPE, flash
    kernels, GQA by index) -> wo -> residual -> norm -> SwiGLU (moe:
    ``moe_block``) -> residual; ssm: norm -> ``mamba_block`` (the SSD
    scan through ``SSDScan``) -> residual; hybrid: ``hybrid_stack`` of
    the two mixers; final norm; chunked CE with chunk
    ``min(xent_chunk, S)``. ``remat`` (``layers.remat_body``) wraps each
    layer, or each hybrid period, as the reference's ``_remat`` wraps its
    scan body. ``embeds`` (B, S, D) may stand in for tokens, as in
    ``lm_prefill``.

    With ``sp`` (``SP_FAMILIES`` only) the batch is this rank's slice of
    the sequence, with its global ``positions``, attention gathers the
    group's K/V, and the loss is the slice's mean CE (the group's mean is
    the mean of its ranks': the slices are equal). With ``ep`` the moe
    layers run expert-parallel (``ep.sliced`` when ``sp`` is given)."""
    if sp is not None and cfg.family not in SP_FAMILIES:
        raise ValueError(f"{cfg.family}: no sequence-parallel loss")
    h, positions = _inputs_to_h(params, batch, cfg)
    S = h.shape[1]
    blocks = params["blocks"]
    if cfg.family == "hybrid":
        h = hybrid_stack(
            h, blocks, cfg,
            lambda p, x, w: attn_prefill(x, w, cfg, positions)[0],
            lambda p, i, x, w: mam.mamba_block(x, w, cfg)[0], ep=ep,
            remat=remat)
    else:
        def layer(h, l):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            if cfg.family == "ssm":
                return h + mam.mamba_block(x, bp["mamba"], cfg)[0]
            h = h + attn_prefill(x, bp["attn"], cfg, positions, sp=sp)[0]
            x = norm_apply(h, bp["ln2"], cfg)
            return h + ffn_apply(x, bp, cfg, ep=ep)
        layer = remat_body(layer, remat)
        for l in range(cfg.n_layers):
            h = layer(h, l)
    h = norm_apply(h, params["final_norm"], cfg)
    return chunked_xent(h, params["head"], batch["labels"],
                        chunk=min(xent_chunk, S))
