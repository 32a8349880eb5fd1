"""Decoder-only LM, dense family (and the vlm family fed with tokens),
and the attention-free ssm family (Mamba-2): param defs, the training
loss (dense), prefill and decode. The counterpart of the dense and ssm
paths of ``repro.models.transformer``.

Differences from the JAX module, by design:
  * layers run in a Python loop over the stacked ``(L, ...)`` weights
    (JAX scans them);
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
    where JAX calls the jnp ``ssd_scan_ref`` and differentiates it.
The moe, hybrid and encdec families and vlm ``embeds`` inputs raise
``UserError``: they are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.errors import UserError
from repro_torch.models import mamba as mam
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import (ParamDef, apply_rope, chunked_xent,
                                       embed_tokens, gated_mlp,
                                       last_token_logits, rms_norm)

PORTED_FAMILIES = ("dense", "vlm", "ssm")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.is_moe:
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
    return {"w": ParamDef(scan_dims + (cfg.d_model,), ld + ("norm",),
                          init="ones")}


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


def decoder_param_defs(cfg: ArchConfig) -> dict:
    check_ported(cfg)
    L = cfg.n_layers
    if cfg.family == "ssm":
        blocks = {"ln1": norm_param_defs(cfg, (L,)),
                  "mamba": mam.mamba_param_defs(cfg, (L,))}
    else:
        blocks = {"ln1": norm_param_defs(cfg, (L,)),
                  "ln2": norm_param_defs(cfg, (L,)),
                  "attn": attn_param_defs(cfg, (L,)),
                  "mlp": mlp_param_defs(cfg, (L,))}
    return {
        "blocks": blocks,
        "final_norm": norm_param_defs(cfg),
        "head": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
    }


def layer_params(blocks: Dict, l: int) -> Dict:
    """Layer ``l``'s weights: views of the layer-stacked ``(L, ...)``
    block weights, or entry ``l`` of per-layer lists."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------


def norm_apply(x, p, cfg: ArchConfig):
    """RMSNorm: the ported families carry no norm bias (LayerNorm is
    whisper's, not ported yet)."""
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


def attn_prefill(h, p, cfg: ArchConfig, positions, causal: bool = True):
    """Full-sequence attention (prefill, and the training loss, where
    autograd differentiates it through the flash kernels); returns (out,
    (k, v)) with k after RoPE, both in the cache dtype."""
    q, k, v = _qkv(h, p, cfg, positions)
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


def ffn_apply(h, bp, cfg: ArchConfig):
    return gated_mlp(h, bp["mlp"]["wg"], bp["mlp"]["wu"], bp["mlp"]["wd"])


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _tokens(batch: Dict[str, Any]):
    if "embeds" in batch:
        raise UserError("embeds inputs (vlm frontends) are not yet ported "
                        "to repro_torch; pass tokens")
    return batch["tokens"]


def cache_shapes(cfg: ArchConfig, B: int, S: int) -> Dict[str, Tuple]:
    """(shape, dtype) of each cache leaf, as ``repro.models.model``'s
    ``cache_specs``: dense k/v (L, B, S, KV, hd) in the cache dtype; ssm
    state (L, B, H, P, N) f32 and conv tail (L, B, K-1, d_in + 2 G N) in
    the model dtype; pos (B,) int64, one position per slot."""
    pos = ((B,), torch.int64)
    if cfg.family == "ssm":
        d_in, nheads, gn, k = mam.mamba_dims(cfg)
        L, s = cfg.n_layers, cfg.ssm
        return {"ssm": ((L, B, nheads, s.head_dim, s.d_state),
                        torch.float32),
                "conv": ((L, B, k - 1, d_in + 2 * gn), model_dtype(cfg)),
                "pos": pos}
    kv = ((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd), cache_dtype(cfg))
    return {"k": kv, "v": kv, "pos": pos}


def lm_prefill(params, batch, cfg: ArchConfig, *,
               cache: Optional[Dict] = None, slots=None):
    """Prefill ``batch["tokens"]`` (B, S). Returns (logits (B,1,V) f32,
    cache).

    With ``cache=None`` a new cache (``cache_shapes(cfg, B, S)``) is
    built, as JAX's ``lm_prefill`` returns. With a batched cache and
    ``slots`` (B,) row b goes straight into slot ``slots[b]``: its K/V
    at positions 0..S-1 (positions past S keep what they held, which
    decode masks), or its ssm state and conv tail; its ``pos`` becomes
    S."""
    tokens = _tokens(batch)
    B, S = tokens.shape
    dev = tokens.device
    h = embed_tokens(tokens, params["embed"])
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
    else:
        positions = _positions(batch, B, S, cfg, dev)
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            a, (k, v) = attn_prefill(x, bp["attn"], cfg, positions)
            h = h + a
            x = norm_apply(h, bp["ln2"], cfg)
            h = h + ffn_apply(x, bp, cfg)
            cache["k"][l, slots, :S] = k
            cache["v"][l, slots, :S] = v
    cache["pos"][slots] = S
    h = norm_apply(h, params["final_norm"], cfg)
    logits = last_token_logits(h[:, -1:], params["head"])
    return logits, cache


def lm_decode(params, cache, batch, cfg: ArchConfig):
    """One decode step for every slot. batch: tokens (B,1). cache: as
    ``cache_shapes``, updated in place (pos advances by one). Returns
    (logits (B,1,V) f32, cache)."""
    h = embed_tokens(_tokens(batch), params["embed"])
    pos = cache["pos"]
    blocks = params["blocks"]
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
        h = h + ffn_apply(x, bp, cfg)
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


def lm_loss(params, batch, cfg: ArchConfig, xent_chunk: int = 512):
    """Next-token CE loss (``transformer.py:272-332``, dense and ssm
    families). batch: tokens (B, S), labels (B, S)[, positions]. Embed;
    per layer, dense: norm -> attention (RoPE, flash kernels, GQA by
    index) -> wo -> residual -> norm -> SwiGLU -> residual; ssm: norm ->
    ``mamba_block`` (the SSD scan through ``SSDScan``) -> residual; final
    norm; chunked CE with chunk ``min(xent_chunk, S)``. No remat of the
    layers (the learner's ``remat: none``)."""
    tokens = _tokens(batch)
    B, S = tokens.shape
    h = embed_tokens(tokens, params["embed"])
    blocks = params["blocks"]
    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            h = h + mam.mamba_block(x, bp["mamba"], cfg)[0]
    else:
        positions = _positions(batch, B, S, cfg, tokens.device)
        for l in range(cfg.n_layers):
            bp = layer_params(blocks, l)
            x = norm_apply(h, bp["ln1"], cfg)
            h = h + attn_prefill(x, bp["attn"], cfg, positions)[0]
            x = norm_apply(h, bp["ln2"], cfg)
            h = h + ffn_apply(x, bp, cfg)
    h = norm_apply(h, params["final_norm"], cfg)
    return chunked_xent(h, params["head"], batch["labels"],
                        chunk=min(xent_chunk, S))
