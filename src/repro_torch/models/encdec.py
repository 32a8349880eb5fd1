"""Whisper-style encoder-decoder backbone (conv frontend stubbed): the
counterpart of ``repro.models.encdec`` on one card.

The encoder takes precomputed frame embeddings ``enc_embeds`` (B, S_enc,
D); positions are sinusoidal (no RoPE), norms are LayerNorm (weight and
bias) and the MLP is the reference's SwiGLU (``encdec.py:117, 143``), not
Whisper's GELU. The decoder carries a causal self-attention cache and a
fixed cross-attention cache, the encoder output's K/V, made at prefill.

Differences from the JAX module, by design:
  * layers run in a Python loop over the stacked ``(L, ...)`` weights
    (JAX scans them);
  * full-sequence attention goes through ``models.attention.
    flash_attention``: K4 on the card, ``FlashAttention`` (K4 + K4b)
    under autograd, where JAX calls the jnp ``flash_attention_ref``.
    Encoder self-attention is non-causal, decoder self-attention causal,
    cross-attention non-causal over the encoder's S_enc keys;
  * ``_attn_full``'s sequence-parallel branch (``encdec.py:60-86``) is
    the loss's ``sp`` argument (a ``models.attention.SeqParallel``):
    ``distributed.steps`` passes it when the frames and the tokens it
    hands in are the rank's slices of both sequences (``_sp_ok`` of
    each); the sinusoid rows are then the slices' global positions, and
    self and cross attention run ``sp_flash_attention``, which gathers
    the group's K/V of the encoder or decoder slice;
  * the cache's ``pos`` is per slot (B,), as in ``models.transformer``:
    the decoder's sinusoid row is a per-slot gather, and each slot's
    self-attention K/V is written at its own position, in place;
  * prefill can write into ``slots`` of a batched cache the caller
    made (``Model.cache_specs(B, S, S_enc)``), as ``lm_prefill`` does;
    the self cache may then be longer than the prompt. Without one the
    cache is as long as the prompt, as the reference's, and a decode on
    it writes the last row, as the reference's clamped
    ``dynamic_update_slice`` does.
Decode attention stays plain PyTorch, as the reference's is jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (SeqParallel, decode_attention,
                                         flash_attention,
                                         sp_flash_attention)
from repro_torch.models.layers import (ParamDef, chunked_xent, embed_tokens,
                                       gated_mlp, last_token_logits,
                                       remat_body, sinusoid_positions)
from repro_torch.models.transformer import (attn_param_defs, cache_dtype,
                                            cache_update, layer_params,
                                            mlp_param_defs, model_dtype,
                                            norm_apply, norm_param_defs)


def encdec_param_defs(cfg: ArchConfig) -> dict:
    L = cfg.n_layers
    enc_block = {
        "ln1": norm_param_defs(cfg, (L,)),
        "attn": attn_param_defs(cfg, (L,)),
        "ln2": norm_param_defs(cfg, (L,)),
        "mlp": mlp_param_defs(cfg, (L,)),
    }
    dec_block = {
        "ln1": norm_param_defs(cfg, (L,)),
        "self_attn": attn_param_defs(cfg, (L,)),
        "ln2": norm_param_defs(cfg, (L,)),
        "cross_attn": attn_param_defs(cfg, (L,)),
        "ln3": norm_param_defs(cfg, (L,)),
        "mlp": mlp_param_defs(cfg, (L,)),
    }
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "enc_blocks": enc_block,
        "enc_norm": norm_param_defs(cfg),
        "dec_blocks": dec_block,
        "final_norm": norm_param_defs(cfg),
        "head": ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }


def _proj(x, w, n_heads: int):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, n_heads, w.shape[-1])


def _out_proj(out, wo):
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_full(h, p, cfg: ArchConfig, causal: bool, kv_h=None,
               sp: Optional[SeqParallel] = None):
    """Self (``kv_h`` None) or cross (``kv_h`` the encoder states)
    attention over the whole sequence; returns (out, (k, v)) with k/v in
    the cache dtype. With ``sp`` both ``h`` and ``kv_h`` are the rank's
    slices, and the K/V of the group's slices are gathered."""
    src = h if kv_h is None else kv_h
    q = _proj(h, p["wq"], cfg.n_heads)
    k = _proj(src, p["wk"], cfg.n_kv_heads)
    v = _proj(src, p["wv"], cfg.n_kv_heads)
    if sp is not None:
        out = sp_flash_attention(q, k, v, sp, causal=causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    cd = cache_dtype(cfg)
    return _out_proj(out, p["wo"]), (k.to(cd), v.to(cd))


def _mlp(x, m):
    return gated_mlp(x, m["wg"], m["wu"], m["wd"])


def _start(sp: Optional[SeqParallel], seq: int) -> int:
    """The global position of a slice's first row."""
    return 0 if sp is None else sp.rank * seq


def encode(params, enc_embeds, cfg: ArchConfig,
           sp: Optional[SeqParallel] = None, remat: str = "none"):
    """Encoder states (B, S_enc, D) of the frame embeddings: sinusoid
    positions, then per layer LayerNorm -> non-causal self-attention ->
    residual -> LayerNorm -> SwiGLU -> residual; the final LayerNorm.
    With ``sp``, of the rank's slice of the frames. ``remat`` wraps each
    layer (``layers.remat_body``)."""
    h = enc_embeds.to(model_dtype(cfg))
    S = h.shape[1]
    h = h + sinusoid_positions(S, cfg.d_model, h.dtype, h.device,
                               start=_start(sp, S))
    blocks = params["enc_blocks"]

    def layer(h, l):
        bp = layer_params(blocks, l)
        x = norm_apply(h, bp["ln1"], cfg)
        h = h + _attn_full(x, bp["attn"], cfg, causal=False, sp=sp)[0]
        x = norm_apply(h, bp["ln2"], cfg)
        return h + _mlp(x, bp["mlp"])
    layer = remat_body(layer, remat)
    for l in range(cfg.n_layers):
        h = layer(h, l)
    return norm_apply(h, params["enc_norm"], cfg)


def _decode_stack(params, tokens, enc_h, cfg: ArchConfig, cache=None,
                  slots=None, sp: Optional[SeqParallel] = None,
                  remat: str = "none"):
    """The decoder over ``tokens`` (B, S) against the encoder states.
    With ``cache``, writes each row's self K/V at positions 0..S-1 and
    its cross K/V into slot ``slots[b]`` (the reference's ``collect``).
    With ``sp``, of the rank's slices of the tokens and encoder states.
    ``remat`` wraps each layer. Returns the final-normed states."""
    h = embed_tokens(tokens, params["embed"])
    S = h.shape[1]
    h = h + sinusoid_positions(S, cfg.d_model, h.dtype, h.device,
                               start=_start(sp, S))
    blocks = params["dec_blocks"]

    def layer(h, l):
        bp = layer_params(blocks, l)
        x = norm_apply(h, bp["ln1"], cfg)
        a, (sk, sv) = _attn_full(x, bp["self_attn"], cfg, causal=True,
                                 sp=sp)
        h = h + a
        x = norm_apply(h, bp["ln2"], cfg)
        a, (ck, cv) = _attn_full(x, bp["cross_attn"], cfg, causal=False,
                                 kv_h=enc_h, sp=sp)
        h = h + a
        x = norm_apply(h, bp["ln3"], cfg)
        h = h + _mlp(x, bp["mlp"])
        if cache is not None:
            cache["k"][l, slots, :S] = sk
            cache["v"][l, slots, :S] = sv
            cache["cross_k"][l, slots] = ck
            cache["cross_v"][l, slots] = cv
        return h
    layer = remat_body(layer, remat)
    for l in range(cfg.n_layers):
        h = layer(h, l)
    return norm_apply(h, params["final_norm"], cfg)


def encdec_loss(params, batch, cfg: ArchConfig, xent_chunk: int = 512,
                sp: Optional[SeqParallel] = None, remat: str = "none"):
    """Mean next-token CE of the decoder. batch: enc_embeds (B, S_enc,
    D), tokens (B, S), labels (B, S); chunked CE with chunk
    ``min(xent_chunk, S)``. ``remat`` wraps each encoder and decoder
    layer, as the reference's scan bodies. With ``sp``, the batch holds
    the rank's slices of the frames and of the tokens and labels, and the
    loss is the slice's mean."""
    enc_h = encode(params, batch["enc_embeds"], cfg, sp, remat)
    h = _decode_stack(params, batch["tokens"], enc_h, cfg, sp=sp,
                      remat=remat)
    return chunked_xent(h, params["head"], batch["labels"],
                        chunk=min(xent_chunk, h.shape[1]))


def cache_shapes(cfg: ArchConfig, B: int, S: int, S_enc: int):
    """(shape, dtype) of each cache leaf: self k/v (L, B, S, KV, hd) and
    cross k/v (L, B, S_enc, KV, hd) in the cache dtype, pos (B,) int64.
    The reference's ``cache_specs`` gives the cross cache the self
    cache's length S (``model.py:137-143``); its prefill makes it S_enc
    long, which is what decode reads."""
    cd = cache_dtype(cfg)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {"k": ((L, B, S, kv, hd), cd), "v": ((L, B, S, kv, hd), cd),
            "cross_k": ((L, B, S_enc, kv, hd), cd),
            "cross_v": ((L, B, S_enc, kv, hd), cd),
            "pos": ((B,), torch.int64)}


def encdec_prefill(params, batch, cfg: ArchConfig, *,
                   cache: Optional[dict] = None, slots=None):
    """Encode ``batch["enc_embeds"]`` (B, S_enc, D) and run the decoder
    over ``batch["tokens"]`` (B, S). Returns (logits (B,1,V) f32 at the
    last position, cache).

    With ``cache=None`` a new cache as long as the prompt is built, as
    the reference's prefill returns. With a batched cache
    (``cache_shapes(cfg, N, M, S_enc)``, M >= S) and ``slots`` (B,) row
    b goes into slot ``slots[b]``: its self K/V at positions 0..S-1
    (positions past S keep what they held, which decode masks), its
    cross K/V, and ``pos`` S."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_h = encode(params, batch["enc_embeds"], cfg)
    if cache is None:
        cache = {k: torch.zeros(shape, dtype=dt, device=tokens.device)
                 for k, (shape, dt) in cache_shapes(
                     cfg, B, S, enc_h.shape[1]).items()}
        slots = torch.arange(B, device=tokens.device)
    elif slots is None:
        raise ValueError("encdec_prefill into a batched cache needs slots")
    h = _decode_stack(params, tokens, enc_h, cfg, cache, slots)
    cache["pos"][slots] = S
    return last_token_logits(h[:, -1:], params["head"]), cache


def encdec_decode(params, cache, batch, cfg: ArchConfig):
    """One decoder step for every slot. batch: tokens (B, 1). Slot b's
    token takes sinusoid row ``pos[b]`` of ``S + 1`` rows (clamped, as
    the reference's ``dynamic_slice``), writes its self K/V at ``pos[b]``
    (clamped to the last row) and attends to positions <= pos[b]; cross-
    attention sees all S_enc encoder positions. The cache is updated in
    place and ``pos`` advances. Returns (logits (B,1,V) f32, cache)."""
    h = embed_tokens(batch["tokens"], params["embed"])
    B = h.shape[0]
    pos = cache["pos"]
    S = cache["k"].shape[2]
    sin = sinusoid_positions(S + 1, cfg.d_model, h.dtype, h.device)
    h = h + sin[pos.clamp(0, S)][:, None]
    cross_len = torch.full((B,), cache["cross_k"].shape[2],
                           dtype=pos.dtype, device=pos.device)
    blocks = params["dec_blocks"]
    for l in range(cfg.n_layers):
        bp = layer_params(blocks, l)
        kc, vc = cache["k"][l], cache["v"][l]
        x = norm_apply(h, bp["ln1"], cfg)
        p = bp["self_attn"]
        q = _proj(x, p["wq"], cfg.n_heads)
        cache_update(kc, _proj(x, p["wk"], cfg.n_kv_heads), pos)
        cache_update(vc, _proj(x, p["wv"], cfg.n_kv_heads), pos)
        h = h + _out_proj(decode_attention(q, kc, vc, pos + 1), p["wo"])
        x = norm_apply(h, bp["ln2"], cfg)
        p = bp["cross_attn"]
        q = _proj(x, p["wq"], cfg.n_heads)
        a = decode_attention(q, cache["cross_k"][l], cache["cross_v"][l],
                             cross_len)
        h = h + _out_proj(a, p["wo"])
        x = norm_apply(h, bp["ln3"], cfg)
        h = h + _mlp(x, bp["mlp"])
    cache["pos"] = pos + 1
    h = norm_apply(h, params["final_norm"], cfg)
    return last_token_logits(h, params["head"]), cache
