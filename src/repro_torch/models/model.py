"""Model facade: one entry point per architecture, the counterpart of
``repro.models.model`` for the families the port runs.

``Model`` owns the param-def tree, ``init`` from a ``torch.Generator``
(or ``abstract_params`` on the meta device), the training ``loss``,
``prefill`` / ``decode``, and the ``input_specs`` / ``cache_specs`` of a
step. It dispatches the encdec family to ``models.encdec`` and every
other family to ``models.transformer``.

Its ``dist`` (``distributed.sharding.Dist``, no mesh by default) gives the
layout of the params, the batch and the caches on a mesh:
``param_specs`` / ``param_shardings``, ``input_sharding_specs`` and
``cache_sharding_specs``, the reference's (``model.py:28-50, 115-200``).
The compute itself is the one-card code: the sharded steps of
``distributed/steps.py`` gather the weights and run it on each rank's
batch shard, a moe arch's expert layers expert-parallel over "model"
(``ep``, a ``models.moe.ExpertParallel``). ``opts`` holds the reference's model options the port reads:
``xent_chunk`` (default 512) and ``remat`` (``none`` / ``dots`` /
``full``, default ``full`` as the reference's ``DEFAULT_OPTS``; the
training loss wraps each layer, ``layers.remat_body``). The learner,
the trainer and the serving engine pass ``remat: none``, as the
reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import (Dist, P, Sharding, tree_shardings,
                                              tree_specs)
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (DEFAULT_REMAT, check_remat,
                                       init_params, map_leaves)


class CacheSpec(NamedTuple):
    """Shape and dtype of one input or cache leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass
class Model:
    cfg: ArchConfig
    dist: Dist = field(default_factory=Dist)
    opts: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        tf.check_ported(self.cfg)
        check_remat(self.remat)

    @property
    def remat(self) -> str:
        return (self.opts or {}).get("remat", DEFAULT_REMAT)

    @property
    def dtype(self) -> torch.dtype:
        return tf.model_dtype(self.cfg)

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def param_defs(self):
        if self.encdec:
            return ed.encdec_param_defs(self.cfg)
        return tf.decoder_param_defs(self.cfg, self.dist)

    def init(self, generator: torch.Generator):
        """Fresh weights on ``generator.device``, drawn from it."""
        return init_params(self.param_defs(), generator, self.dtype)

    def abstract_params(self):
        """The param tree as empty tensors on the meta device (the
        reference's ``abstract_params``): shapes and dtypes, no data."""
        return map_leaves(
            lambda _p, d: torch.empty(d.shape, dtype=self.dtype,
                                      device="meta"), self.param_defs())

    def param_specs(self):
        return tree_specs(self.dist, self.param_defs())

    def param_shardings(self):
        return tree_shardings(self.dist, self.param_defs())

    def loss(self, params, batch, xent_chunk: Optional[int] = None,
             sp=None, ep=None):
        """Mean next-token CE of ``batch`` (tokens or embeds, labels;
        encdec: enc_embeds, tokens, labels); ``xent_chunk`` defaults to
        ``opts["xent_chunk"]``, else 512. ``sp`` (a
        ``models.attention.SeqParallel``): ``batch`` is this rank's slice
        of the sequence and attention is sequence-parallel. ``ep`` (a
        ``models.moe.ExpertParallel``): the moe layers run
        expert-parallel on this rank's experts."""
        if xent_chunk is None:
            xent_chunk = (self.opts or {}).get("xent_chunk", 512)
        if self.encdec:
            return ed.encdec_loss(params, batch, self.cfg,
                                  xent_chunk=xent_chunk, sp=sp,
                                  remat=self.remat)
        return tf.lm_loss(params, batch, self.cfg, xent_chunk=xent_chunk,
                          sp=sp, ep=ep, remat=self.remat)

    def prefill(self, params, batch, *, cache=None, slots=None, ep=None):
        """Into a new cache as long as the prompt, or into ``slots`` of a
        batched ``cache`` (``empty_cache``); ``ep`` as in ``loss``."""
        if self.encdec:
            return ed.encdec_prefill(params, batch, self.cfg, cache=cache,
                                     slots=slots)
        return tf.lm_prefill(params, batch, self.cfg, cache=cache,
                             slots=slots, ep=ep)

    def decode(self, params, cache, batch, ep=None):
        if self.encdec:
            return ed.encdec_decode(params, cache, batch, self.cfg)
        return tf.lm_decode(params, cache, batch, self.cfg, ep=ep)

    def input_specs(self, shape: ShapeSpec) -> Dict[str, CacheSpec]:
        """Shapes and dtypes of one step's batch (``model.py:73-112``).
        train/prefill: encdec enc_embeds (B, S/2, D) and tokens (B, S/2);
        stub frontends (vlm) embeds (B, S, D), others tokens (B, S);
        M-RoPE positions (3, B, S); train adds labels. decode: tokens
        (B, 1). Token ids are int64 (torch's index type; int32 in JAX)."""
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i64, act = torch.int64, self.dtype
        if shape.kind == "decode":
            return {"tokens": CacheSpec((B, 1), i64)}
        if c.family == "encdec":
            out = {"enc_embeds": CacheSpec((B, S // 2, c.d_model), act),
                   "tokens": CacheSpec((B, S // 2), i64)}
            if shape.kind == "train":
                out["labels"] = CacheSpec((B, S // 2), i64)
            return out
        out = {}
        if shape.kind == "train":
            out["labels"] = CacheSpec((B, S), i64)
        if c.frontend != "none":
            out["embeds"] = CacheSpec((B, S, c.d_model), act)
        else:
            out["tokens"] = CacheSpec((B, S), i64)
        if c.mrope:
            out["positions"] = CacheSpec((3, B, S), i64)
        return out

    def cache_specs(self, B: int, S: int,
                    S_enc: Optional[int] = None) -> Dict[str, CacheSpec]:
        """Dense: k/v (L, B, S, KV, hd) in the cache dtype. ssm: ssm
        (L, B, H, P, N) f32, conv (L, B, K-1, d_in + 2 G N) in the model
        dtype. Hybrid: k/v per period (np, ...), ssm and conv per mamba
        layer (np, per - 1, ...). encdec: k/v (L, B, S, KV, hd) and
        cross_k/cross_v (L, B, S_enc, KV, hd), S_enc defaulting to S as
        in the reference's specs. All: pos (B,) int64, one write
        position per slot."""
        if self.encdec:
            shapes = ed.cache_shapes(self.cfg, B, S,
                                     S if S_enc is None else S_enc)
        else:
            shapes = tf.cache_shapes(self.cfg, B, S)
        return {k: CacheSpec(*v) for k, v in shapes.items()}

    def input_sharding_specs(self, shape: ShapeSpec) -> Dict[str, P]:
        """The batch's specs: its batch dim over ``dist.batch_axes``
        (positions (3, B, S) on dim 1); ``P()`` each without a mesh."""
        d = self.dist
        specs = self.input_specs(shape)
        if not d.has_mesh:
            return {k: P() for k in specs}
        bt = d.batch_axes
        out = {}
        for k, v in specs.items():
            if k == "positions":
                out[k] = P(None, bt, None)
            elif len(v.shape) == 3:
                out[k] = P(bt, None, None)
            else:
                out[k] = P(bt, None)
        return out

    def cache_sharding_specs(self, B: int) -> Dict[str, P]:
        """Cache specs (``model.py:175-200``): the batch dim over the
        batch axes, a k/v cache's sequence dim over "model", an ssm
        state's heads over "model" where they divide; with no batch axes
        (B not divisible) the sequence dim takes every axis. The port's
        ``pos`` is one position per slot (B,), so it takes the batch axes
        (the reference's is one scalar, ``P()``)."""
        c = self.cfg
        d = self.dist
        if not d.has_mesh:
            return {k: P() for k in self.cache_specs(B, 8)}
        bt = d.batch_axes
        seq_ax = "model" if bt else tuple(d.axis_names)
        heads_ax = None
        if c.ssm is not None:
            from repro_torch.models.mamba import mamba_dims
            nheads = mamba_dims(c)[1]
            if nheads % d.model_size == 0 and d.tp_axis:
                heads_ax = "model"
        out = {}
        for key, spec in self.cache_specs(B, 8).items():
            nd = len(spec.shape)
            if key == "pos":
                out[key] = P(bt)
            elif key in ("k", "v", "cross_k", "cross_v"):
                lead = (None,) * (nd - 4)
                out[key] = P(*lead, bt, seq_ax, None, None)
            elif key == "ssm":
                lead = (None,) * (nd - 4)
                out[key] = P(*lead, bt, heads_ax, None, None)
            elif key == "conv":
                lead = (None,) * (nd - 3)
                out[key] = P(*lead, bt, None, None)
        return out

    def cache_shardings(self, B: int):
        if not self.dist.has_mesh:
            return None
        return {k: Sharding(self.dist.mesh, s)
                for k, s in self.cache_sharding_specs(B).items()}

    def empty_cache(self, B: int, S: int, device,
                    S_enc: Optional[int] = None) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                for k, s in self.cache_specs(B, S, S_enc).items()}


def make_model(cfg: ArchConfig, dist: Optional[Dist] = None,
               opts: Optional[Dict[str, Any]] = None) -> Model:
    return Model(cfg, dist or Dist(), opts)
