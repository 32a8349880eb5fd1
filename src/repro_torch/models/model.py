"""Model facade: one entry point per architecture, the counterpart of
``repro.models.model`` for the families the port runs.

``Model`` owns the param-def tree, ``init`` from a ``torch.Generator``,
the training ``loss``, ``prefill`` / ``decode`` and ``cache_specs``.
There is no mesh: the port runs one card per model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import init_params


class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        tf.check_ported(self.cfg)

    @property
    def dtype(self) -> torch.dtype:
        return tf.model_dtype(self.cfg)

    def param_defs(self):
        return tf.decoder_param_defs(self.cfg)

    def init(self, generator: torch.Generator):
        """Fresh weights on ``generator.device``, drawn from it."""
        return init_params(self.param_defs(), generator, self.dtype)

    def loss(self, params, batch, xent_chunk: int = 512):
        """Mean next-token CE of ``batch`` (tokens, labels)."""
        return tf.lm_loss(params, batch, self.cfg, xent_chunk=xent_chunk)

    def prefill(self, params, batch, *, cache=None, slots=None):
        return tf.lm_prefill(params, batch, self.cfg, cache=cache,
                             slots=slots)

    def decode(self, params, cache, batch):
        return tf.lm_decode(params, cache, batch, self.cfg)

    def cache_specs(self, B: int, S: int) -> Dict[str, CacheSpec]:
        """Dense: k/v (L, B, S, KV, hd) in the cache dtype. ssm: ssm
        (L, B, H, P, N) f32, conv (L, B, K-1, d_in + 2 G N) in the model
        dtype. Hybrid: k/v per period (np, ...), ssm and conv per mamba
        layer (np, per - 1, ...). All: pos (B,) int64, one write position
        per slot."""
        return {k: CacheSpec(*v)
                for k, v in tf.cache_shapes(self.cfg, B, S).items()}

    def empty_cache(self, B: int, S: int, device) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                for k, s in self.cache_specs(B, S).items()}


def make_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
