"""Step builders: train / prefill / decode of a ``Model``, the single-card
part of ``repro.distributed.steps``.

These are the model-level entry points: the only way the reference
trains and runs its stub-frontend families (whisper's encoder-decoder,
the vlm family's ``embeds``), which its learner, trainer and serving
engine refuse. The train step takes the model's loss and its gradient
(autograd through the port's kernels: K4 and K4b for attention) and one
``optim.optimizers.apply_updates`` in place. There is no mesh: the
gradient pinning ``_constrain_grads``, ``_ns`` and the ``jit_*_step``
wrappers with their shardings wait for the port's distributed trainer.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.layers import iter_leaves, map_leaves
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state)


def default_optimizer(cfg: ArchConfig) -> OptConfig:
    """Adafactor for huge models (factored stats), AdamW otherwise."""
    if cfg.n_params() > 30e9:
        return OptConfig(name="adafactor", lr=1e-3)
    return OptConfig(name="adamw", lr=1e-3)


def expert_grad_tie(cfg: ArchConfig, model: Model):
    """Gradient-tying transform for replicated ('virtual') MoE experts:
    the identity here. The reference replicates each expert R times when
    there are fewer experts than model-axis shards and averages the
    copies' gradients; with no mesh every expert lives once on the one
    card (``replication_factor`` is 1), so there is nothing to tie."""
    return lambda g: g


# top-level keys whose leaves stack the layers on their leading dim
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def value_and_grad(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at ``params``: the loss a detached
    0-d f32 tensor, the gradients a tree like ``params`` in the params'
    dtypes. The params are not modified and need no ``requires_grad``.
    Layer-stacked weights enter the loss as per-layer lists (as the
    learner's ``_param_leaves`` does), so autograd hands back one
    gradient per layer, stacked once here, where differentiating the
    ``(L, ...)`` tensors would scatter every layer's gradient into a
    full-size zero tensor and add them: L^2 / 2 leaf-sized passes."""
    def live(path, t):
        if path.split("/")[0] in STACKED:
            return [t[l].detach().requires_grad_() for l in
                    range(t.shape[0])]
        return t.detach().requires_grad_()
    with torch.enable_grad():
        tree = map_leaves(live, params)
        groups = [v if isinstance(v, list) else [v]
                  for _, v in iter_leaves(tree)]
        loss = model.loss(tree, batch)
        flat = torch.autograd.grad(loss, [t for g in groups for t in g],
                                   allow_unused=True)
    # a leaf the loss does not read (the token table under ``embeds``)
    # gets zeros, as JAX's gradient
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip([t for g in groups for t in g], flat))

    def grad(_path, v):
        if isinstance(v, list):
            return torch.stack([next(it) for _ in v])
        return next(it)
    return loss.detach(), map_leaves(grad, tree)


def split_batch(batch: Dict[str, torch.Tensor], n: int):
    """``n`` micro-batches of ``batch``, each 1/n of its rows. M-RoPE
    ``positions`` (3, B, S) split on their batch dim 1; the reference
    splits every leaf on dim 0 (``steps.py:83-85``), which cuts the
    three position rows instead (see ROADMAP Queue 3)."""
    def split(key, x):
        dim = 1 if key == "positions" else 0
        if x.shape[dim] % n:
            raise ValueError(f"{key}: batch {x.shape[dim]} is not a "
                             f"multiple of grad_accum {n}")
        return x.chunk(n, dim=dim)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def build_train_step(model: Model, opt_cfg: OptConfig, grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    loss). With ``grad_accum`` > 1 the batch is cut into that many
    micro-batches; their losses and f32 gradients are summed and divided
    by ``grad_accum``, as the reference's scan does. Params and state are
    updated in place (and returned)."""
    tie = expert_grad_tie(model.cfg, model)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            loss = None
            grads = map_leaves(lambda _p, t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), params)
            for mb in split_batch(batch, grad_accum):
                l, g = value_and_grad(model, params, mb)
                loss = l if loss is None else loss + l
                for acc, gi in zip([t for _, t in iter_leaves(grads)],
                                   [t for _, t in iter_leaves(g)]):
                    acc.add_(gi)
                del g
            loss = loss / grad_accum
            for _, acc in iter_leaves(grads):
                acc.div_(grad_accum)
        grads = tie(grads)
        params, state = apply_updates(opt_cfg, params, grads, opt_state)
        return params, state, loss

    return train_step


def build_prefill_step(model: Model):
    """prefill_step(params, batch, cache=None, slots=None) -> (logits,
    cache) under no_grad: ``Model.prefill``, into a new cache or into
    ``slots`` of a batched one."""
    @torch.no_grad()
    def prefill_step(params, batch, *, cache=None, slots=None):
        return model.prefill(params, batch, cache=cache, slots=slots)
    return prefill_step


def build_decode_step(model: Model):
    """decode_step(params, cache, batch) -> (logits, cache) under
    no_grad; the cache is updated in place."""
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch)
    return decode_step


def abstract_inputs(model: Model, shape: ShapeSpec,
                    opt_cfg: Optional[OptConfig] = None):
    """The arguments of the step of ``shape.kind`` as empty tensors on the
    meta device (the reference's ShapeDtypeStructs): (params, opt_state,
    batch) for train, (params, batch) for prefill, (params, cache, batch)
    for decode against a ``shape.seq_len`` cache (encdec: the cross
    cache as long, as the reference's ``cache_specs``)."""
    aps = model.abstract_params()

    def meta(specs):
        return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                for k, s in specs.items()}
    batch = meta(model.input_specs(shape))
    if shape.kind == "train":
        oc = opt_cfg or default_optimizer(model.cfg)
        return (aps, init_opt_state(oc, aps), batch)
    if shape.kind == "prefill":
        return (aps, batch)
    return (aps, meta(model.cache_specs(shape.global_batch, shape.seq_len)),
            batch)
