"""Weights carried across between ``repro`` and the port.

The flat f32 vector is the format the two packages share: the learner's
state, the PS wire, and the ``trained_model.npy`` a training uploads. Its
order is that of JAX's ``_flat_io`` (runtime/learner.py:45-66), which
comes from ``jax.tree.flatten`` of the param tree: dict keys sorted,
depth first, each layer's weights stacked on a leading ``L`` dimension:

    blocks/attn/{bk,bq,bv,wk,wo,wq,wv}, blocks/ln1/w, blocks/ln2/w,
    blocks/mlp/{wd,wg,wu}, embed, final_norm/w, head

for the moe family ``blocks/moe/{router,wd,wg,wu}`` in place of
``blocks/mlp`` (router (L, D, E), wg/wu (L, E, D, Fe), wd (L, E, Fe, D)),

and for the ssm family (upper case sorts first, as in JAX):

    blocks/ln1/w, blocks/mamba/{A_log, D_skip, conv_B, conv_C, conv_x,
    dt_bias, norm, out_proj, wB, wC, wdt, wx, wz}, embed, final_norm/w,
    head

and for the hybrid family, stacked per period (np = n_layers //
attn_period, per = attn_period):

    blocks/attn/{wk,wo,wq,wv} (np, ...), blocks/attn_ln/w (np, D),
    blocks/ffn_ln/w (np, per, D), blocks/mamba/{...} (np, per - 1, ...),
    blocks/mamba_ln/w (np, per - 1, D), blocks/mlp/{wd,wg,wu}
    (np, per - per // 2, ...), blocks/moe/{router,wd,wg,wu}
    (np, per // 2, ...), embed, final_norm/w, head

and for the encdec family (LayerNorm: bias ``b`` before weight ``w``):

    dec_blocks/{cross_attn/{wk,wo,wq,wv}, ln1/{b,w}, ln2/{b,w},
    ln3/{b,w}, mlp/{wd,wg,wu}, self_attn/{wk,wo,wq,wv}}, embed,
    enc_blocks/{attn/{wk,wo,wq,wv}, ln1/{b,w}, ln2/{b,w},
    mlp/{wd,wg,wu}}, enc_norm/{b,w}, final_norm/{b,w}, head
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import iter_leaves, map_leaves
from repro_torch.models.model import make_model


def flat_layout(cfg: ArchConfig) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(path, shape, offset) of every leaf, in flat-vector order."""
    out = []
    off = 0
    for path, d in iter_leaves(make_model(cfg).param_defs()):
        out.append((path, tuple(d.shape), off))
        off += int(np.prod(d.shape, dtype=np.int64))
    return out


def flat_size(cfg: ArchConfig) -> int:
    path, shape, off = flat_layout(cfg)[-1]
    return off + int(np.prod(shape, dtype=np.int64))


def params_from_flat(flat, cfg: ArchConfig,
                     device: DeviceLike = None) -> Dict:
    """Param tree in the model dtype on ``device`` from a flat f32 vector
    (e.g. ``trained_model.npy``)."""
    dev = resolve_device(device)
    flat = np.array(flat, dtype=np.float32, copy=True).reshape(-1)
    size = flat_size(cfg)
    if flat.size != size:
        raise ValueError(f"flat vector has {flat.size} values; arch "
                         f"{cfg.arch_id!r} has {size} params")
    model = make_model(cfg)
    offsets = {path: off for path, _, off in flat_layout(cfg)}

    def leaf(path, d):
        n = int(np.prod(d.shape, dtype=np.int64))
        t = torch.from_numpy(flat[offsets[path]:offsets[path] + n])
        return t.reshape(d.shape).to(device=dev, dtype=model.dtype)

    return map_leaves(leaf, model.param_defs())


_DTYPES = {"float32": torch.float32,
           "bfloat16": torch.bfloat16}     # ml_dtypes.bfloat16 from JAX


def params_from_jax(tree, device: DeviceLike = None) -> Dict:
    """Param tree from ``jax.tree.map(np.asarray, params)`` (nested dicts
    of numpy arrays), each leaf keeping its dtype."""
    dev = resolve_device(device)

    def conv(_path, arr):
        arr = np.asarray(arr)
        dt = _DTYPES[str(arr.dtype)]
        # torch.from_numpy knows no bfloat16: widen (exactly) and narrow
        t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=dt)

    return map_leaves(conv, tree)


def flat_from_params(params) -> np.ndarray:
    """The flat f32 vector of a param tree (inverse of params_from_flat)."""
    return np.concatenate([
        t.detach().to("cpu", torch.float32).reshape(-1).numpy()
        for _, t in iter_leaves(params)])
