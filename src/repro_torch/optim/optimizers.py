"""Optimizers: tree-based (AdamW, Adafactor, SGD-momentum, SGD) for the
model-level train step, and flat elementwise variants for a parameter-
server shard: the counterpart of ``repro.optim.optimizers``.

Parameters are plain tensors in the port's nested-dict param tree.
``apply_updates`` runs under ``torch.no_grad()`` and writes each param and
each state leaf in place (JAX returns new, donated buffers); the
arithmetic is the reference's: f32, cast back to the param dtype. The
step count is a 0-d int32 tensor on the params' device, so a step makes
no host sync. ``abstract_opt_state`` is the state on meta params, and
``opt_state_specs`` its layout on a mesh (the reference's,
``optimizers.py:76-111``): each state leaf takes its param's spec, and
Adafactor's factored stats the spec of the param's dims without the
last (``vr``) or the second-to-last (``vc``).

On a mesh ``apply_updates`` runs on each rank's local shards, with
``shards``, a tree of ``LeafShards`` beside the params
(``distributed/steps.py`` builds it). SGD, momentum and AdamW are
elementwise and do not read it. Adafactor's row and column means, the
mean of its row factor and its update-clip RMS reduce over dims that a
mesh may shard: there each sums its local part, all-reduces it over the
ranks that hold the other parts and divides by the whole dim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import iter_leaves, map_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor | momentum | sgd
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    # adafactor
    decay: float = 0.8
    min_dim_factored: int = 128
    state_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Tree optimizers
# ---------------------------------------------------------------------------


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def _factored(cfg: OptConfig, shape) -> bool:
    """Adafactor keeps row and column statistics of a leaf whose last two
    dims are both at least ``min_dim_factored`` (``optimizers.py:58-67``)."""
    return (_factored_dims(shape) is not None
            and min(shape[-2:]) >= cfg.min_dim_factored)


def _step0(params):
    dev = next(t for _, t in iter_leaves(params)).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def init_opt_state(cfg: OptConfig, params) -> Dict[str, Any]:
    """Zero state of ``cfg.name`` for ``params``, on their device (meta
    params give the abstract state)."""
    sd = DTYPES[cfg.state_dtype]

    def zeros(shape_of):
        return map_leaves(lambda _p, t: torch.zeros(
            shape_of(t.shape), dtype=sd, device=t.device), params)
    same = lambda s: tuple(s)                              # noqa: E731
    if cfg.name == "sgd":
        return {"step": _step0(params)}
    if cfg.name == "momentum":
        return {"step": _step0(params), "m": zeros(same)}
    if cfg.name == "adamw":
        return {"step": _step0(params), "m": zeros(same), "v": zeros(same)}
    if cfg.name == "adafactor":
        def vr(s):                          # row stats, or the full second
            return tuple(s[:-1]) if _factored(cfg, s) else tuple(s)

        def vc(s):                          # column stats; (0,) unused
            return tuple(s[:-2]) + tuple(s[-1:]) if _factored(cfg, s) \
                else (0,)
        return {"step": _step0(params), "vr": zeros(vr), "vc": zeros(vc)}
    raise ValueError(cfg.name)


def abstract_opt_state(cfg: OptConfig, abstract_params):
    """The state of ``cfg.name`` for params on the meta device: shapes
    and dtypes, no data (the reference's ``jax.eval_shape``)."""
    return init_opt_state(cfg, abstract_params)


def opt_state_specs(cfg: OptConfig, param_defs, dist):
    """PartitionSpecs of the optimizer state, derived from the param defs
    so that Adafactor's factored stats get specs of their own shapes; the
    ``vc`` of an unfactored leaf, a (0,) marker, gets ``P()``."""
    from repro_torch.distributed.sharding import P, spec_for
    scalar = P()

    def full():
        return map_leaves(lambda _p, d: spec_for(dist, d.dims, d.shape),
                          param_defs)
    if cfg.name == "sgd":
        return {"step": scalar}
    if cfg.name == "momentum":
        return {"step": scalar, "m": full()}
    if cfg.name == "adamw":
        return {"step": scalar, "m": full(), "v": full()}
    if cfg.name == "adafactor":
        def fac(d, which: str):
            if not _factored(cfg, d.shape):
                if which == "vr":
                    return spec_for(dist, d.dims, d.shape)
                return P()           # vc is a (0,) marker
            if which == "vr":
                return spec_for(dist, d.dims[:-1], d.shape[:-1])
            return spec_for(dist, d.dims[:-2] + d.dims[-1:],
                            d.shape[:-2] + d.shape[-1:])
        return {"step": scalar,
                "vr": map_leaves(lambda _p, d: fac(d, "vr"), param_defs),
                "vc": map_leaves(lambda _p, d: fac(d, "vc"), param_defs)}
    raise ValueError(cfg.name)


class LeafShards:
    """The whole leaf on one device: Adafactor's means are
    ``torch.mean``. ``distributed/steps.py`` subclasses it for a shard
    on a mesh, whose means all-reduce."""

    def mean(self, t, dim: int, pdim: int):
        """``t`` averaged over its ``dim``, which is param dim ``pdim``."""
        return torch.mean(t, dim=dim)

    def mean_all(self, t):
        """The mean of ``t``, a tensor of the leaf's shape."""
        return torch.mean(t)

    def vc_in(self, vc):
        """The column stats at this shard's columns, from the ``vc``
        state's own local shard."""
        return vc

    def vc_out(self, vc):
        """The ``vc`` state's local shard from the column stats at this
        shard's columns."""
        return vc


WHOLE = LeafShards()


def _zip(*trees):
    """Leaves of same-shaped trees, side by side, in flatten order."""
    return zip(*[[t for _, t in iter_leaves(tr)] for tr in trees])


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state, shards=None):
    """One optimizer step, in place on ``params`` and ``state``; returns
    (params, state) as the reference returns (new_params, new_state).
    On a mesh the trees hold local shards and ``shards`` is a tree of
    ``LeafShards`` beside the params (read by Adafactor only)."""
    step = state["step"] + 1
    lr = cfg.lr

    if cfg.name == "sgd":
        for p, g in _zip(params, grads):
            p.copy_(p.float().sub_(g.float(), alpha=lr))
        return params, {"step": step}

    if cfg.name == "momentum":
        for p, g, m in _zip(params, grads, state["m"]):
            m.mul_(cfg.momentum).add_(g.to(m.dtype))
            p.copy_(p.float().sub_(m, alpha=lr))
        return params, {"step": step, "m": state["m"]}

    if cfg.name == "adamw":
        sf = step.float()
        bc1 = 1 - torch.pow(cfg.b1, sf)
        bc2 = 1 - torch.pow(cfg.b2, sf)
        for p, g, m, v in _zip(params, grads, state["m"], state["v"]):
            # the reference's expressions, each pass in place where the
            # order of its roundings allows (one transient of the leaf
            # in f32 besides the update)
            g = g.to(m.dtype)
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            pf = p.float()
            if cfg.weight_decay:
                upd.add_(pf, alpha=cfg.weight_decay)
            p.copy_(pf.sub_(upd, alpha=lr))
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    if cfg.name == "adafactor":
        beta = 1 - torch.pow(step.float(), -cfg.decay)
        leaves = ([WHOLE] * len(list(iter_leaves(params))) if shards is None
                  else [t for _, t in iter_leaves(shards)])
        for (p, g, vr, vc), sh in zip(
                _zip(params, grads, state["vr"], state["vc"]), leaves):
            g = g.float()
            g2 = g * g + 1e-30
            nd = g.dim()
            if vc.numel() > 0 and vr.dim() != p.dim():
                vr.copy_(beta * vr + (1 - beta) * sh.mean(g2, -1, nd - 1))
                cols = beta * sh.vc_in(vc) \
                    + (1 - beta) * sh.mean(g2, -2, nd - 2)
                vc.copy_(sh.vc_out(cols))
                rfac = vr / sh.mean(vr, -1, nd - 2)[..., None]
                prec = rfac[..., None] * cols[..., None, :]
            else:
                vr.copy_(beta * vr + (1 - beta) * g2)
                prec = vr
            u = g * torch.rsqrt(prec + 1e-30)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(sh.mean_all(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            pf = p.float() - lr * u
            if cfg.weight_decay:
                pf = pf - lr * cfg.weight_decay * p.float()
            p.copy_(pf)
        return params, {"step": step, "vr": state["vr"], "vc": state["vc"]}

    raise ValueError(cfg.name)


# ---------------------------------------------------------------------------
# Flat (parameter-server shard) optimizers — elementwise only
# ---------------------------------------------------------------------------


def flat_init(cfg: OptConfig, n: int, device=None):
    """State of an elementwise optimizer for a flat shard of ``n``."""
    step = torch.zeros((), dtype=torch.int32, device=device)
    z = lambda: torch.zeros(n, dtype=torch.float32,         # noqa: E731
                            device=device)
    if cfg.name == "sgd":
        return {"step": step}
    if cfg.name == "momentum":
        return {"step": step, "m": z()}
    if cfg.name == "adamw":
        return {"step": step, "m": z(), "v": z()}
    raise ValueError(f"PS-shard path needs an elementwise optimizer, "
                     f"got {cfg.name}")


@torch.no_grad()
def flat_update(cfg: OptConfig, flat_p, flat_g, state):
    """Elementwise update of a flat shard; returns (new params in
    ``flat_p``'s dtype, new state), as the reference (nothing in place)."""
    step = state["step"] + 1
    g = flat_g.float()
    p = flat_p.float()
    if cfg.name == "sgd":
        return (p - cfg.lr * g).to(flat_p.dtype), {"step": step}
    if cfg.name == "momentum":
        m = cfg.momentum * state["m"] + g
        return (p - cfg.lr * m).to(flat_p.dtype), {"step": step, "m": m}
    if cfg.name == "adamw":
        sf = step.float()
        bc1 = 1 - torch.pow(cfg.b1, sf)
        bc2 = 1 - torch.pow(cfg.b2, sf)
        m = cfg.b1 * state["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"] + (1 - cfg.b2) * g * g
        p = p - cfg.lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                          + cfg.weight_decay * p)
        return p.to(flat_p.dtype), {"step": step, "m": m, "v": v}
    raise ValueError(cfg.name)
