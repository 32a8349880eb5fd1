"""Parameter-server primitives (paper §Parameter Server) on a
``torch.distributed`` mesh: the counterpart of ``repro.core.ps``.

The model is flattened and chunked over the mesh's ``data`` dim, so the
learners are the servers:

    push  = reduce-scatter   (partitions meet at their owner)
    aggregate+update         (runs where the shard lives)
    pull  = all-gather       (updated partitions return to all learners)

moving 2·(L−1)/L·|model| bytes per learner, the paper's O(L) scheme. The
``broadcast`` mode is the O(L²) strawman the paper argues against (every
learner all-gathers every other learner's full vector), kept so that the
two can be counted (``analysis.roofline.ProgramCounter``).

Every primitive has a local path (a leading learner axis on one device)
and a mesh path with the same math:

  * local: ``vstack`` is (L, F), ``center`` (F,), the optimizer state
    (F,) per leaf;
  * mesh (``PSContext.use_mesh``): each rank is one learner. It holds its
    own row (1, F), its own center shard (F/L,) and the optimizer-state
    leaves with ``ndim > 0`` sharded like the center; scalars (``step``)
    are replicated. The collectives are the functional ones over
    ``mesh.get_group("data")`` (gloo on the CPU, NCCL on the card).

The server update is ``ServerUpdate``: the mean over its rows, then one
step of an elementwise optimizer, in place. Where the configuration is
one that K1 computes (``kernels.ops.ps_aggregate``: sgd, momentum, and
AdamW without weight decay) it is K1, the hand-written kernel on CUDA
tensors and its plain version on CPU tensors; any other elementwise
configuration (AdamW with weight decay) takes ``optim.optimizers.
flat_update``, the port's counterpart of the reference's jnp update. The
choice is made by configuration, never by failure. The reference passes
an ``update_fn(p, g, s)`` of the mean; K1 takes the rows and computes the
mean itself, so the port's update takes the rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import wait
from repro_torch.optim.optimizers import OptConfig, flat_update


@dataclass(frozen=True)
class PSContext:
    mesh: Optional[object]        # torch DeviceMesh or None
    n_learners: int
    axis: str = "data"

    @property
    def use_mesh(self) -> bool:
        return self.mesh is not None and self.n_learners > 1

    @property
    def group(self):
        """The functional collectives' group: (mesh, index of ``axis``)."""
        return (self.mesh, list(self.mesh.mesh_dim_names).index(self.axis))

    @property
    def rank(self) -> int:
        """This rank's learner index: its coordinate along ``axis``."""
        return self.mesh.get_local_rank(self.axis)


def shard_len(n_flat: int, n_learners: int) -> int:
    if n_flat % n_learners:
        raise ValueError(f"{n_flat} values do not split over "
                         f"{n_learners} learners")
    return n_flat // n_learners


# ---------------------------------------------------------------------------
# collectives over the learner axis
# ---------------------------------------------------------------------------


def all_gather(x, ctx: PSContext):
    """Every rank's ``x`` concatenated on dim 0, in rank order."""
    import torch.distributed._functional_collectives as funcol
    return wait(funcol.all_gather_tensor(x.contiguous(), 0, ctx.group))


def reduce_scatter(x, ctx: PSContext):
    """The sum over ranks of ``x``, this rank's 1/L of it along dim 0."""
    import torch.distributed._functional_collectives as funcol
    return wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", 0,
                                             ctx.group))


def all_to_all(x, ctx: PSContext):
    """Row block i of ``x`` (L, ...) to rank i; block j of the result
    from rank j."""
    import torch.distributed._functional_collectives as funcol
    return wait(funcol.all_to_all_single(x.contiguous(), None, None,
                                         ctx.group))


def all_reduce(x, ctx: PSContext):
    """The sum over ranks of ``x``."""
    import torch.distributed._functional_collectives as funcol
    return wait(funcol.all_reduce(x, "sum", ctx.group))


# ---------------------------------------------------------------------------
# the server update
# ---------------------------------------------------------------------------


class ServerUpdate:
    """``update(params, rows, state) -> (params, state)``: the mean of
    ``rows`` (R, F) in f32, then one step of ``cfg`` on ``params`` (F,)
    f32 and the state (``flat_init``'s), in place. K1 where it computes
    ``cfg`` (``uses_k1``), else ``flat_update``."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg
        self.uses_k1 = (cfg.name in ("sgd", "momentum")
                        or (cfg.name == "adamw" and cfg.weight_decay == 0))

    def __call__(self, params, rows, state: Dict):
        cfg = self.cfg
        step = state["step"] + 1
        if not self.uses_k1:
            new, st = flat_update(cfg, params, rows.float().mean(dim=0),
                                  state)
            params.copy_(new)
            for k in ("m", "v"):
                if k in st:
                    state[k].copy_(st[k])
            state["step"] = step
            return params, state
        m = state.get("m", params)
        v = state.get("v", params)
        solver = {"sgd": "sgd", "momentum": "momentum",
                  "adamw": "adam"}[cfg.name]
        ops.ps_aggregate(rows, params, m, v, int(step), solver=solver,
                         lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                         momentum=cfg.momentum)
        state["step"] = step
        return params, state


def _aggregate(rows, params, solver: str, beta: float = 0.9):
    """K1's ``average`` (params = mean of rows) or ``easgd_center``
    (params += beta * mean of rows), in place on ``params``."""
    ops.ps_aggregate(rows, params, params, params, 1, solver=solver,
                     beta=beta)
    return params


# ---------------------------------------------------------------------------
# pull: sharded center -> full params everywhere
# ---------------------------------------------------------------------------


def pull(center, ctx: PSContext):
    """center: (F,) [mesh: this rank's (F/L,) shard] -> (F,). Local: a
    view of ``center``."""
    if not ctx.use_mesh:
        return center.reshape(-1)
    return all_gather(center, ctx)


# ---------------------------------------------------------------------------
# push (mean aggregation): per-learner vectors -> mean on every learner
# ---------------------------------------------------------------------------


def push_mean(vstack, mode: str, ctx: PSContext):
    """vstack (L, F) [mesh: (1, F)] per learner -> the (F,) mean on every
    learner, via PS (reduce-scatter / L, all-gather) or broadcast
    (all-gather of every full vector, then the mean). Local: K1's
    ``average``."""
    if not ctx.use_mesh:
        out = torch.empty(vstack.shape[1], dtype=torch.float32,
                          device=vstack.device)
        return _aggregate(vstack.float(), out, "average")
    if mode == "ps":
        chunk = reduce_scatter(vstack[0].float(), ctx) / ctx.n_learners
        return all_gather(chunk, ctx)
    return all_gather(vstack.float(), ctx).mean(dim=0)


# ---------------------------------------------------------------------------
# push + server update + pull (PSGD-style: the optimizer runs on the owner)
# ---------------------------------------------------------------------------


def push_update_pull(gstack, center, opt_state, update: ServerUpdate,
                     mode: str, ctx: PSContext):
    """gstack (L, F) [mesh: (1, F)] gradients; center (F,) [mesh: the
    rank's shard]; ``update`` a ``ServerUpdate``. Updates center and
    state in place; returns (center, state, full params (F,)).

    Mesh, ``ps``: reduce-scatter, the update of the owner's chunk (one
    row: its mean over learners), all-gather. Mesh, ``broadcast``: the
    all-gathered mean; each rank updates its own shard with its chunk of
    it (the reference updates a replicated center redundantly: same
    numbers), then the all-gather."""
    if not ctx.use_mesh:
        update(center.reshape(-1), gstack, opt_state)
        return center, opt_state, center.reshape(-1)
    if mode == "ps":
        chunk = reduce_scatter(gstack[0].float(), ctx) / ctx.n_learners
    else:
        c = center.numel()
        g = push_mean(gstack, "broadcast", ctx)
        chunk = g[ctx.rank * c:(ctx.rank + 1) * c]
    update(center, chunk[None], opt_state)
    return center, opt_state, all_gather(center, ctx)


# ---------------------------------------------------------------------------
# Downpour: sequential arrival-order application at the shard owner
# ---------------------------------------------------------------------------


def _staleness(prefixes):
    """Sum of |last arrival's prefix - first's| over the columns held."""
    return (prefixes[-1] - prefixes[0]).abs().sum()


def downpour_round(gstack, center, opt_state, update: ServerUpdate,
                   ctx: PSContext):
    """Async-PS simulation: each learner's accumulated gradient is applied
    sequentially at the PS (arrival order = learner index), one update
    per arrival; each learner pulls the params as of its own arrival
    prefix. Updates center and state in place; returns (center, state,
    prefixes, staleness): prefixes (L, F) locally, on the mesh this
    rank's (1, F); staleness the mean |last prefix - first prefix| over
    the F values, the solver's metric, which the reference computes from
    the global prefixes (on the mesh each owner sums its chunk and the
    sums are all-reduced: no rank holds both prefixes).

    Mesh: each rank chunks its (1, F) row by owner, ``all_to_all`` brings
    every learner's chunk of the rank's range (L, C), the updates run in
    learner order on the rank's shard, and a second ``all_to_all``
    returns row i of the (L, C) prefixes to learner i."""
    nl = ctx.n_learners
    if not ctx.use_mesh:
        flat = center.reshape(-1)
        prefixes = torch.empty(gstack.shape, dtype=torch.float32,
                               device=flat.device)
        for i in range(gstack.shape[0]):
            update(flat, gstack[i:i + 1], opt_state)
            prefixes[i].copy_(flat)
        return (center, opt_state, prefixes,
                _staleness(prefixes) / flat.numel())
    recv = all_to_all(gstack[0].float().reshape(nl, -1), ctx)   # (L, C)
    prefixes = torch.empty_like(recv)
    for i in range(nl):
        update(center, recv[i:i + 1], opt_state)
        prefixes[i].copy_(center)
    mine = all_to_all(prefixes, ctx).reshape(1, -1)             # (1, F)
    return (center, opt_state, mine,
            all_reduce(_staleness(prefixes), ctx) / mine.numel())
