"""DLaaS optimization solvers (paper §Parameter Server): the counterpart
of ``repro.core.solvers``.

The paper's PS offers PSGD, elastic averaging SGD and model averaging,
with aggregation triggers from BSP to Downpour. All four run over the
push/pull primitives of ``core/ps.py``:

  psgd      BSP synchronous SGD: push grads every step, server update,
            pull. (comm_every forced to 1.)
  modelavg  H local steps, then weight averaging.
  easgd     H local steps, elastic force toward/from the center.
  downpour  H local steps accumulating grads; the server applies each
            learner's push in arrival order, learners pull their
            arrival-prefix params (staleness-faithful simulation).

One ``round`` = H local microsteps + one sync. The state dict is the
reference's (``center``, ``local``, ``opt``, ``err``, ``round``) over a
flat f32 vector: the tree raveled in ``jax.tree.leaves`` order (dict keys
sorted, ``models.layers.iter_leaves``), padded to a multiple of
``BLOCK * n_learners``; for an LM it is ``LMPlugin.flat_state``'s vector,
padded.

Differences from the reference, by design:
  * ``round`` updates the state's tensors in place and returns the new
    state dict (the reference returns new arrays); a state passed to
    ``round`` is consumed;
  * the learner axis is a loop (``jax.vmap`` of the gradient, and the
    ``lax.scan`` of the microsteps, give the same numbers): each learner's
    gradient is one forward and backward of ``loss_fn`` through autograd,
    which carries the port's kernels (K4/K4b for attention). PSGD takes
    every learner's gradient at the one pulled vector without tiling it;
  * the gradient is taken per leaf and written into a flat f32 vector;
    a leaf for which the caller's ``per_layer(path)`` holds enters
    ``loss_fn`` as the list of its leading-dim slices (an LM's stacked
    blocks, ``models.layers.is_stacked``, as ``distributed.steps.
    value_and_grad`` does), so autograd hands back one gradient per
    layer; by default every leaf enters as one tensor;
  * on the card the int8 push is K2 then K3 (``kernels.ops.quantize_ef``,
    ``dequantize``: the function of ``compress_with_feedback``), the
    server update K1 where it computes the configuration (``ps.
    ServerUpdate``), modelavg's mean K1 ``average`` and EASGD's center
    K1 ``easgd_center``; CPU tensors take their plain versions;
  * on a mesh each rank is learner ``ctx.rank``: it runs the same
    ``round(state, batches)`` on the global (H, L, b, ...) batches, takes
    its own learner's, and holds its own rows of ``local`` / ``err`` (1,
    F) and its shard of ``center`` and ``opt``; the loss, ``divergence``
    and ``staleness`` are the reference's means, reduced over "data".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import ps
from repro_torch.core.compression import BLOCK, pad_to_block, wire_bytes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import iter_leaves
from repro_torch.optim.optimizers import OptConfig, flat_init

@dataclass(frozen=True)
class SolverConfig:
    name: str = "psgd"            # psgd | modelavg | easgd | downpour
    comm_every: int = 1           # H: paper's communication-frequency thresh
    push_mode: str = "ps"         # ps (reduce-scatter) | broadcast (O(L^2))
    compress: bool = False        # int8 push compression w/ error feedback
    local_lr: float = 0.1         # lr for local steps (modelavg/easgd/downpour)
    easgd_alpha: float = 0.1      # elastic force on learners
    easgd_beta: float = 0.9       # center pull strength (beta/NL per learner)

    @property
    def rounds_h(self) -> int:
        return 1 if self.name == "psgd" else self.comm_every


def _set(tree: Dict, path: str, val) -> None:
    *parents, last = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = val


class Solver:
    """One solver over a flat f32 vector; ``round(state, batches)`` runs
    H local microsteps and one sync.

    state = {
      center: (F,) flat params [mesh: this rank's (F/L,) shard],
      local:  (L, F) learner-local params (easgd only) [mesh: (1, F)],
      opt:    flat optimizer state (psgd/downpour server updates),
      err:    (L, F) error-feedback buffers (compress only) [mesh: (1, F)],
      round:  0-d int32,
    }
    """

    def __init__(self, loss_fn: Callable, params_template,
                 opt_cfg: OptConfig, scfg: SolverConfig, n_learners: int,
                 mesh=None, device: DeviceLike = None,
                 per_layer: Optional[Callable[[str], bool]] = None):
        self.scfg = scfg
        self._per_layer = per_layer or (lambda _path: False)
        self.opt_cfg = opt_cfg
        self.n_learners = n_learners
        self.ctx = ps.PSContext(mesh=mesh, n_learners=n_learners)
        if mesh is not None and device is None:
            device = mesh.device_type
        self.device = resolve_device(device)
        if self.ctx.use_mesh and mesh.size(self.ctx.group[1]) != n_learners:
            raise ValueError(f"{n_learners} learners on a mesh whose "
                             f"'data' dim has {mesh.size(self.ctx.group[1])}"
                             " ranks")
        self._layout = []
        off = 0
        for path, t in iter_leaves(params_template):
            n = int(np.prod(tuple(t.shape), dtype=np.int64))
            self._layout.append((path, tuple(t.shape), off, n))
            off += n
        self.true_size = off
        self.padded = max(pad_to_block(self.true_size, BLOCK * n_learners),
                          BLOCK * n_learners)
        self.update = ps.ServerUpdate(opt_cfg)
        self._loss_fn = loss_fn

    # ---- flat vector <-> tree ----------------------------------------------
    def ravel(self, params) -> torch.Tensor:
        """The padded flat f32 vector of a tree on the solver's device."""
        flat = torch.zeros(self.padded, dtype=torch.float32,
                           device=self.device)
        for (path, shape, off, n), (p2, t) in zip(self._layout,
                                                  iter_leaves(params)):
            assert path == p2, (path, p2)
            flat[off:off + n].copy_(t.reshape(-1))
        return flat

    def unravel(self, flat) -> Dict:
        """The tree of views of ``flat`` (f32, the template's shapes)."""
        tree: Dict = {}
        for path, shape, off, n in self._layout:
            _set(tree, path, flat[off:off + n].view(shape))
        return tree

    def value_and_grad(self, flat, batch):
        """(loss, gradient): ``loss_fn`` at ``unravel(flat)`` on ``batch``
        as a detached 0-d f32 tensor, and its gradient as a padded flat
        f32 vector. Each leaf enters the loss as its own tensor (one that
        ``per_layer`` names as the list of its leading-dim slices), so
        autograd hands back one gradient per tensor; they are written
        into the flat vector."""
        tree: Dict = {}
        leaves = []
        for path, shape, off, n in self._layout:
            src = flat[off:off + n].view(shape)
            if self._per_layer(path) and len(shape) > 0:
                per = n // shape[0]
                val = [src[l].detach().requires_grad_()
                       for l in range(shape[0])]
                leaves += [(t, off + l * per) for l, t in enumerate(val)]
            else:
                val = src.detach().requires_grad_()
                leaves.append((val, off))
            _set(tree, path, val)
        with torch.enable_grad():
            loss = self._loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, [t for t, _ in leaves],
                                        allow_unused=True)
        g = torch.zeros(self.padded, dtype=torch.float32,
                        device=flat.device)
        for (t, off), gi in zip(leaves, grads):
            if gi is not None:
                g[off:off + t.numel()].copy_(gi.reshape(-1))
        return loss.detach().float(), g

    # ---- state --------------------------------------------------------------
    def _rows(self) -> int:
        """Learner rows this process holds: L locally, 1 on a mesh."""
        return 1 if self.ctx.use_mesh else self.n_learners

    def init_state(self, params) -> Dict[str, Any]:
        flat = self.ravel(params)
        ctx = self.ctx
        center = self._scatter_like(flat, ctx)
        n = center.numel()
        s: Dict[str, Any] = {"center": center,
                             "round": torch.zeros((), dtype=torch.int32,
                                                  device=self.device)}
        if self.scfg.name in ("psgd", "downpour"):
            s["opt"] = flat_init(self.opt_cfg, n, self.device)
        if self.scfg.name == "easgd":
            s["local"] = flat[None].repeat(self._rows(), 1)
        if self.scfg.compress:
            s["err"] = torch.zeros((self._rows(), self.padded),
                                   dtype=torch.float32, device=self.device)
        return s

    def params_of(self, state) -> Any:
        """The center's tree (copies; on a mesh gathered on every rank)."""
        full = ps.pull(state["center"], self.ctx)
        return self.unravel(full[: self.true_size].clone())

    def _scatter_like(self, full, ctx: ps.PSContext):
        """Store a full vector into the center's (sharded) layout: this
        rank's chunk (a copy) on a mesh, the vector itself locally."""
        if not ctx.use_mesh:
            return full
        c = ps.shard_len(full.numel(), ctx.n_learners)
        return full[ctx.rank * c:(ctx.rank + 1) * c].clone()

    # ---- round --------------------------------------------------------------
    def _learners(self):
        """(row in this process's stack, learner index) pairs."""
        if self.ctx.use_mesh:
            return [(0, self.ctx.rank)]
        return [(i, i) for i in range(self.n_learners)]

    def _mean_over_learners(self, total):
        """``total``, a sum over this process's learners, over all L."""
        if self.ctx.use_mesh:
            total = ps.all_reduce(total, self.ctx)
        return total / self.n_learners

    def _local_steps(self, xs, batches, h: int, accumulate: bool):
        """H plain-SGD steps of every learner row of ``xs`` (rows, F),
        in place; returns (xs, grad sums or None, mean loss)."""
        lr = self.scfg.local_lr
        gacc = torch.zeros_like(xs) if accumulate else None
        lacc = torch.zeros((), dtype=torch.float32, device=xs.device)
        for step in range(h):
            losses = torch.zeros((), dtype=torch.float32, device=xs.device)
            for row, i in self._learners():
                mb = {k: v[step, i] for k, v in batches.items()}
                loss, g = self.value_and_grad(xs[row], mb)
                xs[row].sub_(lr * g)
                if accumulate:
                    gacc[row].add_(g)
                losses = losses + loss
                del g
            lacc = lacc + self._mean_over_learners(losses)
        return xs, gacc, lacc / h

    def _maybe_compress(self, vstack, state):
        """The int8 wire view of each row (K2, then K3 of its q and
        scales; ``err`` updated in place), or ``vstack`` itself."""
        if not self.scfg.compress:
            return vstack
        wire = torch.empty(vstack.shape, dtype=torch.float32,
                           device=vstack.device)
        err = state["err"]
        for row in range(vstack.shape[0]):
            q, scales, _ = ops.quantize_ef(vstack[row], err[row],
                                           out_err=err[row])
            ops.dequantize(q, scales, out=wire[row])
        return wire

    def round(self, state, batches):
        """batches: dict of leaves (H, L, b, ...). Returns (new state,
        metrics of 0-d tensors)."""
        scfg = self.scfg
        ctx = self.ctx
        h = scfg.rounds_h
        state["round"] = state["round"] + 1
        full = ps.pull(state["center"], ctx)

        if scfg.name == "psgd":
            grads = torch.empty((self._rows(), self.padded),
                                dtype=torch.float32, device=self.device)
            losses = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
            for row, i in self._learners():
                mb = {k: v[0, i] for k, v in batches.items()}
                loss, g = self.value_and_grad(full, mb)
                grads[row].copy_(g)
                losses = losses + loss
                del g
            loss = self._mean_over_learners(losses)
            push = self._maybe_compress(grads, state)
            del grads
            ps.push_update_pull(push, state["center"], state["opt"],
                                self.update, scfg.push_mode, ctx)
            return state, {"loss": loss}

        if scfg.name == "modelavg":
            xs = full[None].repeat(self._rows(), 1)
            xs, _, loss = self._local_steps(xs, batches, h, False)
            push = self._maybe_compress(xs, state)
            del xs
            if ctx.use_mesh:
                mean = ps.push_mean(push, scfg.push_mode, ctx)
                state["center"] = self._scatter_like(mean, ctx)
            else:
                ps._aggregate(push, state["center"], "average")
            return state, {"loss": loss}

        if scfg.name == "easgd":
            xs, _, loss = self._local_steps(state["local"], batches, h,
                                            False)
            diffs = xs - full[None]
            push = self._maybe_compress(diffs, state)
            div = self._mean_over_learners(diffs.abs().sum()) / self.padded
            xs.sub_(scfg.easgd_alpha * diffs)
            del diffs
            if ctx.use_mesh:
                mean_diff = ps.push_mean(push, scfg.push_mode, ctx)
                c = state["center"].numel()
                chunk = mean_diff[ctx.rank * c:(ctx.rank + 1) * c]
                ps._aggregate(chunk[None], state["center"], "easgd_center",
                              scfg.easgd_beta)
            else:
                ps._aggregate(push, state["center"], "easgd_center",
                              scfg.easgd_beta)
            state["local"] = xs
            return state, {"loss": loss, "divergence": div}

        if scfg.name == "downpour":
            xs = full[None].repeat(self._rows(), 1)
            xs, gacc, loss = self._local_steps(xs, batches, h, True)
            del xs
            push = self._maybe_compress(gacc, state)
            del gacc
            *_, stale = ps.downpour_round(push, state["center"],
                                          state["opt"], self.update, ctx)
            return state, {"loss": loss, "staleness": stale}

        raise ValueError(scfg.name)

    # ---- public -------------------------------------------------------------
    def wire_bytes_per_round(self) -> int:
        """Analytic bytes moved per learner per round (for the bench)."""
        f = self.padded
        nl = self.n_learners
        per_vec = wire_bytes(f) if self.scfg.compress else 4 * f
        if self.scfg.push_mode == "broadcast":
            return (nl - 1) * per_vec + (4 * f if self.scfg.name in
                                         ("psgd", "downpour") else 0)
        # ps: push RS ~ (L-1)/L * vec, pull AG ~ (L-1)/L * vec (f32)
        return int((nl - 1) / nl * (per_vec + 4 * f))


def make_solver(loss_fn, params_template, opt_cfg: OptConfig,
                scfg: SolverConfig, n_learners: int, mesh=None,
                device: DeviceLike = None,
                per_layer: Optional[Callable[[str], bool]] = None
                ) -> Solver:
    """A ``Solver`` of ``loss_fn(tree, batch)``. ``per_layer(path)``, when
    given, names the leaves that enter ``loss_fn`` as lists of their
    leading-dim slices (``models.layers.is_stacked`` for a model's
    tree); every other leaf enters as one tensor."""
    return Solver(loss_fn, params_template, opt_cfg, scfg, n_learners,
                  mesh, device, per_layer)
