"""Production trainer — the pjit execution path: the counterpart of
``repro/runtime/trainer.py`` (the paper-architecture software-PS path is
runtime/learner.py).

  * params and optimizer state laid out per distributed/sharding.py on a
    ``torch.distributed`` mesh (DTensors), or whole on one card without
    one; the step is ``distributed.steps.jit_train_step``;
  * periodic async checkpointing + restore-from-latest-valid;
  * step-retry on a transient failure (with re-restore);
  * ELASTIC restart: ``Trainer.resume(new_dist)`` checkpoints, rebuilds
    the step on another mesh (or none) and restores the same checkpoint
    with the new layout;
  * metrics emission compatible with the platform MetricsService.

Where it differs from the reference: ``init`` draws from a
``torch.Generator`` on the device (as ``Model.init``), so the weights of
a seed are the port's own; token ids are int64; a ``device`` argument
names the card (``None``: CUDA) for a mesh-less trainer, where a mesh
brings its own device type. ``opts`` are the model's options, by default
the reference's ``{"remat": "none"}``.

On a mesh every rank of it runs the same calls, each rank a process
where the reference has devices of one process: ``save`` gathers every
leaf (the rank at the mesh's first coordinate writes), ``restore`` waits
until every rank of the mesh has reached it (on the mesh's gloo side
group, ``mesh.side_group``, which ``launch.mesh`` gives every mesh it
makes), so no rank reads a checkpoint still being written. A rank that the mesh leaves out (``launch.mesh.make_mesh`` over
fewer ranks than the process group, e.g. 4 x 2 -> 2 x 2 on 8) holds
nothing after ``resume``: ``train`` returns no losses and ``step_once``
raises; it takes no part in the mesh's collectives, so it waits on none.

A failed step on a mesh of several ranks: after each attempt the ranks
agree, in one all-reduce on the side group, how many of them raised and
on how many a collective of the step failed (a ``DistError``: its wait
ran out, or a peer is gone). Where some raised and no collective
failed, every rank restores the latest valid checkpoint and retries (up
to ``max_step_retries``; with no checkpoint every rank raises). Every
wait of the step's groups and of the side group is bounded by the
process group's timeout, which is set once where the group starts
(``runtime/spmd.py``'s ``TIMEOUT`` for the pjit gang's rank processes)
and which ``make_mesh`` gives each group it makes. A rank that fails
alone leaves the others in the step's collectives until that bound runs
out; a failed collective may leave the step's groups out of step, so
then every rank raises, and the gang above restarts. On gloo (shown on
the CPU) that is within twice the bound of the failure: one wait in the
step, one in the agreement. On NCCL a collective whose wait ran out is
handled by torch's watchdog, which by default
(``TORCH_NCCL_ASYNC_ERROR_HANDLING``) ends the process rather than
raising into ``step_once``; the gang restart covers that case too, as
the rank's member sees it exit. Across NCCL ranks this is not yet run
(one card takes one NCCL rank).
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.roofline import count_program
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import steps
from repro_torch.distributed.sharding import (Dist, Sharding,
                                              contiguous_stride, distribute,
                                              mesh_axes, shard_slices)
from repro_torch.models.layers import leaf_at, map_leaves
from repro_torch.models.model import make_model
from repro_torch.optim.optimizers import (OptConfig, abstract_opt_state,
                                          init_opt_state, opt_state_specs)
from repro_torch.platform.metrics import MetricsService


@dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 25
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    max_step_retries: int = 2
    job_id: str = "train"
    # (StorageManager, store_id, prefix): object-store checkpoint mirror
    ckpt_mirror: Optional[tuple] = None


class Trainer:
    def __init__(self, cfg: ArchConfig, dist: Dist, opt: OptConfig,
                 tc: TrainerConfig, metrics: Optional[MetricsService] = None,
                 device: DeviceLike = None,
                 opts: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.opt = opt
        self.tc = tc
        self.metrics = metrics or MetricsService()
        self._device = device
        self.opts = opts or {"remat": "none"}
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=3,
                                      mirror=tc.ckpt_mirror)
        self.step = 0
        self._build(dist)

    # ---- build / rebuild (elastic) ----------------------------------------
    def _build(self, dist: Dist):
        self.dist = dist.resolve_batch(self.tc.batch)
        self.device = (torch.device(self.dist.mesh.device_type)
                       if self.dist.has_mesh
                       else resolve_device(self._device))
        # a rank that the mesh leaves out builds no step and holds nothing
        self.member = (not self.dist.has_mesh
                       or self.dist.mesh.get_coordinate() is not None)
        self.params = self.opt_state = None
        if not self.member:
            self.model = self._step_fn = None
            return
        self.model = make_model(self.cfg, self.dist, self.opts)
        self.shape = ShapeSpec("trainer", self.tc.seq, self.tc.batch,
                               "train")
        self._step_fn = steps.jit_train_step(self.model, self.opt,
                                             self.shape)

    def init(self, seed: int = 0):
        """Fresh weights from a ``torch.Generator`` seeded with ``seed``
        on the device, and a zero optimizer state; on a mesh each rank
        keeps its slice of every leaf (a rank off the mesh, none)."""
        if not self.member:
            return self
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        if not self.dist.has_mesh:
            self.params = params
            self.opt_state = init_opt_state(self.opt, params)
            return self
        psh, osh = self._shardings()
        self.params = map_leaves(
            lambda path, x: distribute(x, leaf_at(psh, path)), params)
        del params
        self.opt_state = self._zero_state(osh)
        return self

    def _zero_state(self, osh):
        """The zero optimizer state, each rank allocating only its
        slices (Adafactor's factored stats may shard differently from
        their param, so the shapes come from the whole-leaf state)."""
        from torch.distributed.tensor import DTensor
        abstract = abstract_opt_state(self.opt,
                                      self.model.abstract_params())

        def zeros(path, t):
            sh = leaf_at(osh, path)
            sl = shard_slices(sh.spec, t.shape, mesh_axes(sh.mesh),
                              sh.coordinate())
            local = torch.zeros([s.stop - s.start for s in sl],
                                dtype=t.dtype, device=self.device)
            return DTensor.from_local(local, sh.mesh, sh.placements,
                                      run_check=False, shape=t.shape,
                                      stride=contiguous_stride(t.shape))
        return map_leaves(zeros, abstract)

    def _shardings(self):
        if not self.dist.has_mesh:
            return None, None
        mesh = self.dist.mesh
        pspec = self.model.param_shardings()
        ospec = opt_state_specs(self.opt, self.model.param_defs(),
                                self.dist)
        osh = map_leaves(lambda _p, s: Sharding(mesh, s), ospec)
        return pspec, osh

    # ---- data ---------------------------------------------------------------
    def _batch(self, step: int):
        """The reference's synthetic batch of ``step``, bit for bit: numpy
        Philox keyed by the step, each odd position a copy of the even
        one before it (learnable), as int64 tensors on the device."""
        rng = np.random.Generator(np.random.Philox(key=step))
        toks = rng.integers(0, self.cfg.vocab_size,
                            size=(self.tc.batch, self.tc.seq + 1),
                            dtype=np.int64)
        toks[:, 1::2] = toks[:, 0::2][:, : toks[:, 1::2].shape[1]]
        toks = toks.astype(np.int32)
        dev = self.device
        b = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64))
             .to(dev),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int64))
             .to(dev)}
        if self.cfg.mrope:
            pos = np.broadcast_to(np.arange(self.tc.seq, dtype=np.int64),
                                  (3, self.tc.batch, self.tc.seq))
            b["positions"] = torch.from_numpy(pos.copy()).to(dev)
        if self.cfg.frontend != "none" or self.cfg.family == "encdec":
            raise NotImplementedError(
                "Trainer synthesizes token batches; stub-frontend archs "
                "train via the model-level steps")
        return b

    # ---- loop -----------------------------------------------------------------
    def step_once(self, batch):
        """One supervised step (with transient-failure retry + restore);
        records metrics and advances ``self.step``. This is the seam the
        pjit execution backend drives with its own data pipeline and
        watchdog hooks.

        A failed step is retried only from a restored checkpoint: the
        step updates params and state in place, so a failure may leave
        them half updated, and without a valid checkpoint the failure is
        raised. On a mesh of several ranks every rank retries or raises
        alike (``_agree``; the module docstring gives the bound)."""
        self._require_member()
        tries = 0
        while True:
            err = None
            try:
                self.params, self.opt_state, loss = self._step_fn(
                    self.params, self.opt_state, batch)
                loss = float(loss)
            except Exception as e:
                err = e
            failed = self._agree(err)
            if not failed:
                break
            tries += 1
            if tries > self.tc.max_step_retries \
                    or self._restore_latest() is None:
                if err is not None:
                    raise err
                raise RuntimeError(f"step {self.step} failed on {failed} "
                                   f"other rank(s) of the mesh")
        self.metrics.record(self.tc.job_id, "loss", self.step, loss)
        self.step += 1
        return loss

    def train(self, steps: int):
        """Steps up to ``steps`` (a checkpoint every ``ckpt_every``); the
        losses, none on a rank that the mesh leaves out."""
        losses = []
        if not self.member:
            return losses
        while self.step < steps:
            losses.append(self.step_once(self._batch(self.step)))
            if self.step % self.tc.ckpt_every == 0:
                self.save()
        self.ckpt.wait()
        return losses

    def program_cost(self) -> Dict:
        """``count_program`` of one step on the meta device (the
        counterpart of the reference's compiled text for ``JobPerf``):
        the one-card step, or on a mesh ``steps.local_train_step`` on
        this rank's shards, whose collectives make the collective term.
        Launches nothing, sends nothing and allocates no device
        memory."""
        self._require_member()
        if not self.dist.has_mesh:
            return count_program(
                steps.build_train_step(self.model, self.opt),
                *steps.abstract_inputs(self.model, self.shape, self.opt))
        return count_program(
            steps.local_train_step(self.model, self.opt, self.shape),
            *steps.abstract_local_inputs(self.model, self.shape, self.opt))

    # ---- checkpoint / restore ----------------------------------------------
    def save(self, extra: Optional[Dict[str, Any]] = None):
        self._require_member()
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"step": self.step, **(extra or {})})

    def _require_member(self):
        if not self.member:
            raise RuntimeError(
                f"this rank is not on the trainer's mesh "
                f"{mesh_axes(self.dist.mesh)}: it left the run at resume")

    def _all_reduce(self, values):
        """``values`` summed over the ranks of the mesh, on its gloo side
        group (host memory, bounded by the process group's timeout)."""
        import torch.distributed as tdist
        side = getattr(self.dist.mesh, "side_group", None)
        if side is None:
            raise RuntimeError(
                f"a Trainer on a mesh of {self._n_ranks()} ranks needs the "
                f"mesh's gloo side group: build the mesh with "
                f"launch.mesh.make_mesh over a gloo or NCCL process group")
        t = torch.tensor(values, dtype=torch.float64)
        tdist.all_reduce(t, group=side)
        return t.tolist()

    def _agree(self, err: Optional[BaseException]) -> int:
        """How many ranks of the mesh failed this attempt (this rank's
        ``err``). Raises on every rank when a collective of the step
        failed on any of them (a ``DistError``: a wait ran out, or a peer
        is gone) or when the agreement's own wait fails: the step's
        groups may then be out of step."""
        if self._n_ranks() == 1:
            return int(err is not None)
        import torch.distributed as tdist
        broken = isinstance(err, tdist.DistError)
        try:
            failed, broke = self._all_reduce([float(err is not None),
                                              float(broken)])
        except Exception as e:
            if err is None:
                raise
            raise err from e
        if broke:
            if err is not None:
                raise err
            raise RuntimeError(
                f"step {self.step}: a collective failed on {int(broke)} "
                f"rank(s) of the mesh (each wait bounded by "
                f"{self.dist.mesh.wait_s} s)")
        return int(failed)

    def _sync(self):
        """Wait for this rank's outstanding write, then, on a mesh of
        several ranks, until every rank of it has (one of them writes),
        so all read the same files."""
        self.ckpt.wait()
        if self._n_ranks() > 1:
            self._all_reduce([1.0])

    def _n_ranks(self) -> int:
        return (math.prod(mesh_axes(self.dist.mesh).values())
                if self.dist.has_mesh else 1)

    def _restore_latest(self) -> Optional[int]:
        """Restore the latest valid checkpoint; its step, or None (and
        nothing restored) when there is none."""
        self._sync()
        last = self.ckpt.latest_valid()
        if last is not None:
            self.restore(last)
        return last

    def restore(self, step: int) -> Dict[str, Any]:
        """Restore params/opt-state; returns the checkpoint's ``extra``
        metadata (step, plus whatever the caller saved — e.g. the data
        cursor position)."""
        self._require_member()
        self._sync()
        aps = self.model.abstract_params()
        tmpl = {"params": aps, "opt": abstract_opt_state(self.opt, aps)}
        sh = None
        if self.dist.has_mesh:
            psh, osh = self._shardings()
            sh = {"params": psh, "opt": osh}
        tree, extra = self.ckpt.restore(
            step, tmpl, sh, device=None if sh else self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.step = int(extra.get("step", step))
        return extra

    # ---- elastic scaling ---------------------------------------------------
    def resume(self, new_dist: Dist) -> "Trainer":
        """Continue the SAME run on a different mesh (elastic scaling):
        checkpoint now, rebuild step/layout, restore with the new one.
        Every rank of the old mesh saves and syncs; a rank that the new
        mesh leaves out then frees its state and leaves the run."""
        was = self.member
        if was:
            self.save()
            self._sync()
        step = self.step
        self._build(new_dist)           # frees params and state first
        if self.member:
            self.restore(self.ckpt.latest_valid())
            assert not was or self.step == step, (self.step, step)
        return self
