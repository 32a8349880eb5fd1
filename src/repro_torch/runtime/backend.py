"""Pluggable execution backends — the seam between the platform's
submit→place→run→checkpoint→complete pipeline and *how* a job executes:
the counterpart of ``repro/runtime/backend.py``.

An ``ExecutionBackend`` turns a resource envelope (``JobSpec``) plus a
user manifest into an ``ExecutionPlan`` — the task sets the Lifecycle
Manager deploys — and exposes launch plus checkpoint/pause/resume hooks:

  * ``software-ps`` — learner threads around a sharded
    ``SoftwareParameterServer`` on the device (runtime/learner.py), with a
    PS app deployed first for multi-learner jobs;
  * ``pjit`` — a gang of workers around ``runtime/trainer.py``'s
    ``Trainer``: worker 0 drives the step (on a mesh, the sharded step of
    distributed/steps.py), the rest mirror liveness; every incarnation
    rebuilds the step for the current ``Dist`` and restores the latest
    valid checkpoint, so elastic resume and preemption-resume are one
    path;
  * ``serving`` (registered from serving/endpoint.py) — inference
    endpoints as platform jobs.

The port keeps a registry of its own (``BACKENDS``) under the
reference's names: registering under those names in the reference's
registry would replace its backends in a process that loads both
packages.

``BackendContext`` has two fields the reference's lacks, with
``LMPlugin(cfg=, device=)`` as their precedent: ``device`` (``None``
resolves to CUDA through ``resolve_device``, which raises where there is
none) and ``cfg``, the ``ArchConfig`` a plan trains or serves (``None``
keeps the reference's ``reduce_for_smoke(get_arch(arch))``; the card runs
full width this way).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.errors import Preempted, UserError
from repro_torch.platform.cluster import Resources
from repro_torch.platform.lcm import (ExecutionPlan, JobControl, JobSpec,
                                      LifecycleManager, PS_RESOURCES,
                                      TaskGroup)
from repro_torch.platform.metrics import MetricsService
from repro_torch.platform.storage import StorageManager
from repro_torch.platform.zookeeper import ZooKeeper


@dataclass
class BackendContext:
    """Platform services a backend may wire into its task bodies, and the
    device and model config its plans run."""
    zk: ZooKeeper
    storage: StorageManager
    metrics: MetricsService
    workdir: str
    tracer: Optional[object] = None     # observability.trace.Tracer
    loghub: Optional[object] = None     # the reference's JobLogHub slot
    device: DeviceLike = None           # None: CUDA (raises without it)
    cfg: Optional[ArchConfig] = None    # None: the manifest arch's smoke cfg

    def __post_init__(self):
        self.device = resolve_device(self.device)


def plan_config(ctx: BackendContext, fw_cfg: Dict) -> ArchConfig:
    """The config a plan of a model-zoo manifest trains or serves:
    ``ctx.cfg`` when set, which must be of the manifest's arch (its smoke
    reduction included), else ``reduce_for_smoke(get_arch(arch))``."""
    arch = fw_cfg.get("arch", "stablelm-1.6b")
    if ctx.cfg is None:
        return reduce_for_smoke(get_arch(arch))
    if ctx.cfg.arch_id.removesuffix("-smoke") != arch:
        raise UserError(f"BackendContext.cfg is {ctx.cfg.arch_id!r} but the "
                        f"manifest's arch is {arch!r}")
    return ctx.cfg


@dataclass
class JobHandle:
    """A launched job as seen by the service layer: enough to query
    state and drive the backend's lifecycle hooks."""
    job_id: str
    backend: str
    plan: ExecutionPlan
    lcm: LifecycleManager

    def state(self) -> str:
        return self.lcm.job_state(self.job_id)


class ExecutionBackend:
    """Protocol + default hook implementations. Subclasses must set
    ``name`` and implement ``plan``; the control-flow hooks work for any
    plan that carries a JobControl."""

    name: str = "?"

    def plan(self, spec: JobSpec, manifest: Dict,
             ctx: BackendContext) -> ExecutionPlan:
        raise NotImplementedError

    def launch(self, plan: ExecutionPlan,
               lcm: LifecycleManager) -> JobHandle:
        """Hand the plan to the LCM (queue → place → run) and return a
        handle for status/lifecycle operations."""
        lcm.submit_plan(plan)
        return JobHandle(plan.job_id, self.name, plan, lcm)

    # ---- lifecycle hooks (observed at step boundaries) -------------------
    def checkpoint(self, handle: JobHandle):
        """Request an immediate checkpoint from the running job."""
        handle.plan.control.request_checkpoint()

    def pause(self, handle: JobHandle):
        handle.plan.control.pause()

    def resume(self, handle: JobHandle, **kw):
        handle.plan.control.resume()


BACKENDS: Dict[str, ExecutionBackend] = {}


def register_backend(cls):
    BACKENDS[cls.name] = cls()
    return cls


def get_backend(name: str) -> ExecutionBackend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise UserError(
            f"unknown execution backend {name!r}; "
            f"available: {sorted(BACKENDS)}") from None


# ---------------------------------------------------------------------------
# software-ps: learner threads + sharded software parameter server
# ---------------------------------------------------------------------------


@register_backend
class SoftwarePSBackend(ExecutionBackend):
    """N learner tasks coordinate through a sharded parameter server on
    the device; multi-learner jobs additionally deploy a PS app (deployed
    first, as in the paper)."""

    name = "software-ps"

    def plan(self, spec: JobSpec, manifest: Dict,
             ctx: BackendContext) -> ExecutionPlan:
        from repro_torch.analysis.perf import JobPerf
        from repro_torch.core.cursor import GlobalCursor
        from repro_torch.core.software_ps import SoftwareParameterServer
        from repro_torch.runtime.learner import (LearnerJobConfig, PLUGINS,
                                                 make_learner_body)
        from repro_torch.service.manifest import (resolve_framework,
                                                  resolve_ps_options)
        fw_name, fw_cfg = resolve_framework(manifest)
        if fw_name not in PLUGINS:
            raise UserError(f"unsupported framework {fw_name!r}; "
                            f"supported: {sorted(PLUGINS)}")
        plugin_kw = {"device": ctx.device}
        if fw_name == "repro-lm":
            plugin_kw["cfg"] = plan_config(ctx, fw_cfg)
        elif ctx.cfg is not None:
            raise UserError(f"BackendContext.cfg applies to model-zoo "
                            f"frameworks ('repro-lm'), not {fw_name!r}")
        compression, ps_shards = resolve_ps_options(manifest)
        jcfg = LearnerJobConfig(
            job_id=spec.job_id,
            framework=fw_name,
            framework_cfg=fw_cfg,
            data_cfg=manifest.get("data", {}) or {},
            n_learners=spec.learners,
            batch_docs=int(manifest.get("batch_docs", 8)),
            steps=int(manifest.get("steps", 40)),
            comm_every=int(manifest.get("comm_every", 1)),
            lr=float(manifest.get("lr", 0.1)),
            optimizer=str(manifest.get("optimizer", "sgd")),
            solver=str(manifest.get("solver", "psgd")),
            compression=compression,
            seed=int(manifest.get("seed", 0)),
            checkpoint_dir=f"{ctx.workdir}/ckpt/{spec.job_id}",
            checkpoint_every=int(manifest.get("checkpoint_every", 20)),
            ckpt_mirror=(ctx.storage, "objectstore",
                         f"ckpt/{spec.job_id}"),
            user_error_at=manifest.get("user_error_at"),
            fail_at_step={int(k): int(v) for k, v in
                          (manifest.get("fail_at_step") or {}).items()},
        )
        plugin = PLUGINS[jcfg.framework](jcfg.framework_cfg, **plugin_kw)
        # start the step's kernel build in the background so it overlaps
        # the weight init below and the deployment
        if hasattr(plugin, "warm_async"):
            plugin.warm_async(jcfg.batch_docs, jcfg.data_cfg)
            warming = getattr(plugin, "_warming", None)
            if ctx.tracer is not None and warming is not None:
                wsp = ctx.tracer.start(spec.job_id, "warm_compile",
                                       framework=fw_name)
                threading.Thread(
                    target=lambda: (warming.wait(120.0),
                                    ctx.tracer.end(wsp)),
                    daemon=True).start()
        # the plugin is handed to the learner body below: the model is
        # built once per job, not once per learner
        flat0 = plugin.flat_state(jcfg.seed)
        # roofline estimate of the learner step (status.perf), counted on
        # the meta device on a background thread: it needs no kernel
        # build, so it starts at once
        perf = JobPerf(spec.job_id, ctx.metrics)
        perf.start_async(lambda: plugin.program_cost(jcfg.batch_docs,
                                                     jcfg.data_cfg))
        ps = SoftwareParameterServer(
            flat0, n_shards=ps_shards,
            n_learners=spec.learners,
            optimizer=(jcfg.optimizer if jcfg.solver in
                       ("psgd", "downpour") else "average"),
            lr=jcfg.lr,
            trigger="on_arrival" if jcfg.solver == "downpour" else "bsp",
            compression=compression,
            metrics=ctx.metrics, job_id=spec.job_id, device=ctx.device)
        del flat0                   # the PS holds its own copy
        cursor = GlobalCursor(
            ctx.zk, f"/dlaas/jobs/{spec.job_id}/cursor",
            dataset_size=int((manifest.get("data") or {}).get(
                "n_docs", 512)))
        results: Dict = {}
        control = JobControl()
        body = make_learner_body(jcfg, ps, cursor, ctx.storage,
                                 ctx.metrics, results, control=control,
                                 plugin=plugin, tracer=ctx.tracer)
        groups = []
        if spec.learners > 1:
            groups.append(TaskGroup(
                "ps", 1,
                Resources(PS_RESOURCES.cpus, PS_RESOURCES.gpus,
                          PS_RESOURCES.memory_mb)))
        groups.append(TaskGroup(
            "learner", spec.learners,
            Resources(spec.cpus_per_learner, spec.gpus_per_learner,
                      spec.memory_mb),
            body=body))
        return ExecutionPlan(
            job_id=spec.job_id, backend=self.name, groups=groups,
            min_alive_fraction=spec.min_alive_fraction,
            tenant=spec.tenant, priority=spec.priority,
            results=results, control=control,
            meta={"ps": ps, "framework": fw_name, "steps": jcfg.steps,
                  "compression": compression, "ps_shards": ps_shards,
                  "perf": perf})


# ---------------------------------------------------------------------------
# pjit: SPMD gang around Trainer / jit_train_step
# ---------------------------------------------------------------------------


def _check_gang(dist, members: int) -> None:
    """A mesh of N ranks needs a gang of at least N members."""
    from repro_torch.distributed.sharding import mesh_axes
    n = math.prod(mesh_axes(dist.mesh).values()) if dist.has_mesh else 0
    if n > members:
        raise UserError(f"a mesh of {n} ranks needs a gang of at least {n} "
                        f"members; this job's gang has {members}")


@register_backend
class PjitBackend(ExecutionBackend):
    """The reference's SPMD gang (``backend.py:241-318``): the gang is
    placed, queued, preempted and resumed as a unit, and every
    incarnation rebuilds the step for the current ``Dist`` and restores
    the latest valid checkpoint. The model config is ``plan_config``'s,
    as for software-ps, so ``BackendContext.cfg`` trains full width.

    A mesh-less ``Dist`` (the manifest's policy until a mesh is attached
    with ``resume(new_dist)``) runs ``Trainer.step_once`` in worker 0, in
    the service process, and the rest of the gang mirrors liveness. A
    ``Dist`` with a mesh, which may name only axis sizes
    (``launch.mesh.MeshShape``; the service process holds no rank of
    it), runs in rank processes (``runtime/spmd.py``): worker 0 starts
    one per rank for each incarnation and feeds them the batches of the
    job's cursor, and worker i mirrors the liveness of rank i's process,
    so a rank that dies fails its member and the gang restarts whole
    (``min_alive_fraction`` 1.0). A mesh needs a gang of at least as
    many members as it has ranks."""

    name = "pjit"

    def plan(self, spec: JobSpec, manifest: Dict,
             ctx: BackendContext) -> ExecutionPlan:
        from repro_torch.analysis.perf import JobPerf
        from repro_torch.core.cursor import GlobalCursor
        from repro_torch.data.pipeline import DatasetSpec
        from repro_torch.service.manifest import resolve_framework

        fw_name, fw_cfg = resolve_framework(manifest)
        if fw_name != "repro-lm":
            raise UserError(
                f"distribution 'pjit' requires a model-zoo framework "
                f"('repro-lm'); got {fw_name!r} — use "
                f"'software-ps' for plugin frameworks")
        arch = fw_cfg.get("arch", "stablelm-1.6b")
        cfg = plan_config(ctx, fw_cfg)
        data_cfg = manifest.get("data", {}) or {}
        dspec = DatasetSpec(n_docs=int(data_cfg.get("n_docs", 512)),
                            seq_len=int(data_cfg.get("seq_len", 32)),
                            vocab_size=cfg.vocab_size,
                            seed=int(data_cfg.get("seed", 0)))
        cursor = GlobalCursor(ctx.zk,
                              f"/dlaas/jobs/{spec.job_id}/cursor",
                              dataset_size=dspec.n_docs)
        results: Dict = {}
        control = JobControl()
        meta = {"arch": arch, "policy": fw_cfg.get("policy", "fsdp_tp"),
                "steps": int(manifest.get("steps", 40)), "elastic": True,
                # the step is built by the leader at run time, so the
                # roofline estimate starts there (first incarnation)
                "perf": JobPerf(spec.job_id, ctx.metrics)}
        state = {"done": threading.Event()}
        body = _make_pjit_body(
            job_id=spec.job_id, cfg=cfg, dspec=dspec, cursor=cursor,
            ctx=ctx, control=control, results=results, state=state,
            meta=meta, members=spec.learners,
            steps=int(manifest.get("steps", 40)),
            batch_docs=int(manifest.get("batch_docs", 8)),
            lr=float(manifest.get("lr", 0.1)),
            optimizer=str(manifest.get("optimizer", "sgd")),
            seed=int(manifest.get("seed", 0)),
            ckpt_every=int(manifest.get("checkpoint_every", 20)),
            user_error_at=manifest.get("user_error_at"),
            fail_at_step={int(k): int(v) for k, v in
                          (manifest.get("fail_at_step") or {}).items()},
        )
        groups = [TaskGroup(
            "worker", spec.learners,
            Resources(spec.cpus_per_learner, spec.gpus_per_learner,
                      spec.memory_mb),
            body=body)]
        return ExecutionPlan(
            job_id=spec.job_id, backend=self.name, groups=groups,
            # an SPMD gang cannot limp along with missing members
            min_alive_fraction=1.0,
            tenant=spec.tenant, priority=spec.priority,
            results=results, control=control, meta=meta)

    def resume(self, handle: JobHandle, new_dist=None, **kw):
        """Elastic resume: an optional new ``Dist`` takes effect on the
        next (re)incarnation — the step is rebuilt and the checkpoint
        restored with the new layout (the ``Trainer.resume`` path), in
        rank processes where it has a mesh. A mesh of more ranks than the
        gang has members raises ``UserError`` and changes nothing."""
        if new_dist is not None:
            _check_gang(new_dist, handle.plan.primary().count)
            handle.plan.meta["next_dist"] = new_dist
        handle.plan.control.resume()


def _make_pjit_body(*, job_id, cfg, dspec, cursor, ctx, control, results,
                    state, meta, members, steps, batch_docs, lr, optimizer,
                    seed, ckpt_every, user_error_at, fail_at_step):
    """Body fn(watchdog, idx) for one gang member (``backend.py:321-437``
    of the reference). Worker 0 runs the step (or, on a mesh, the rank
    processes); the others mirror liveness until the leader finishes (or
    the gang is preempted or killed)."""
    import io
    import time

    import numpy as np

    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.observability.trace import TRACE_STEP_SAMPLE, maybe_span
    from repro_torch.platform.watchdog import CHECKPOINTING, TRAINING
    from repro_torch.runtime.trainer import TrainerConfig

    corpus = SyntheticCorpus(dspec)
    tc = dict(batch=batch_docs, seq=dspec.seq_len, ckpt_every=ckpt_every,
              ckpt_dir=f"{ctx.workdir}/ckpt/{job_id}", job_id=job_id)
    mirror = (ctx.storage, "objectstore", f"ckpt/{job_id}")
    tracer = ctx.tracer

    def current_dist():
        from repro_torch.distributed.sharding import Dist
        # an elastic resume's new Dist wins once, then sticks
        # (meta["dist"]) so later preemptions reincarnate at the
        # rescaled distribution; otherwise the manifest's policy applies
        # (mesh-less until a mesh is attached via resume(new_dist))
        dist = (meta.pop("next_dist", None) or meta.get("dist")
                or Dist(policy=meta.get("policy", "fsdp_tp")))
        meta["dist"] = dist
        return dist

    def boundary(wd, step, save, crash):
        """The step boundary: preemption, pause, an on-demand checkpoint,
        an injected crash or user error; then the step's batch and the
        cursor position after it."""
        wd.maybe_preempt()
        control.wait_while_paused(should_abort=wd.maybe_preempt)
        if control.take_checkpoint_request():
            save()
        for i, s in list(fail_at_step.items()):
            if s == step:
                fail_at_step.pop(i)             # transient: fires once
                crash(i)
        if user_error_at is not None and step == user_error_at:
            raise UserError("bad hyperparameter in user model")
        batch = corpus.batch_for(cursor.next_chunk(batch_docs))
        epoch, offset = cursor.position()
        return ({k: np.asarray(batch[k], np.int64)
                 for k in ("tokens", "labels")},
                {"epoch": epoch, "offset": offset})

    def record(wd, step, loss, t_round):
        wd.heartbeat(step, loss=loss)
        wd.log(f"step={step} loss={loss:.4f}")
        ctx.metrics.record(job_id, "lr", step, lr)
        ctx.metrics.record(job_id, "round_time_s", step,
                           time.time() - t_round)

    def finish(pflat, loss):
        # store.sh analogue: upload the trained model, the flat f32
        # vector in the reference's leaf order, gathered whole
        buf = io.BytesIO()
        np.save(buf, pflat)
        ctx.storage.upload("results", job_id, "trained_model.npy",
                           buf.getbuffer())
        del buf
        if loss is not None:
            results["final_loss"] = float(loss)
        results["params"] = pflat

    def restored(wd, step, extra):
        cursor.restore(int(extra.get("epoch", 0)),
                       int(extra.get("offset", 0)))
        wd.log(f"resumed from checkpoint step={step}")

    def leader(wd, dist):
        import torch

        from repro_torch.distributed.sharding import gather
        from repro_torch.models.layers import map_leaves
        from repro_torch.optim.optimizers import OptConfig
        from repro_torch.runtime.trainer import Trainer
        from repro_torch.weights import flat_from_params

        tr = Trainer(cfg, dist, OptConfig(name=optimizer, lr=lr),
                     TrainerConfig(**tc, ckpt_mirror=mirror),
                     metrics=ctx.metrics, device=ctx.device).init(seed)
        perf = meta.get("perf")
        if perf is not None:
            # idempotent across incarnations (start_async runs once)
            perf.start_async(tr.program_cost)
        last = tr.ckpt.latest_valid()
        if last is not None:
            restored(wd, last, tr.restore(last))

        def save_ckpt():
            wd.set_status(CHECKPOINTING)
            with maybe_span(tracer, job_id, "checkpoint_publish",
                            step=tr.step):
                epoch, offset = cursor.position()
                tr.save(extra={"epoch": epoch, "offset": offset})
            ctx.metrics.event(job_id, "checkpoint", tr.step)
            wd.set_status(TRAINING)

        def crash(i):
            if i != 0:
                return
            wd.log(f"injected crash at step {tr.step}")
            wd.crash()
            raise RuntimeError("simulated container crash")

        loss = None
        t_round = time.time()
        while tr.step < steps:
            step = tr.step
            batch, _ = boundary(wd, step, save_ckpt, crash)
            step_sp = (tracer.start(job_id, "step", step=step)
                       if tracer is not None
                       and step % TRACE_STEP_SAMPLE == 0 else None)
            loss = tr.step_once({k: torch.as_tensor(v).to(tr.device)
                                 for k, v in batch.items()})
            if step_sp is not None:
                tracer.end(step_sp, loss=float(loss))
            record(wd, step, loss, t_round)
            t_round = time.time()
            if tr.step % ckpt_every == 0:
                save_ckpt()
        finish(flat_from_params(map_leaves(lambda _p, x: gather(x),
                                           tr.params)), loss)
        tr.ckpt.wait()

    def mesh_leader(wd, dist):
        """Worker 0 on a mesh: one ``RankGang`` for this incarnation."""
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import mesh_axes
        from repro_torch.optim.optimizers import OptConfig
        from repro_torch.runtime.spmd import RankGang

        _check_gang(dist, members)
        ckpt = CheckpointManager(tc["ckpt_dir"], mirror=mirror)
        perf = meta.get("perf")
        job = {"cfg": cfg, "opt": OptConfig(name=optimizer, lr=lr),
               "tc": tc, "policy": dist.policy, "seed": seed,
               "want_cost": perf is not None and perf.state == "pending"}
        gen = state["gen"] = state.get("gen", 0) + 1
        gang = RankGang(mesh_axes(dist.mesh), job,
                        f"{ctx.workdir}/spmd/{job_id}/{gen}-{time.time_ns()}",
                        ctx.device.type)
        gang.gen = gen
        state["gang"] = gang
        inc = {"ranks": gang.n, "axes": dict(gang.axes),
               "pids": [q.pid for q in gang.procs], "step_s": [],
               "launches": None}
        results.setdefault("spmd", []).append(inc)

        def publish(steps_written):
            for s in steps_written:
                ckpt.publish(s)

        try:
            ready = gang.collect("ready")
            inc["start_s"] = time.perf_counter() - gang.t_start
            inc["restore_s"] = ready[0]["restore_s"]
            step = ready[0]["step"]
            if ready[0]["restored"] is not None:
                restored(wd, step, ready[0]["extra"])
            if ready[0]["cost"] is not None:
                cost = ready[0]["cost"]
                perf.start_async(lambda: cost)

            def save_ckpt():
                wd.set_status(CHECKPOINTING)
                epoch, offset = cursor.position()
                gang.send(("save", {"epoch": epoch, "offset": offset}))
                publish(gang.collect("saved")[0]["written"])
                ctx.metrics.event(job_id, "checkpoint", step)
                wd.set_status(TRAINING)

            def crash(i):
                if i >= gang.n:
                    return
                wd.log(f"injected crash of rank {i} at step {step}")
                gang.kill(i)
                if i == 0:
                    wd.crash()
                    raise RuntimeError("simulated container crash")

            loss = None
            t_round = time.time()
            while step < steps:
                batch, extra = boundary(wd, step, save_ckpt, crash)
                step_sp = (tracer.start(job_id, "step", step=step)
                           if tracer is not None
                           and step % TRACE_STEP_SAMPLE == 0 else None)
                gang.send(("step", batch, extra))
                rep = gang.collect("step")[0]
                loss = rep["loss"]
                ctx.metrics.record(job_id, "loss", step, loss)
                if step_sp is not None:
                    tracer.end(step_sp, loss=loss)
                inc["step_s"].append(rep["step_s"])
                inc["launches"] = rep["launches"]
                record(wd, step, loss, t_round)
                t_round = time.time()
                publish(rep["written"])
                step += 1
                if rep["saved"] is not None:
                    ctx.metrics.event(job_id, "checkpoint", rep["saved"])
            gang.send(("finish",))
            done = gang.collect("done")
            inc["launches"] = done[0]["launches"]
            publish(done[0]["written"])
            finish(gang.recv_array(0, *done[0]["flat"]), loss)
            for r in range(gang.n):
                gang.procs[r].wait()
        except (Preempted, UserError):
            # the leader ends this gang itself: a rank that ``stop`` has
            # to kill is no failure for its member to mirror, in this
            # incarnation or the next
            forget(gang)
            publish(gang.stop())          # at this step boundary
            raise
        else:
            forget(gang)
        finally:
            # a failure kills every rank and leaves the gang in view, so
            # each member fails with its rank and the whole gang restarts
            gang.close()

    def forget(gang):
        if state.get("gang") is gang:
            state["gang"] = None

    def member(wd, idx):
        # gang member: mirrors the liveness of its rank's process (on a
        # mesh of more than idx ranks), else yields with the gang
        failed = state.setdefault("failed_gen", {})
        while not state["done"].is_set():
            wd.maybe_preempt()
            control.wait_while_paused(should_abort=wd.maybe_preempt)
            gang = state.get("gang")
            if gang is not None and idx < gang.n \
                    and failed.get(idx, 0) < gang.gen:
                rc = gang.returncode(idx)
                if rc not in (None, 0):
                    failed[idx] = gang.gen
                    wd.log(f"rank {idx} exited with code {rc}")
                    wd.crash()
                    raise RuntimeError(f"rank {idx}'s process died")
            time.sleep(0.01)

    def body(wd, idx):
        if idx != 0:
            return member(wd, idx)
        dist = current_dist()
        if dist.has_mesh:
            mesh_leader(wd, dist)
        else:
            state["gang"] = None
            leader(wd, dist)
        state["done"].set()

    return body
