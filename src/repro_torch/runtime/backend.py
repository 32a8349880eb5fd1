"""Pluggable execution backends — the seam between the platform's
submit→place→run→checkpoint→complete pipeline and *how* a job executes:
the counterpart of ``repro/runtime/backend.py``.

An ``ExecutionBackend`` turns a resource envelope (``JobSpec``) plus a
user manifest into an ``ExecutionPlan`` — the task sets the Lifecycle
Manager deploys — and exposes launch plus checkpoint/pause/resume hooks:

  * ``software-ps`` — learner threads around a sharded
    ``SoftwareParameterServer`` on the device (runtime/learner.py), with a
    PS app deployed first for multi-learner jobs;
  * ``pjit`` — registered so that a manifest resolves to the same name
    in both packages, but not ported yet: its ``plan`` raises
    ``UserError``;
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

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.errors import UserError
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
# pjit: not ported yet
# ---------------------------------------------------------------------------


@register_backend
class PjitBackend(ExecutionBackend):
    """The reference's SPMD gang around ``Trainer``/``jit_train_step``.
    Registered under its name so that ``distribution: pjit`` resolves in
    both packages; planning it raises until the port has the trainer."""

    name = "pjit"

    def plan(self, spec: JobSpec, manifest: Dict,
             ctx: BackendContext) -> ExecutionPlan:
        raise UserError("distribution 'pjit' is not yet ported to "
                        "repro_torch; use 'software-ps'")
