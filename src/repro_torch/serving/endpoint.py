"""Managed inference endpoints — the ModelEndpoint lifecycle and the
``serving`` execution backend: the counterpart of
``repro/serving/endpoint.py``.

An endpoint IS a platform job: ``ServingBackend.plan`` turns an
endpoint spec into an ``ExecutionPlan`` with one ``server`` task group,
and the Lifecycle Manager deploys/monitors/decommissions it through the
same FairShareQueue/Scheduler machinery as training — endpoints are
metered against tenant quotas, can be queued, preempted (in-flight
requests re-queue and resume on re-placement) and paused like any job.

Endpoint states (derived from the LCM job state + engine readiness):

    DEPLOYING → READY → DRAINING → STOPPED
        └──────────────────────────→ FAILED

Weights come from a completed training job via the platform storage
path: the ``results`` store object the learner uploaded
(``trained_model.npy``, the flat f32 layout both packages write),
falling back to the job's latest valid checkpoint (``checkpoint/``,
software-PS flat layout). Deploy-from-arch skips the download and serves
fresh init weights from the engine's seed. The engine runs on
``BackendContext.device`` and serves ``plan_config``'s config.
"""
from __future__ import annotations

import io
import logging
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.observability.trace import maybe_span
from repro_torch.platform.cluster import Resources
from repro_torch.platform.lcm import (COMPLETED, ExecutionPlan, FAILED_J,
                                      JobControl, JobSpec, KILLED_J,
                                      TaskGroup)
from repro_torch.platform.storage import StorageError, StorageManager
from repro_torch.platform.watchdog import DOWNLOADING
from repro_torch.runtime.backend import (BackendContext, ExecutionBackend,
                                         plan_config, register_backend)
from repro_torch.serving.engine import InferenceEngine

log = logging.getLogger("repro_torch.serving")

# endpoint states
DEPLOYING_E, READY_E, DRAINING_E, STOPPED_E, FAILED_E = (
    "DEPLOYING", "READY", "DRAINING", "STOPPED", "FAILED")


def load_flat_weights(storage: StorageManager, job_id: str,
                      ckpt_dir: Optional[str] = None,
                      expect_size: Optional[int] = None) -> np.ndarray:
    """Trained weights for an endpoint, in the flat f32 layout: the
    results store first (what the learner uploaded on completion), then
    the job's latest valid checkpoint (software-PS ``flat`` layout)."""
    try:
        data = storage.download("results", job_id, "trained_model.npy")
        return np.load(io.BytesIO(data), allow_pickle=False)
    except StorageError:
        pass
    if ckpt_dir is not None and expect_size is not None:
        probe = CheckpointManager(ckpt_dir, keep=3)
        last = probe.latest_valid()
        if last is not None:
            try:
                tree, _ = probe.restore(
                    last, {"flat": np.zeros(expect_size, np.float32)})
                return np.asarray(tree["flat"])
            except Exception as e:    # e.g. pjit pytree checkpoint layout
                log.warning("checkpoint fallback for %s unusable: "
                            "%s: %s", job_id, type(e).__name__, e)
    raise StorageError(f"no trained weights found for job {job_id!r}")


def make_server_body(engine: InferenceEngine, source_training,
                     ctx: BackendContext, control: JobControl):
    """Task body for the endpoint's single ``server`` task: download
    weights, start the engine, serve until drained. Runs under the
    watchdog like every task — preemption/pause land at batch-step
    boundaries inside ``engine.run``."""

    def body(wd, idx):
        flat = None
        if source_training:
            wd.set_status(DOWNLOADING)
            with maybe_span(ctx.tracer, engine.endpoint_id,
                            "weights_download", source=source_training):
                flat = load_flat_weights(
                    ctx.storage, source_training,
                    ckpt_dir=f"{ctx.workdir}/ckpt/{source_training}",
                    expect_size=engine.flat_size)
        engine.start(flat)
        del flat                  # the engine holds the weights now
        wd.set_status("SERVING")
        wd.log(f"endpoint ready: capacity={engine.capacity} "
               f"max_seq={engine.max_seq} max_queue={engine.max_queue}")
        engine.run(wd=wd, control=control)
        wd.log(f"endpoint drained: "
               f"{engine.stats()['completed_total']} requests served")

    return body


@register_backend
class ServingBackend(ExecutionBackend):
    """Inference endpoints as platform jobs. The manifest carries a
    ``serving`` section (capacity/max_queue/max_new/max_seq/eos_id/seed)
    plus the usual ``framework.arch`` and an optional
    ``source_training`` job id to load weights from."""

    name = "serving"

    def plan(self, spec: JobSpec, manifest: Dict,
             ctx: BackendContext) -> ExecutionPlan:
        fw = manifest.get("framework") or {}
        srv = manifest.get("serving") or {}
        arch = fw.get("arch", "stablelm-1.6b")
        cfg = plan_config(ctx, fw)
        max_new = int(srv.get("max_new", 16))
        max_seq = srv.get("max_seq")
        if max_seq is None:
            max_seq = 64
        engine = InferenceEngine(
            cfg,
            capacity=int(srv.get("capacity", 2)),
            max_seq=int(max_seq),
            max_queue=int(srv.get("max_queue", 16)),
            default_max_new=max_new,
            eos_id=srv.get("eos_id"),
            seed=int(srv.get("seed", 0)),
            metrics=ctx.metrics, endpoint_id=spec.job_id,
            tracer=ctx.tracer, device=ctx.device)
        source = manifest.get("source_training")
        control = JobControl()
        body = make_server_body(engine, source, ctx, control)
        groups = [TaskGroup(
            "server", 1,
            Resources(spec.cpus_per_learner, spec.gpus_per_learner,
                      spec.memory_mb),
            body=body)]
        return ExecutionPlan(
            job_id=spec.job_id, backend=self.name, groups=groups,
            min_alive_fraction=1.0,
            tenant=spec.tenant, priority=spec.priority,
            control=control,
            meta={"engine": engine, "arch": arch, "workload": "inference",
                  "source_training": source})


class ModelEndpoint:
    """One deployed endpoint as the service layer sees it: the engine,
    its execution plan/handle, and the derived lifecycle state."""

    def __init__(self, endpoint_id: str, plan: ExecutionPlan,
                 user: str = "anon"):
        self.endpoint_id = endpoint_id
        self.plan = plan
        self.engine: InferenceEngine = plan.meta["engine"]
        self.arch = plan.meta.get("arch")
        self.source_training = plan.meta.get("source_training")
        self.user = user
        self.created = time.time()
        self.handle = None                  # JobHandle, set after launch
        self.stats_final: Optional[Dict] = None

    # ---- lifecycle --------------------------------------------------------
    def job_state(self) -> str:
        if self.handle is None:
            return "UNKNOWN"
        return self.handle.lcm.job_state(self.endpoint_id)

    def state(self) -> str:
        job = self.job_state()
        if job in (COMPLETED, KILLED_J):
            return STOPPED_E
        if job == FAILED_J:
            return FAILED_E
        if self.engine.draining:
            return DRAINING_E
        if self.engine.ready:
            return READY_E
        # QUEUED / DEPLOYING / PROCESSING-before-ready / PREEMPTED
        return DEPLOYING_E

    def drain(self):
        """Graceful stop: finish in-flight + queued work, then the
        server task exits and the LCM decommissions the job."""
        self.engine.drain()

    def finalize(self, metrics=None):
        """Terminal teardown (idempotent): snapshot the stats, release
        the weights and slot cache and unregister the endpoint's metrics.
        release() re-runs on every call: a task that was killed
        mid-deploy may have rebuilt buffers after the first finalize."""
        if self.stats_final is None:
            self.stats_final = self.engine.stats()
        self.engine.release()
        if metrics is not None:
            metrics.drop(self.endpoint_id)

    # ---- observability ----------------------------------------------------
    def status(self, job_state: Optional[str] = None) -> Dict:
        state = self.state()
        return {
            "endpoint_id": self.endpoint_id,
            "state": state,
            "job_state": job_state or self.job_state(),
            "arch": self.arch,
            "source_training": self.source_training,
            "user": self.user,
            "created": self.created,
            "capacity": self.engine.capacity,
            "max_seq": self.engine.max_seq,
            "max_queue": self.engine.max_queue,
            "stats": (self.stats_final if self.stats_final is not None
                      else self.engine.stats()),
            # the decode step's roofline estimate
            "perf": self.engine.perf.snapshot(self.engine.decode_rate()),
        }
