"""Lifecycle Manager (paper §Lifecycle Management).

Responsible for "the entire lifecycle of the training job, from initial
deployment to status updates, failure handling and garbage collection of
learners and parameter servers". Stateless by itself: every piece of job
state lives in ZooKeeper, so a crashed LCM instance can be replaced and
``recover()`` resumes where the predecessor left off, and training jobs
keep running while the LCM is down (decoupling test).

The LCM is backend-agnostic: it deploys an ``ExecutionPlan`` — an ordered
list of ``TaskGroup``s produced by an execution backend
(runtime/backend.py). The software-PS backend plans learners + a PS app;
the pjit backend plans one gang of SPMD workers. Deployment order follows
the paper: auxiliary groups (the PS app) are deployed first; the primary
group (learners/workers) last. The legacy ``JobSpec`` entry point is kept
as a thin adapter that builds the equivalent plan.

Copied from ``repro/platform/lcm.py`` unchanged apart from import paths
and one fix: ``_set`` checks for a znode, then creates it, so two
threads in ``monitor()`` at once (the service's tick loop and a status
request) could both miss it and the second ``create`` raised
``NodeExistsError``; the port's ``_set`` then writes the node instead.
And one addition: ``JobControl.fence()``. ``DLaaSCore.crash()`` fences
every job of the crashed core, and a fenced learner writes no checkpoint
and no model, as a killed process could not. In the reference the
zombie learner still publishes the checkpoint that ends the step it is
in, and a recovering core adopts it. The port imports nothing of
``repro``.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.platform.cluster import (App, Resources, Scheduler,
                                          RUNNING, FINISHED, FAILED,
                                          PREEMPTED as TASK_PREEMPTED,
                                          STAGING as TASK_STAGING)
from repro_torch.platform.watchdog import JOB_DONE, JOB_FAILED
from repro_torch.platform.zookeeper import (NodeExistsError, NoNodeError,
                                            ZooKeeper, zk_retry)

# job states (PREEMPTED is non-terminal: the scheduler requeues the
# job's tasks and they resume from the last checkpoint — bounding the
# Dependability paper's "restart amplification")
QUEUED, DEPLOYING, PROCESSING, COMPLETED, FAILED_J, KILLED_J, \
    PREEMPTED_J = ("QUEUED", "DEPLOYING", "PROCESSING", "COMPLETED",
                   "FAILED", "KILLED", "PREEMPTED")


# footprint of the parameter-server app (deployed for multi-learner
# jobs); shared with DLaaSCore's admission pre-check so the two can
# never drift and fail quota mid-deploy
PS_RESOURCES = Resources(cpus=1.0, gpus=0, memory_mb=512)


@dataclass
class JobSpec:
    job_id: str
    learners: int = 1
    gpus_per_learner: int = 1
    cpus_per_learner: float = 1.0
    memory_mb: int = 1024
    # fraction of learners that may be dead while training continues
    min_alive_fraction: float = 0.5
    learner_body: Optional[Callable] = None      # fn(watchdog, member_idx)
    ps_body: Optional[Callable] = None           # fn(watchdog)
    # multi-tenancy: scheduling principal + priority band
    tenant: str = "default"
    priority: int = 0


class JobControl:
    """Cooperative control channel between the service and task bodies:
    pause/resume and on-demand checkpoint, observed at step boundaries
    exactly like preemption. Execution backends hand one of these to
    every body they plan; the backend's checkpoint/pause/resume hooks
    flip the events."""

    def __init__(self):
        self._pause = threading.Event()
        self._ckpt = threading.Event()
        self._fence = threading.Event()

    def pause(self):
        self._pause.set()

    def resume(self):
        self._pause.clear()

    @property
    def paused(self) -> bool:
        return self._pause.is_set()

    def request_checkpoint(self):
        self._ckpt.set()

    def take_checkpoint_request(self) -> bool:
        """Consume a pending checkpoint request (at most one body should
        act on it — by convention, member index 0)."""
        if self._ckpt.is_set():
            self._ckpt.clear()
            return True
        return False

    def fence(self):
        """The service that ran this job crashed: its task bodies write
        nothing durable (checkpoint, model) from now on."""
        self._fence.set()

    @property
    def fenced(self) -> bool:
        return self._fence.is_set()

    def wait_while_paused(self, should_abort: Optional[Callable] = None):
        """Block while paused. ``should_abort`` (e.g. Watchdog.
        maybe_preempt) is polled so a paused task still honors
        preemption/kill by raising out of the wait."""
        while self._pause.is_set():
            if should_abort is not None:
                should_abort()
            time.sleep(0.01)


@dataclass
class TaskGroup:
    """One homogeneous set of tasks of an execution plan (the learners,
    the PS app, or a pjit worker gang). ``role`` names the members
    (``<role>-<idx>``) and the scheduler app (``<job>-<role>s``)."""
    role: str                                   # learner | worker | ps
    count: int
    resources: Resources
    body: Optional[Callable] = None             # fn(watchdog, member_idx)


@dataclass
class ExecutionPlan:
    """What an execution backend decided to run for one job: the task
    sets (aux groups such as the PS first, primary group last), the
    footprint, and the shared control/result channels. The LCM derives
    everything it deploys, monitors, kills and GCs from this."""
    job_id: str
    backend: str = "software-ps"
    groups: List[TaskGroup] = field(default_factory=list)
    min_alive_fraction: float = 0.5
    tenant: str = "default"
    priority: int = 0
    results: Dict = field(default_factory=dict)
    control: Optional[JobControl] = None
    meta: Dict = field(default_factory=dict)

    def primary(self) -> TaskGroup:
        """The group whose tasks carry the training (non-PS)."""
        return next(g for g in self.groups if g.role != "ps")

    def total_resources(self) -> Resources:
        """Aggregate demand — what admission control must fit."""
        tot = Resources(cpus=0.0, gpus=0, memory_mb=0)
        for g in self.groups:
            tot.cpus += g.resources.cpus * g.count
            tot.gpus += g.resources.gpus * g.count
            tot.memory_mb += g.resources.memory_mb * g.count
        return tot


def plan_from_jobspec(spec: JobSpec) -> ExecutionPlan:
    """Legacy adapter: the software-PS learner/PS shape as an
    ExecutionPlan (used by LifecycleManager.submit for direct JobSpec
    callers, e.g. the fault-tolerance tests)."""
    groups: List[TaskGroup] = []
    if spec.learners > 1 and spec.ps_body is not None:
        ps_body = spec.ps_body
        groups.append(TaskGroup(
            "ps", 1,
            Resources(PS_RESOURCES.cpus, PS_RESOURCES.gpus,
                      PS_RESOURCES.memory_mb),
            body=lambda wd, idx: ps_body(wd)))
    learner_body = spec.learner_body
    groups.append(TaskGroup(
        "learner", spec.learners,
        Resources(spec.cpus_per_learner, spec.gpus_per_learner,
                  spec.memory_mb),
        body=(None if learner_body is None
              else (lambda wd, idx: learner_body(wd, idx)))))
    return ExecutionPlan(
        job_id=spec.job_id, backend="software-ps", groups=groups,
        min_alive_fraction=spec.min_alive_fraction,
        tenant=spec.tenant, priority=spec.priority)


class LifecycleManager:
    def __init__(self, zk: ZooKeeper, scheduler: Scheduler, tracer=None):
        self.zk = zk
        self.scheduler = scheduler
        self.tracer = tracer        # state writes become phase spans
        self._last_pos: Dict[str, Optional[int]] = {}
        zk.ensure("/dlaas/jobs")

    # ---- ZK state helpers (LCM itself is stateless) -----------------------
    def _jpath(self, job_id: str) -> str:
        return f"/dlaas/jobs/{job_id}"

    def _set(self, job_id: str, key: str, value: Dict):
        path = f"{self._jpath(job_id)}/{key}"
        data = json.dumps(value).encode()

        def write():
            if self.zk.exists(path):
                self.zk.set(path, data)
            else:
                try:
                    self.zk.create(path, data, makepath=True)
                except NodeExistsError:     # created since the check
                    self.zk.set(path, data)
        # monitor()/submit run on the tick thread: a brief quorum outage
        # (kill_replica chaos) must not crash the control loop
        zk_retry(write)
        # every job state write is the single choke point lifecycle
        # tracing hangs off: QUEUED/DEPLOYING/PROCESSING/... become
        # non-overlapping phase spans in the job's timeline
        if (self.tracer is not None and key == "state"
                and "state" in value):
            self.tracer.job_state_change(job_id, value["state"])

    def _get(self, job_id: str, key: str) -> Optional[Dict]:
        try:
            data, _ = zk_retry(
                lambda: self.zk.get(f"{self._jpath(job_id)}/{key}"))
            return json.loads(data or b"{}")
        except NoNodeError:
            return None

    def job_state(self, job_id: str) -> str:
        rec = self._get(job_id, "state") or {}
        return rec.get("state", "UNKNOWN")

    def job_spec(self, job_id: str) -> Dict:
        """The persisted job spec (backend, groups, footprint, tenancy)."""
        return self._get(job_id, "spec") or {}

    @staticmethod
    def group_app_id(job_id: str, role: str) -> str:
        """Scheduler app id for a task group (PS keeps its historic
        un-pluralized id)."""
        return f"{job_id}-ps" if role == "ps" else f"{job_id}-{role}s"

    def _roles(self, job_id: str) -> List[str]:
        return self.job_spec(job_id).get("groups") or ["ps", "learner"]

    def _app_ids(self, job_id: str) -> List[str]:
        return [self.group_app_id(job_id, r) for r in self._roles(job_id)]

    def _primary_app(self, job_id: str,
                     roles: Optional[List[str]] = None) -> str:
        """App id of the training-carrying group; pass pre-read
        ``roles`` to avoid a second spec read (monitor's hot path)."""
        role = next((r for r in (roles if roles is not None
                                 else self._roles(job_id)) if r != "ps"),
                    "learner")
        return self.group_app_id(job_id, role)

    def _persist_queue_pos(self, job_id: str,
                           primary_app: Optional[str] = None):
        pos = self.scheduler.queue_position(
            primary_app or self._primary_app(job_id))
        # monitor() runs every tick for every job — only touch ZK when
        # the position actually moved (the cache is just an optimization;
        # a recovered LCM simply rewrites once)
        if self._last_pos.get(job_id) == pos:
            return
        self._last_pos[job_id] = pos
        self._set(job_id, "queue", {"position": pos, "ts": time.time()})

    def queue_info(self, job_id: str) -> Optional[Dict]:
        """Persisted queue position (None once the job left the queue)."""
        return self._get(job_id, "queue")

    def jobs(self) -> List[str]:
        try:
            return zk_retry(lambda: self.zk.children("/dlaas/jobs"))
        except NoNodeError:
            return []

    # ---- deployment ---------------------------------------------------------
    def submit(self, spec: JobSpec):
        """Legacy entry point: a software-PS learner/PS job described by
        a JobSpec. Routed through the same plan pipeline as backends."""
        self.submit_plan(plan_from_jobspec(spec))

    def submit_plan(self, plan: ExecutionPlan):
        p = plan.primary()
        self._set(plan.job_id, "state", {"state": QUEUED,
                                         "ts": time.time()})
        self._set(plan.job_id, "spec", {
            "backend": plan.backend,
            "groups": [g.role for g in plan.groups],
            "learners": p.count, "gpus": p.resources.gpus,
            "cpus": p.resources.cpus, "memory_mb": p.resources.memory_mb,
            "min_alive_fraction": plan.min_alive_fraction,
            "tenant": plan.tenant, "priority": plan.priority})
        self.deploy(plan)

    def deploy(self, plan: ExecutionPlan):
        """Deploy the plan's task groups in order — auxiliary groups
        (the PS app) first, as the paper prescribes, primary last."""
        self._set(plan.job_id, "state", {"state": DEPLOYING,
                                         "ts": time.time()})
        for g in plan.groups:
            app = App(app_id=self.group_app_id(plan.job_id, g.role),
                      resources=g.resources, count=g.count,
                      run=self._wrap_member(plan.job_id, g),
                      # a group that cannot lose any member (pjit SPMD
                      # gang, serving endpoint) migrates as one unit
                      # when a node under it drains or dies
                      gang=(g.role != "ps"
                            and plan.min_alive_fraction >= 1.0))
            self.scheduler.submit(app, tenant=plan.tenant,
                                  priority=plan.priority)

    def _wrap_member(self, job_id: str, group: TaskGroup):
        from repro_torch.platform.watchdog import Watchdog

        trace_id = (self.tracer.trace_of(job_id)
                    if self.tracer is not None else None)

        def run(task):
            idx = int(task.task_id.rsplit(".", 1)[1])
            wd = Watchdog(self.zk, job_id, f"{group.role}-{idx}",
                          preempt_check=task.preempt_event.is_set,
                          trace_id=trace_id)
            if group.body is None:
                wd.run(lambda w: None)
            else:
                wd.run(lambda w: group.body(w, idx))
        return run

    # ---- monitoring ---------------------------------------------------------
    def member_statuses(self, job_id: str) -> Dict[str, Dict]:
        out = {}
        base = f"{self._jpath(job_id)}/members"
        try:
            members = zk_retry(lambda: self.zk.children(base))
        except NoNodeError:
            return out
        for m in members:
            rec: Dict = {"alive": self.zk.exists(f"{base}/{m}/alive")}
            try:
                data, _ = zk_retry(
                    lambda m=m: self.zk.get(f"{base}/{m}/status"))
                rec.update(json.loads(data))
            except NoNodeError:
                pass
            try:
                data, _ = zk_retry(
                    lambda m=m: self.zk.get(f"{base}/{m}/heartbeat"))
                rec["heartbeat"] = json.loads(data)
            except NoNodeError:
                pass
            out[m] = rec
        return out

    def max_step(self, job_id: str) -> Optional[int]:
        """Highest step any member has heartbeated — the chaos harness's
        job-progress trigger (platform/faults.py) reads training
        progress through this hook instead of poking at job internals."""
        steps = [r["heartbeat"]["step"]
                 for r in self.member_statuses(job_id).values()
                 if "heartbeat" in r and "step" in r["heartbeat"]]
        return max(steps) if steps else None

    def monitor(self, job_id: str) -> str:
        """One monitoring pass; returns the (possibly updated) job state.

        Counts ephemeral liveness znodes and statuses: determines whether
        training finished, failed on user error, or lost too many learners
        to continue (paper: 'whether training can be continued even if a
        small fraction of learners have failed')."""
        state = self.job_state(job_id)
        if state in (COMPLETED, FAILED_J, KILLED_J):
            return state
        # one spec read per pass: monitor() runs every tick for every
        # job, so roles/primary-app/min_alive all derive from this dict
        spec = self.job_spec(job_id)
        roles = spec.get("groups") or ["ps", "learner"]
        primary_app = self._primary_app(job_id, roles)
        lapp = self.scheduler.apps.get(primary_app)
        if lapp is not None:
            tstates = [t.state for t in lapp.tasks.values()]
            if any(s == TASK_PREEMPTED for s in tstates):
                # scheduler evicted the job; tasks are requeued and will
                # resume from the last checkpoint when re-placed
                self._persist_queue_pos(job_id, primary_app)
                if state != PREEMPTED_J:
                    self._set(job_id, "state", {"state": PREEMPTED_J,
                                                "ts": time.time()})
                return PREEMPTED_J
            if tstates and all(s == TASK_STAGING for s in tstates):
                # nothing placed yet: job is waiting in the fair-share
                # queue — record its position for GET /v1/queue and ops
                self._persist_queue_pos(job_id, primary_app)
                if state != QUEUED:
                    self._set(job_id, "state", {"state": QUEUED,
                                                "ts": time.time()})
                return QUEUED
        st = self.member_statuses(job_id)
        # every non-PS member carries training (learner-i / worker-i)
        learners = {m: r for m, r in st.items()
                    if not m.startswith("ps")}
        if not learners:
            return state
        statuses = [r.get("status") for r in learners.values()]
        if any(s == JOB_FAILED and "user" in (r.get("detail") or "")
               for s, r in zip(statuses, learners.values())):
            # user error: terminate the whole job, no restart
            for role in roles:
                self.scheduler.kill_app(self.group_app_id(job_id, role))
            self._set(job_id, "state", {"state": FAILED_J,
                                        "reason": "user error"})
            return FAILED_J
        if all(s == JOB_DONE for s in statuses):
            self.decommission(job_id)
            return COMPLETED
        alive = sum(1 for r in learners.values() if r["alive"])
        frac = alive / max(1, len(learners))
        min_frac = spec.get("min_alive_fraction", 0.5)
        self._set(job_id, "progress", {
            "alive": alive, "total": len(learners),
            "can_continue": frac >= min_frac})
        if state != PROCESSING:
            self._set(job_id, "state", {"state": PROCESSING,
                                        "ts": time.time()})
        return PROCESSING

    # ---- completion / GC -----------------------------------------------------
    def decommission(self, job_id: str):
        """Paper: 'determine when all learners have finished training,
        decommission them and reclaim computing resources'. Auxiliary
        groups (the PS app) are killed; the primary group's tasks have
        already finished on their own."""
        primary = self._primary_app(job_id)
        for app_id in self._app_ids(job_id):
            if app_id != primary:
                self.scheduler.kill_app(app_id)
        self._set(job_id, "state", {"state": COMPLETED, "ts": time.time()})

    def kill(self, job_id: str):
        for app_id in self._app_ids(job_id):
            self.scheduler.kill_app(app_id)
        self._set(job_id, "state", {"state": KILLED_J, "ts": time.time()})

    def gc(self, job_id: str):
        """Garbage-collect a terminal job's znodes (keeps state record)."""
        base = f"{self._jpath(job_id)}/members"
        try:
            for m in list(self.zk.children(base)):
                self._rm_tree(f"{base}/{m}")
        except NoNodeError:
            pass

    def clear_runtime_state(self, job_id: str):
        """Crash-recovery prep: drop everything a relaunched incarnation
        must rebuild itself — member status/heartbeat/log znodes, the
        persisted queue position, and the replayed data cursor. The
        cursor is the subtle one: ``GlobalCursor.restore`` only moves
        FORWARD, so a replayed cursor ahead of the last checkpoint would
        make the resumed run skip data an uninterrupted run would see
        (breaking loss parity). The checkpoint's (epoch, offset) is the
        truth; the relaunch re-seeds the cursor from it."""
        self.gc(job_id)
        for key in ("queue", "progress", "cursor"):
            try:
                self.zk.delete(f"{self._jpath(job_id)}/{key}")
            except NoNodeError:
                pass

    def _rm_tree(self, path: str):
        try:
            for ch in list(self.zk.children(path)):
                self._rm_tree(f"{path}/{ch}")
            self.zk.delete(path)
        except NoNodeError:
            pass

    # ---- recovery (LCM statelessness) ----------------------------------------
    @classmethod
    def recover(cls, zk: ZooKeeper, scheduler: Scheduler, tracer=None
                ) -> "LifecycleManager":
        """A fresh LCM instance adopting all state from ZooKeeper — the
        paper's decoupling claim: jobs proceed while the LCM is replaced."""
        return cls(zk, scheduler, tracer=tracer)
