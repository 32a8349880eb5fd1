"""DLaaS core service wiring — the four-step user flow of the paper
(prepare / upload / train+monitor / download) over the platform services:
the port's counterpart of ``repro/service/core.py``.

This object is what the REST API (service/rest.py) and the CLI call into;
it owns the simulated datacenter, ZooKeeper, scheduler, LCM, storage,
metrics, and executes training jobs under watchdog supervision through
the port's execution backends (runtime/backend.py): ``software-ps``
learner threads around the device-resident parameter server (``pjit`` is
registered but not ported and raises ``UserError``), selected by the
manifest's ``framework.distribution``.

Durability is the reference's: the in-process ZooKeeper is backed by a
write-ahead journal under ``<workdir>/journal``, every piece of
control-plane state the service owns lives in journaled znodes, and a
fresh ``DLaaSCore`` over the same workdir replays the journal and
recovers (terminal jobs become history, live trainings relaunch through
checkpoint-resume, READY endpoints re-deploy, billing never resets).

The public methods, their names and their return shapes are the
reference's. What differs:

  * ``stores`` (store id -> a ``platform.storage`` store) replaces the
    workdir's ``local``, ``objectstore`` or ``results`` store, e.g. by
    one in host memory where the disk is the scarce resource.
  * ``device`` (``None``: CUDA, which raises where there is none) and
    ``arch_cfgs`` (arch id -> the ``ArchConfig`` a ``repro-lm`` job or
    endpoint of that arch runs; absent arches run the reference's
    ``reduce_for_smoke`` config) go into every ``BackendContext``, all of
    which ``_ctx`` builds: first launches, recovery relaunches and
    endpoint re-deploys plan at the same device and config.
  * A training that reaches COMPLETED, FAILED or KILLED frees its
    parameter server once its learner tasks have returned
    (``_release_ps``, from the tick loop and from ``training_status``):
    the snapshot of its stats stays as ``data_plane``. The reference
    only drops the server from the plan when a terminal job is polled,
    and its learner body keeps it alive; at full width on one card that
    would hold tens of GiB for the life of the service.
  * ``crash()`` frees the abandoned incarnation's device state as a
    SIGKILL frees a process's memory: each training's parameter server
    and each endpoint's engine, once that job's task bodies have
    returned. It also fences every job (``JobControl.fence``), so the
    zombie's learners write no checkpoint and no model after the crash.
    The reference's zombie keeps its servers, which is harmless in host
    memory; on one card two full-width servers do not fit beside the
    recovered run.
  * No XLA compilation cache (kernels build from the repo's sources into
    ``build/kernels/`` at first use).

As in the reference, ``kernels.grid``'s small-block degradations count
as the ``platform`` counter ``kernels_small_block_total``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.observability.export import prometheus_text as _prom_text
from repro_torch.observability.log import (JobLogHub, register_hub,
                                           setup_logging, unregister_hub)
from repro_torch.observability.trace import Tracer, TraceStore
from repro_torch.platform.cluster import Cluster, Node, Resources, Scheduler
from repro_torch.platform.journal import Journal
from repro_torch.platform.lcm import JobSpec, LifecycleManager
from repro_torch.platform.queue import QuotaExceeded
from repro_torch.platform.metrics import LogParserService, MetricsService
from repro_torch.platform.storage import (LocalFSStore, ObjectStore,
                                          StorageManager)
from repro_torch.platform.zookeeper import (NodeExistsError, NoNodeError,
                                            ZooKeeper)
from repro_torch.runtime.backend import BackendContext, get_backend
from repro_torch.runtime.learner import PLUGINS
from repro_torch.service.manifest import (parse_manifest,
                                          resolve_distribution,
                                          resolve_framework,
                                          validate_manifest)
from repro_torch.serving.engine import DeadlineExceeded
from repro_torch.serving.endpoint import ModelEndpoint

log = logging.getLogger("repro_torch.core")

_TERMINAL = ("COMPLETED", "FAILED", "KILLED")


def default_cluster(n_nodes: int = 8, gpus_per_node: int = 4) -> Cluster:
    return Cluster([Node(f"node-{i}",
                         Resources(cpus=16, gpus=gpus_per_node,
                                   memory_mb=64000))
                    for i in range(n_nodes)])


class DLaaSCore:
    def __init__(self, workdir: str, *, cluster: Optional[Cluster] = None,
                 health_checks: bool = True, tick_interval: float = 0.02,
                 admin_users: Optional[set] = None,
                 autoscale: Optional[Any] = None,
                 durable: bool = True, device: DeviceLike = None,
                 arch_cfgs: Optional[Dict[str, ArchConfig]] = None,
                 stores: Optional[Dict[str, Any]] = None):
        # first: without a card (and no device="cpu") nothing else starts
        self.device = resolve_device(device)
        self.arch_cfgs = dict(arch_cfgs or {})
        self.admin_users = admin_users
        # journaled ZK: constructing over an existing workdir replays
        # the predecessor's mutations (durable=False opts out for
        # throwaway cores that must not pay journal I/O)
        self.zk = ZooKeeper(journal=Journal(f"{workdir}/journal")
                            if durable else None)
        self.cluster = cluster or default_cluster()
        self.scheduler = Scheduler(self.cluster,
                                   health_checks=health_checks)
        self.autoscaler = None
        if autoscale:
            # autoscale=True uses defaults; a dict is kwargs for the
            # Autoscaler (max_nodes, node_gpus, spot, spot_cost, ...)
            from repro_torch.platform.autoscale import Autoscaler
            kw = autoscale if isinstance(autoscale, dict) else {}
            self.autoscaler = Autoscaler(self.scheduler, **kw)
            self.scheduler.autoscaler = self.autoscaler
        self._transition_idx = 0      # cluster log -> metrics mirror
        self.metrics = MetricsService()
        # observability plane: structured logging, a per-job log hub the
        # REST streams tail, and the tracer every layer records into.
        # Span latencies mirror into platform histograms so /metrics
        # exposes them without a second collection path.
        setup_logging()
        self.loghub = JobLogHub()
        register_hub(self.loghub)
        self.trace_store = TraceStore()

        def _span_done(sp, _m=self.metrics):
            _m.observe("platform", f"span_{sp.name}_seconds",
                       max(0.0, (sp.end or sp.start) - sp.start))

        self.tracer = Tracer(self.trace_store, on_span_end=_span_done)
        self.lcm = LifecycleManager(self.zk, self.scheduler,
                                    tracer=self.tracer)
        self.log_parser = LogParserService(self.metrics)
        # SLO engine: burn-rate alerts + anomaly detection + alert-driven
        # remediation, stepped from the scheduler tick (outside its lock)
        from repro_torch.platform.health import HealthController
        self.health = HealthController(self, autoscaler=self.autoscaler)
        self.scheduler.health_controller = self.health
        self.storage = StorageManager()
        self.workdir = workdir
        self.storage.register("local", LocalFSStore(f"{workdir}/local"))
        self.storage.register(
            "objectstore", ObjectStore(f"{workdir}/objectstore"))
        self.storage.register("results", LocalFSStore(f"{workdir}/results"))
        # a deployment's own stores in place of the workdir's (registered
        # before recovery, which relaunches jobs that write to them)
        for store_id, store in (stores or {}).items():
            self.storage.register(store_id, store)
        self.models: Dict[str, Dict] = {}
        self.trainings: Dict[str, Dict] = {}
        self.endpoints: Dict[str, ModelEndpoint] = {}
        self._job_seq = itertools.count(1)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._tick_errors: Dict[str, str] = {}
        # metering (API layer concern, kept with the core for simplicity)
        self.usage: Dict[str, int] = {}
        # durable-billing mirror cache (tick loop persists on change)
        self._billing_cache: Dict[str, Dict] = {}
        self.crashed = False
        # recovery pass BEFORE the ticker starts: the replayed tree is
        # inspected and live jobs relaunched while nothing else mutates
        self.recovery: Dict[str, Any] = {"recovered": False}
        if durable and (self.zk.journal_stats.get("records", 0) > 0
                        or self.zk.journal_stats.get("snapshot", 0) > 0):
            self._recover()
        self._ticker = threading.Thread(target=self._tick_loop,
                                        args=(tick_interval,), daemon=True)
        self._ticker.start()
        # kernel-grid degradations surface as a platform counter
        # (kernels/grid.py warns once per signature; the metric counts
        # every occurrence). Weakly bound: cores come and go in tests.
        import weakref

        from repro_torch.kernels import grid as _grid
        wself = weakref.ref(self)

        def _small_block(f, requested, chosen):
            c = wself()
            if c is not None:
                c.metrics.incr("platform", "kernels_small_block_total")
        _grid.on_small_block(_small_block)

    def close(self):
        self._stop.set()
        self._ticker.join(timeout=2)
        unregister_hub(self.loghub)
        self.zk.detach_journal()

    def crash(self):
        """SIGKILL-equivalent teardown for crash drills: detach the
        journal FIRST (nothing this incarnation does afterwards is
        durable — exactly like a dead process), then stop the ticker,
        fence every job (its learners write no checkpoint or model) and
        force every running task body to bail at its next step boundary
        so the zombie incarnation stops writing checkpoints into the
        workdir a recovering core is about to adopt. A short-lived
        thread then frees each job's device state (parameter server,
        engine) once its task bodies have returned."""
        self.zk.detach_journal()
        self._stop.set()
        self.crashed = True
        unregister_hub(self.loghub)
        with self._lock:
            plans = [r["plan"] for r in self.trainings.values()
                     if r.get("plan") is not None]
            plans += [ep.plan for ep in self.endpoints.values()]
        for plan in plans:
            if plan.control is not None:
                plan.control.fence()
        for app in list(self.scheduler.apps.values()):
            for t in list(app.tasks.values()):
                t.preempt_event.set()
        threading.Thread(target=self._release_after_crash, daemon=True,
                         name="crash-release").start()
        # crash_core fires from inside Scheduler.tick() on the ticker
        # thread itself — joining would deadlock
        if threading.current_thread() is not self._ticker:
            self._ticker.join(timeout=2)

    def _release_after_crash(self, poll_s: float = 0.02):
        """Free each training's PS and each endpoint's engine of a
        crashed core as soon as the job's task bodies have returned (the
        ticker that does it for a live core has stopped)."""
        # the tick that fired the crash may still place a task: once the
        # ticker has stopped, nothing starts any more
        self._ticker.join()
        for app in list(self.scheduler.apps.values()):
            for t in list(app.tasks.values()):
                t.preempt_event.set()
        with self._lock:
            jobs = list(self.trainings) + list(self.endpoints)
        while jobs:
            for jid in list(jobs):
                if self._tasks_returned(jid):
                    self._release_ps(jid)
                    ep = self.endpoints.get(jid)
                    if ep is not None:
                        ep.finalize()
                    jobs.remove(jid)
            time.sleep(poll_s)

    def _tick_loop(self, interval: float):
        while not self._stop.is_set():
            try:
                self.scheduler.tick()
                self._mirror_transitions()
                self._mirror_billing()
            except Exception as e:
                self._tick_error("scheduler", e)
            for jid in list(self.trainings):
                try:
                    if self.lcm.monitor(jid) in _TERMINAL:
                        self._release_ps(jid)
                except Exception as e:
                    self._tick_error(jid, e)
            for eid in list(self.endpoints):
                try:
                    st = self.lcm.monitor(eid)
                    if st in _TERMINAL:
                        # terminal: snapshot stats, free KV buffers,
                        # unregister per-endpoint metrics
                        ep = self.endpoints.get(eid)
                        if ep is not None:
                            ep.finalize(self.metrics)
                except Exception as e:
                    self._tick_error(eid, e)
            time.sleep(interval)

    def _tick_error(self, context: str, exc: Exception):
        """Scheduler/monitor bugs must be diagnosable, not swallowed:
        mirror them to the structured log (with job context) and into
        the metrics event stream the log tooling reads. Deduplicated per
        context — the tick loop runs ~50x/s, so a persistently failing
        monitor must not grow the event log without bound."""
        # dedup on exception type, not message text: messages may embed
        # varying values (reprs, counters) that would defeat the dedup
        kind = type(exc).__name__
        if self._tick_errors.get(context) == kind:
            return
        self._tick_errors[context] = kind
        msg = f"{kind}: {exc}"
        log.error("tick-loop %s: %s", context, msg,
                  extra={"job_id": context})
        try:
            self.metrics.event(context, "tick_error", -1, error=msg)
        except Exception as e:
            log.error("tick-loop metrics event failed: %s", e)

    def _meter(self, user: str):
        self.usage[user] = self.usage.get(user, 0) + 1
        # durable: API-call metering must survive a control-plane crash
        self._zset(f"/dlaas/usage/{user}", {"count": self.usage[user]})

    # ---- durable znode helpers -------------------------------------------
    def _zset(self, path: str, obj: Dict):
        data = json.dumps(obj).encode()
        if self.zk.exists(path):
            self.zk.set(path, data)
        else:
            self.zk.create(path, data, makepath=True)

    def _zget(self, path: str) -> Optional[Dict]:
        try:
            data, _ = self.zk.get(path)
            return json.loads(data or b"{}")
        except NoNodeError:
            return None

    def _zchildren(self, path: str) -> List[str]:
        try:
            return self.zk.children(path)
        except NoNodeError:
            return []

    # billing fields worth journaling — NOT the per-tick-volatile
    # deficit/in_use (deficit re-earns in the recovered queue; in_use
    # rebuilds as relaunched jobs place)
    _BILLING_KEYS = ("weight", "quota", "gpu_seconds", "cost_units",
                     "placements", "preemptions")

    def _mirror_billing(self):
        """Persist tenant billing/fair-share standing on change, so
        gpu-second metering survives a control-plane crash (the paper's
        multi-tenant accounting must never reset)."""
        for name, snap in self.scheduler.tenant_snapshots().items():
            durable = {k: snap[k] for k in self._BILLING_KEYS}
            if self._billing_cache.get(name) == durable:
                continue
            self._billing_cache[name] = durable
            self._zset(f"/dlaas/tenants/{name}", durable)

    def _mirror_transitions(self):
        """Mirror new node-lifecycle transitions into the metrics
        service (counters + event stream under the 'cluster' job id)
        and the cluster trace (folded into overlapping job timelines)."""
        tlog = self.cluster.transitions
        new = tlog[self._transition_idx:]
        self._transition_idx = len(tlog)
        for tick, node, prev, state, reason in new:
            self.metrics.incr("cluster", "node_transitions_total")
            self.metrics.incr("cluster", f"node_to_{state.lower()}")
            self.metrics.event("cluster", "node_transition", tick,
                               node=node, prev=prev, state=state,
                               reason=reason)
            self.tracer.event("cluster", "node_transition", tick=tick,
                              node=node, prev=prev, state=state,
                              reason=reason)

    # ----------------------------------------------------------------- cluster
    def cluster_status(self) -> Dict:
        """The elastic-provisioning status surface: node lifecycle
        states, transition log tail, autoscaler + fault-drill stats."""
        out = self.cluster.snapshot()
        out["autoscaler"] = (self.autoscaler.stats()
                             if self.autoscaler else None)
        faults = self.scheduler.faults
        out["faults"] = ({"fired": faults.fired, "done": faults.done()}
                         if faults is not None else None)
        return out

    def add_node(self, *, gpus: int = 4, cpus: float = 16.0,
                 memory_mb: int = 64000, spot: bool = False,
                 name: Optional[str] = None) -> Dict:
        """Admin: elastically join a node (REGISTERING until its first
        heartbeat lands, one tick later)."""
        name = name or f"node-x{uuid.uuid4().hex[:6]}"
        if name in self.cluster.nodes:
            raise ValueError(f"node {name!r} already exists")
        self.cluster.register_node(
            Node(name, Resources(cpus=cpus, gpus=gpus,
                                 memory_mb=memory_mb)), spot=spot)
        return {"node": name, "state": "REGISTERING", "spot": spot}

    def drain_node(self, name: str) -> Dict:
        """Admin: cordon + drain a node. Work running there is requeued
        like a preemption (gangs as one unit) and resumes elsewhere."""
        if name not in self.cluster.nodes:
            raise KeyError(name)
        self.cluster.drain_node(name, "drain requested via API")
        return {"node": name, "state": self.cluster.nodes[name].state}

    def inject_faults(self, *, seed: Optional[int] = None,
                      events: Optional[List] = None,
                      nodes: Optional[List[str]] = None,
                      n_events: int = 3, horizon: int = 40) -> Dict:
        """Attach a fault-injection schedule (chaos drill). Either an
        explicit event list or a seeded schedule over ``nodes``."""
        from repro_torch.platform.faults import (FaultInjector, FaultSchedule)
        if events is None:
            if seed is None:
                raise ValueError("inject_faults needs events= or seed=")
            nodes = nodes or sorted(self.cluster.nodes)
            sched = FaultSchedule.seeded(seed, nodes, n_events=n_events,
                                         horizon=horizon)
        else:
            sched = FaultSchedule(events)
        self.scheduler.faults = FaultInjector(sched, lcm=self.lcm,
                                              metrics=self.metrics,
                                              core=self,
                                              tracer=self.tracer)
        return {"scheduled": [e.describe() for e in sched]}

    # ----------------------------------------------------------------- tenants
    def register_tenant(self, name: str, *, weight: Optional[float] = None,
                        quota_gpus: Optional[int] = None,
                        quota_cpus: Optional[float] = None,
                        quota_memory_mb: Optional[int] = None) -> Dict:
        """Create/update a tenant: fair-share weight + concurrent-usage
        quota. None means leave-unchanged; quota dimensions merge into
        any existing quota (unset dimensions stay as they were)."""
        t = self.scheduler.configure_tenant(
            name, weight=weight, quota_cpus=quota_cpus,
            quota_gpus=quota_gpus, quota_memory_mb=quota_memory_mb)
        self._mirror_billing()       # write-through: config is durable now
        return {"tenant": name, **t.snapshot()}

    def is_admin(self, user: str) -> bool:
        """Tenant administration guard. The simulation's default trust
        model is open (tokens are self-asserted metering principals);
        pass admin_users={...} to restrict POST /v1/tenants."""
        return self.admin_users is None or user in self.admin_users

    def tenant_usage(self) -> Dict:
        """Per-tenant quota accounting: concurrent usage, lifetime
        gpu-seconds, placements and preemptions."""
        return self.scheduler.queue_status()["tenants"]

    def queue_status(self) -> Dict:
        """Scheduler queue as seen by users: one row per queued job."""
        raw = self.scheduler.queue_status()
        jobs: Dict[str, Dict] = {}
        for e in raw["entries"]:
            # app ids are '<training-id>-<group>s' ('-learners',
            # '-workers') or '<training-id>-ps'
            job_id = e["app_id"].rsplit("-", 1)[0]
            row = jobs.setdefault(job_id, {
                "training_id": job_id, "tenant": e["tenant"],
                "priority": e["priority"], "position": e["position"],
                "tasks_queued": 0, "held_by_quota": False})
            row["tasks_queued"] += 1
            row["position"] = min(row["position"], e["position"])
            row["held_by_quota"] = (row["held_by_quota"]
                                    or e["held_by_quota"])
        return {"queue": sorted(jobs.values(),
                                key=lambda r: r["position"]),
                "tenants": raw["tenants"]}

    # ------------------------------------------------------- idempotency
    def _idem_path(self, key: str) -> str:
        # hashed: client keys are arbitrary strings, znode names are not
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        return f"/dlaas/idempotency/{digest}"

    def _idem_check(self, key: str, poll_s: float = 10.0
                    ) -> Optional[Dict]:
        """Replay guard: the stored response if this key already
        completed; blocks while the original request is still in flight;
        None if the key is unused."""
        path = self._idem_path(key)
        t0 = time.time()
        while True:
            rec = self._zget(path)
            if rec is None:
                return None
            if rec.get("status") == "done":
                self.metrics.incr("platform", "idempotent_replays_total")
                return dict(rec["response"])
            if time.time() - t0 > poll_s:
                raise ValueError(
                    f"request with this Idempotency-Key is still in "
                    f"progress ({rec.get('kind')} {rec.get('id')})")
            time.sleep(0.02)

    def _idem_reserve(self, key: str, kind: str, job_id: str) -> bool:
        """Atomically claim the key (crash-safe ordering: the durable
        reservation lands BEFORE the job record, so a crash at any point
        either replays to the original job or to a droppable pending
        marker — never to a duplicate). False = lost the race."""
        try:
            self.zk.create(
                self._idem_path(key),
                json.dumps({"key": key, "kind": kind, "id": job_id,
                            "status": "pending"}).encode(),
                makepath=True)
            return True
        except NodeExistsError:
            return False

    def _idem_complete(self, key: str, kind: str, job_id: str,
                       response: Dict):
        self._zset(self._idem_path(key),
                   {"key": key, "kind": kind, "id": job_id,
                    "status": "done", "response": response})

    def _idem_abort(self, key: Optional[str]):
        if key is None:
            return
        try:
            self.zk.delete(self._idem_path(key))
        except NoNodeError:
            pass

    # ---------------------------------------------------------- recovery
    def _recover(self):
        """Rebuild service state from the replayed journal: models,
        tenants, usage, then jobs — terminal ones become history, live
        trainings relaunch through checkpoint-resume, live endpoints
        re-deploy — and finally idempotency reservations are settled."""
        rep: Dict[str, Any] = {
            "recovered": True,
            "journal": dict(self.zk.journal_stats),
            "models": 0, "tenants": 0,
            "trainings": {"resumed": [], "requeued": [],
                          "completed": [], "abandoned": []},
            "endpoints": {"redeployed": [], "abandoned": []},
            "idempotency": {"completed": 0, "dropped": 0},
        }
        for mid in self._zchildren("/dlaas/models"):
            mrec = self._zget(f"/dlaas/models/{mid}")
            if mrec is not None:
                self.models[mid] = {"model_id": mid, **mrec}
                rep["models"] += 1
        for name in self._zchildren("/dlaas/tenants"):
            snap = self._zget(f"/dlaas/tenants/{name}")
            if snap is not None:
                self.scheduler.restore_tenant(name, snap)
                self._billing_cache[name] = {
                    k: snap.get(k) for k in self._BILLING_KEYS}
                rep["tenants"] += 1
        for user in self._zchildren("/dlaas/usage"):
            urec = self._zget(f"/dlaas/usage/{user}") or {}
            self.usage[user] = int(urec.get("count", 0))
        jobs = self.lcm.jobs()
        # never reuse a predecessor's training id
        max_seq = 0
        for jid in jobs:
            if jid.startswith("training-"):
                try:
                    max_seq = max(max_seq, int(jid.split("-")[1]))
                except (IndexError, ValueError):
                    pass
        self._job_seq = itertools.count(max_seq + 1)
        # trainings first: endpoints may re-deploy from their results
        for jid in jobs:
            rec = self._zget(f"/dlaas/jobs/{jid}/record")
            if not rec or rec.get("kind") != "training":
                continue
            state = self.lcm.job_state(jid)
            # re-bind the submission-time trace id so the job's timeline
            # continues in the same trace across the crash
            self.tracer.register_job(jid, rec.get("trace_id"))
            self.tracer.event(jid, "recovery", state=state)
            if state in _TERMINAL:
                self.tracer.job_state_change(jid, state)
            base = {"training_id": jid, "model_id": rec["model_id"],
                    "user": rec["user"], "tenant": rec["tenant"],
                    "priority": rec["priority"], "backend": rec["backend"],
                    "created": rec["created"], "manifest": rec["manifest"],
                    "results": {}}
            if state == "COMPLETED":
                with self._lock:
                    self.trainings[jid] = base
                rep["trainings"]["completed"].append(jid)
            elif state in ("FAILED", "KILLED"):
                with self._lock:
                    self.trainings[jid] = base
                rep["trainings"]["abandoned"].append(jid)
            else:
                # QUEUED stays queued; DEPLOYING/PROCESSING/PREEMPTED
                # re-enter through preemption/checkpoint-resume (the gang
                # relaunches as one unit via its plan)
                from repro_torch.checkpoint.checkpoint import CheckpointManager
                has_ckpt = CheckpointManager(
                    f"{self.workdir}/ckpt/{jid}").latest_valid() is not None
                try:
                    self._relaunch_training(jid, rec)
                except Exception as e:
                    log.error("recovery relaunch %s failed: %s: %s",
                              jid, type(e).__name__, e,
                              extra={"job_id": jid})
                    with self._lock:
                        self.trainings[jid] = base
                    rep["trainings"]["abandoned"].append(jid)
                    continue
                self.tracer.event(jid, "relaunch",
                                  resumed_from_checkpoint=has_ckpt)
                rep["trainings"]["resumed" if has_ckpt
                                 else "requeued"].append(jid)
        for jid in jobs:
            rec = self._zget(f"/dlaas/jobs/{jid}/record")
            if not rec or rec.get("kind") != "endpoint":
                continue
            if self.lcm.job_state(jid) in _TERMINAL:
                rep["endpoints"]["abandoned"].append(jid)
                continue
            self.lcm.clear_runtime_state(jid)
            self.tracer.register_job(jid, rec.get("trace_id"))
            self.tracer.event(jid, "recovery",
                              state=self.lcm.job_state(jid))
            try:
                self._launch_endpoint(jid, rec["args"], rec["user"])
            except Exception as e:
                log.error("recovery redeploy %s failed: %s: %s",
                          jid, type(e).__name__, e,
                          extra={"job_id": jid})
                rep["endpoints"]["abandoned"].append(jid)
                continue
            rep["endpoints"]["redeployed"].append(jid)
        # settle idempotency reservations: a pending key whose job record
        # landed completes (the client's retry must get the original id);
        # one whose record never landed is dropped (the retry resubmits)
        for tok in self._zchildren("/dlaas/idempotency"):
            path = f"/dlaas/idempotency/{tok}"
            irec = self._zget(path) or {}
            if irec.get("status") == "done":
                continue
            kind, jid = irec.get("kind"), irec.get("id")
            if kind == "model":
                job = self._zget(f"/dlaas/models/{jid}") if jid else None
            else:
                job = (self._zget(f"/dlaas/jobs/{jid}/record")
                       if jid else None)
            if job is None:
                try:
                    self.zk.delete(path)
                except NoNodeError:
                    pass
                rep["idempotency"]["dropped"] += 1
                continue
            if kind == "model":
                resp = {"model_id": jid}
            elif kind == "training":
                resp = {"training_id": jid, "tenant": job["tenant"],
                        "priority": job["priority"],
                        "backend": job["backend"]}
            else:
                args = job.get("args", {})
                resp = {"endpoint_id": jid, "arch": args.get("arch"),
                        "tenant": args.get("tenant"),
                        "source_training": args.get("from_training"),
                        "state": "DEPLOYING"}
            self._idem_complete(irec["key"], kind, jid, resp)
            rep["idempotency"]["completed"] += 1
        self.recovery = rep
        self.tracer.event(
            "cluster", "recovery",
            journal_records=rep["journal"].get("records", 0),
            resumed=len(rep["trainings"]["resumed"]),
            requeued=len(rep["trainings"]["requeued"]),
            redeployed=len(rep["endpoints"]["redeployed"]))
        m = self.metrics
        m.incr("platform", "recoveries_total")
        m.incr("platform", "recovery_journal_records",
               rep["journal"].get("records", 0))
        m.incr("platform", "recovery_journal_dropped",
               rep["journal"].get("dropped", 0))
        for bucket, ids in rep["trainings"].items():
            m.incr("platform", f"recovery_trainings_{bucket}", len(ids))
        for bucket, ids in rep["endpoints"].items():
            m.incr("platform", f"recovery_endpoints_{bucket}", len(ids))
        m.incr("platform", "recovery_idempotency_completed",
               rep["idempotency"]["completed"])

    def _ctx(self, manifest: Dict) -> BackendContext:
        """The platform services, the device and, for a ``repro-lm``
        manifest, the config of its arch from ``arch_cfgs`` (None: the
        backend's smoke config); the software-ps backend refuses a config
        for any other framework."""
        fw_name, fw_cfg = resolve_framework(manifest)
        cfg = (self.arch_cfgs.get(fw_cfg.get("arch", "stablelm-1.6b"))
               if fw_name == "repro-lm" else None)
        return BackendContext(zk=self.zk, storage=self.storage,
                              metrics=self.metrics, workdir=self.workdir,
                              tracer=self.tracer, loghub=self.loghub,
                              device=self.device, cfg=cfg)

    def _relaunch_training(self, job_id: str, rec: Dict):
        """Recovery relaunch: rebuild the plan from the persisted record
        and resubmit. Admission is NOT re-checked — the job was admitted
        before the crash and quotas were restored unchanged."""
        manifest = rec["manifest"]
        backend = get_backend(rec["backend"])
        # stale runtime state would poison the relaunch: in particular a
        # replayed data cursor ahead of the last checkpoint breaks
        # loss parity with an uninterrupted run (cursor only moves
        # forward; the checkpoint's epoch/offset is the truth)
        self.lcm.clear_runtime_state(job_id)
        spec = JobSpec(
            job_id=job_id,
            learners=int(manifest.get("learners", 1)),
            gpus_per_learner=int(manifest.get("gpus", 1)),
            memory_mb=int(str(manifest.get("memory", "1024MiB")
                              ).rstrip("MiB") or 1024),
            tenant=rec["tenant"], priority=rec["priority"])
        plan = backend.plan(spec, manifest, self._ctx(manifest))
        plan.meta["trace_id"] = self.tracer.trace_of(job_id)
        trec = {"training_id": job_id, "model_id": rec["model_id"],
                "user": rec["user"], "tenant": rec["tenant"],
                "priority": rec["priority"], "created": rec["created"],
                "backend": backend.name, "manifest": manifest,
                "results": plan.results, "plan": plan, "spec": spec}
        with self._lock:
            self.trainings[job_id] = trec
        trec["handle"] = backend.launch(plan, self.lcm)

    def recovery_report(self) -> Dict:
        """What the last construction replayed/resumed/abandoned
        (GET /v1/recovery, ``dlaas recovery``)."""
        return dict(self.recovery)

    # ------------------------------------------------------------------ models
    def deploy_model(self, manifest_text: str, user: str = "anon",
                     idempotency_key: Optional[str] = None) -> Dict:
        if idempotency_key is not None:
            prev = self._idem_check(idempotency_key)
            if prev is not None:
                return prev
        self._meter(user)
        manifest = parse_manifest(manifest_text)
        errs = validate_manifest(manifest)
        if errs:
            raise ValueError("; ".join(errs))
        fw_name, _ = resolve_framework(manifest)
        if fw_name not in PLUGINS:
            raise ValueError(f"unsupported framework {fw_name!r}; "
                             f"supported: {sorted(PLUGINS)}")
        model_id = f"model-{uuid.uuid4().hex[:8]}"
        if idempotency_key is not None and \
                not self._idem_reserve(idempotency_key, "model", model_id):
            prev = self._idem_check(idempotency_key)
            if prev is None:
                raise ValueError("concurrent request with the same "
                                 "Idempotency-Key failed; retry")
            return prev
        rec = {"model_id": model_id, "manifest": manifest, "user": user,
               "created": time.time()}
        with self._lock:
            self.models[model_id] = rec
        self._zset(f"/dlaas/models/{model_id}",
                   {"manifest": manifest, "user": user,
                    "created": rec["created"]})
        resp = {"model_id": model_id}
        if idempotency_key is not None:
            self._idem_complete(idempotency_key, "model", model_id, resp)
        return resp

    def list_models(self, user: str = "anon") -> List[Dict]:
        self._meter(user)
        with self._lock:
            return [{"model_id": k, "name": v["manifest"].get("name")}
                    for k, v in self.models.items()]

    def get_model(self, model_id: str) -> Dict:
        with self._lock:
            if model_id not in self.models:
                raise KeyError(model_id)
            return self.models[model_id]

    def delete_model(self, model_id: str):
        with self._lock:
            self.models.pop(model_id, None)
        try:
            self.zk.delete(f"/dlaas/models/{model_id}")
        except NoNodeError:
            pass

    # --------------------------------------------------------------- trainings
    def create_training(self, model_id: str, overrides: Optional[Dict] = None,
                        user: str = "anon", tenant: Optional[str] = None,
                        priority: Optional[int] = None,
                        idempotency_key: Optional[str] = None) -> Dict:
        # idempotent replay FIRST — before metering, so a client retrying
        # across a crash is never billed twice for one submission
        if idempotency_key is not None:
            prev = self._idem_check(idempotency_key)
            if prev is not None:
                return prev
        self._meter(user)
        model = self.get_model(model_id)
        manifest = dict(model["manifest"])
        manifest.update(overrides or {})
        # scheduling principal: explicit arg > manifest key > the caller
        tenant = tenant or manifest.get("tenant") or user
        priority = int(priority if priority is not None
                       else manifest.get("priority", 0))
        job_id = f"training-{next(self._job_seq):05d}"
        # the trace starts at submission; its id is persisted with the
        # job record so a recovered core continues the same trace
        trace_id = self.tracer.register_job(job_id)
        submit_sp = self.tracer.start(job_id, "submit",
                                      model_id=model_id, tenant=tenant,
                                      user=user)
        try:
            # the execution backend owns *how* the job runs (software-PS
            # learner threads vs. a pjit SPMD gang); the service only
            # picks it from the manifest and hands over a resource
            # envelope
            backend = get_backend(resolve_distribution(manifest))
            spec = JobSpec(
                job_id=job_id,
                learners=int(manifest.get("learners", 1)),
                gpus_per_learner=int(manifest.get("gpus", 1)),
                memory_mb=int(str(manifest.get("memory", "1024MiB")
                                  ).rstrip("MiB") or 1024),
                tenant=tenant, priority=priority)
            with self.tracer.span(job_id, "plan", backend=backend.name):
                plan = backend.plan(spec, manifest, self._ctx(manifest))
            plan.meta["trace_id"] = trace_id
            # admission control: reject before any job state is created.
            # Demand covers the whole plan (learners AND the PS app, or
            # the full pjit gang), so deploy can never fail quota
            # mid-way and the gang can always place concurrently within
            # quota.
            with self.tracer.span(job_id, "admission", tenant=tenant):
                self.scheduler.check_admission(tenant,
                                               plan.total_resources())
        except Exception as e:
            self.tracer.end(submit_sp, status="error",
                            error=type(e).__name__)
            raise
        # crash-safe ordering: reserve the idempotency key (with the
        # pre-allocated id), THEN persist the job record, then launch.
        # A crash after the reservation but before the record replays to
        # a droppable pending marker; after the record, to this job.
        if idempotency_key is not None and \
                not self._idem_reserve(idempotency_key, "training", job_id):
            self.tracer.end(submit_sp, status="error", error="idem-race")
            prev = self._idem_check(idempotency_key)
            if prev is None:
                raise ValueError("concurrent request with the same "
                                 "Idempotency-Key failed; retry")
            return prev
        created = time.time()
        try:
            self._zset(f"/dlaas/jobs/{job_id}/record",
                       {"kind": "training", "model_id": model_id,
                        "manifest": manifest, "user": user,
                        "tenant": tenant, "priority": priority,
                        "backend": backend.name, "created": created,
                        "trace_id": trace_id})
            rec = {"training_id": job_id, "model_id": model_id,
                   "user": user, "tenant": tenant, "priority": priority,
                   "created": created, "backend": backend.name,
                   "manifest": manifest, "results": plan.results,
                   "plan": plan, "spec": spec}
            with self._lock:
                self.trainings[job_id] = rec
            # submission ends where the queue phase begins: launch's
            # first LCM state write (QUEUED) opens queue_wait
            self.tracer.end(submit_sp)
            try:
                rec["handle"] = backend.launch(plan, self.lcm)
            except QuotaExceeded:
                # quota tightened between the pre-check and deploy: roll
                # back so no phantom training or orphaned PS app remains
                with self._lock:
                    self.trainings.pop(job_id, None)
                self.lcm.kill(job_id)
                try:
                    self.zk.delete(f"/dlaas/jobs/{job_id}/record")
                except NoNodeError:
                    pass
                raise
        except Exception as e:
            self.tracer.end(submit_sp, status="error",
                            error=type(e).__name__)
            self._idem_abort(idempotency_key)
            raise
        resp = {"training_id": job_id, "tenant": tenant,
                "priority": priority, "backend": backend.name}
        if idempotency_key is not None:
            self._idem_complete(idempotency_key, "training", job_id, resp)
        return resp

    def list_trainings(self, user: str = "anon") -> List[Dict]:
        self._meter(user)
        with self._lock:
            ids = list(self.trainings)
        return [{"training_id": i, "status": self.lcm.job_state(i)}
                for i in ids]

    def training_status(self, job_id: str) -> Dict:
        state = self.lcm.monitor(job_id)
        members = self.lcm.member_statuses(job_id)
        loss = self.metrics.series(job_id, "loss")
        with self._lock:
            rec = self.trainings.get(job_id, {})
        out = {"training_id": job_id, "status": state,
               "tenant": rec.get("tenant"),
               "priority": rec.get("priority"),
               # which execution backend runs the job (persisted with
               # the LCM spec, so it survives a core restart)
               "backend": (rec.get("backend")
                           or self.lcm.job_spec(job_id).get("backend")),
               "members": members,
               "last_loss": loss.values[-1] if loss.values else None,
               "steps_done": loss.steps[-1] + 1 if loss.steps else 0}
        # software-PS jobs report their data plane: wire bytes pre/post
        # compression, compression ratio and fused-aggregation timing.
        # Terminal jobs keep only the final stats snapshot (_release_ps).
        plan = rec.get("plan")
        if plan is not None:
            if state in _TERMINAL:
                self._release_ps(job_id)
            with self._lock:
                ps = plan.meta.get("ps")
                if ps is not None:
                    out["data_plane"] = ps.stats()
                elif "data_plane_final" in plan.meta:
                    out["data_plane"] = plan.meta["data_plane_final"]
            perf = plan.meta.get("perf")
            if perf is not None:
                from repro_torch.analysis.perf import measured_rate_from_metrics
                out["perf"] = perf.snapshot(measured_rate_from_metrics(
                    self.metrics, job_id))
        if state in ("QUEUED", "PREEMPTED"):
            out["queue"] = self.lcm.queue_info(job_id)
        return out

    def _release_ps(self, job_id: str):
        """Free the parameter server of a training in a terminal state,
        once every task of the job has returned (a killed learner leaves
        at its next step boundary): keep its stats as
        ``data_plane_final``, release its device state, drop it from the
        plan. Idempotent; the trained model stays in the results store."""
        with self._lock:
            plan = (self.trainings.get(job_id) or {}).get("plan")
            ps = plan.meta.get("ps") if plan is not None else None
            if ps is None or not self._tasks_returned(job_id):
                return
            plan.meta["data_plane_final"] = ps.stats()
            plan.meta["ps"] = None
        ps.release()

    def _tasks_returned(self, job_id: str) -> bool:
        """No task body of the job's apps is running any more."""
        threads = self.scheduler._threads
        for app_id in self.lcm._app_ids(job_id):
            app = self.scheduler.apps.get(app_id)
            for task_id in (app.tasks if app is not None else ()):
                th = threads.get(task_id)
                if th is not None and th.is_alive():
                    return False
        return True

    def training_perf(self, job_id: str) -> Dict:
        """The roofline estimate alone (REST: GET
        /v1/trainings/<id>/perf; CLI: ``train perf``): the analyzed
        bound, attainable rate, live measured rate and the
        pct-of-attainable summary."""
        with self._lock:
            if job_id not in self.trainings:
                raise KeyError(job_id)
            rec = self.trainings.get(job_id, {})
        plan = rec.get("plan")
        perf = plan.meta.get("perf") if plan is not None else None
        if perf is None:
            return {"training_id": job_id, "perf": {"state": "unavailable"}}
        from repro_torch.analysis.perf import measured_rate_from_metrics
        return {"training_id": job_id,
                "perf": perf.snapshot(measured_rate_from_metrics(
                    self.metrics, job_id))}

    def terminate_training(self, job_id: str):
        self.lcm.kill(job_id)

    # ---- backend lifecycle hooks (pause/resume/on-demand checkpoint) -----
    def _handle(self, job_id: str):
        with self._lock:
            rec = self.trainings.get(job_id)
            ep = self.endpoints.get(job_id)
        if rec is not None and "handle" in rec:
            return get_backend(rec["backend"]), rec["handle"]
        if ep is not None and ep.handle is not None:
            # endpoints share the lifecycle hooks: pause gates serving
            # at a batch-step boundary, resume reopens it
            return get_backend("serving"), ep.handle
        raise KeyError(job_id)

    def pause_training(self, job_id: str):
        backend, handle = self._handle(job_id)
        backend.pause(handle)

    def resume_training(self, job_id: str, **kw):
        backend, handle = self._handle(job_id)
        backend.resume(handle, **kw)

    def checkpoint_training(self, job_id: str):
        """Ask the running job to checkpoint at its next step boundary."""
        backend, handle = self._handle(job_id)
        backend.checkpoint(handle)

    def rescale_training(self, job_id: str) -> Dict:
        """Elastic rescale: requeue the job's task groups exactly like a
        preemption. The next incarnation rebuilds through the backend's
        per-incarnation path (the pjit gang rebuilds its step and
        restores the latest checkpoint; the software-PS learner group
        re-forms around the PS) against whatever capacity now exists."""
        if job_id not in self.trainings:
            raise KeyError(job_id)
        for app_id in self.lcm._app_ids(job_id):
            self.scheduler.preempt_app(app_id)
        return {"training_id": job_id, "status": self.lcm.monitor(job_id)}

    def training_logs(self, job_id: str, member: Optional[str] = None
                      ) -> List[str]:
        if member is None:
            # first member of the job's primary group (learner-0 for
            # software-ps, worker-0 for pjit)
            roles = self.lcm.job_spec(job_id).get("groups") or ["learner"]
            role = next((r for r in roles if r != "ps"), "learner")
            member = f"{role}-0"
        base = f"/dlaas/jobs/{job_id}/members/{member}/log"
        try:
            names = self.zk.children(base)
        except NoNodeError:
            return []
        out = []
        for n in names:
            data, _ = self.zk.get(f"{base}/{n}")
            out.append(data.decode())
        return out

    def training_metrics(self, job_id: str) -> str:
        return self.metrics.to_json(job_id)

    # ------------------------------------------------------- observability
    def _known_job(self, job_id: str) -> bool:
        with self._lock:
            if job_id in self.trainings or job_id in self.endpoints:
                return True
        return self.tracer.has_trace(job_id)

    def training_timeline(self, job_id: str) -> Dict:
        """The job's merged trace timeline — lifecycle phase spans,
        instrumentation spans, recovery/relaunch events, plus the
        overlapping slice of cluster events (GET
        /v1/trainings/<id>/timeline, ``dlaas train timeline``)."""
        if not self._known_job(job_id):
            raise KeyError(job_id)
        self.tracer.trace_of(job_id)   # pre-observability record: mint
        return self.tracer.timeline(job_id)

    def prometheus_text(self) -> str:
        """Platform-wide metrics in Prometheus text exposition format
        (GET /metrics)."""
        return _prom_text(self)

    def alerts(self) -> Dict:
        """Active/recent alerts + the remediation log (GET /v1/alerts,
        ``dlaas alerts``)."""
        return self.health.alert_report()

    def alert_stream(self):
        """Live alert/remediation subscription for ``alerts?follow=1``.
        Caller must ``health.alerts.unsubscribe`` it when done."""
        return self.health.alerts.stream()

    def slo_status(self) -> List[Dict]:
        """Every SLO tracker's current burn-rate evaluation
        (GET /v1/slo, ``dlaas slo``)."""
        return self.health.slo_status()

    def log_stream(self, job_id: str):
        """Structured-log tail + live subscription for streaming
        (``?follow=1``). Caller must ``loghub.unsubscribe`` the returned
        stream when the client disconnects."""
        if not self._known_job(job_id):
            raise KeyError(job_id)
        return self.loghub.tail(job_id), self.loghub.subscribe(job_id)

    def metric_stream(self, job_id: str):
        """Live metric-record subscription for streaming. Caller must
        ``metrics.unsubscribe_stream`` it when done."""
        if not self._known_job(job_id):
            raise KeyError(job_id)
        return self.metrics.stream(job_id)

    def download_model(self, job_id: str) -> bytes:
        return self.storage.download("results", job_id,
                                     "trained_model.npy")

    # -------------------------------------------------- serving endpoints
    def deploy_endpoint(self, *, from_training: Optional[str] = None,
                        arch: Optional[str] = None, capacity: int = 2,
                        max_queue: int = 16, max_new: int = 16,
                        max_seq: Optional[int] = None, gpus: int = 1,
                        memory_mb: int = 1024,
                        eos_id: Optional[int] = None, seed: int = 0,
                        user: str = "anon", tenant: Optional[str] = None,
                        priority: int = 0,
                        idempotency_key: Optional[str] = None) -> Dict:
        """Deploy an inference endpoint — from a COMPLETED training job
        (weights from its results/checkpoint) or straight from an arch
        (fresh init; load-testing path). The endpoint is a job: it flows
        through admission control, the fair-share queue and the LCM like
        a training, and its engine serves until drained."""
        if idempotency_key is not None:
            prev = self._idem_check(idempotency_key)
            if prev is not None:
                return prev
        self._meter(user)
        if from_training is not None:
            with self._lock:
                rec = self.trainings.get(from_training)
            if rec is None:
                raise KeyError(from_training)
            if self.lcm.job_state(from_training) != "COMPLETED":
                raise ValueError(
                    f"training {from_training} is not COMPLETED "
                    f"({self.lcm.job_state(from_training)})")
            fw_name, fw_cfg = resolve_framework(rec["manifest"])
            if fw_name != "repro-lm":
                raise ValueError(
                    f"only model-zoo ('repro-lm') trainings can be "
                    f"served; {from_training} used {fw_name!r}")
            arch = fw_cfg.get("arch", "stablelm-1.6b")
        elif arch is not None:
            from repro_torch.configs.registry import get_arch
            try:
                get_arch(arch)
            except KeyError as e:
                raise ValueError(str(e)) from None
        else:
            raise ValueError(
                "deploy needs 'from_training' (a completed training id) "
                "or 'arch' (a model-zoo architecture)")
        tenant = tenant or user
        endpoint_id = f"endpoint-{uuid.uuid4().hex[:8]}"
        # everything re-deploy needs, persisted with the job record so a
        # recovered core can rebuild the endpoint from znodes alone
        args = {"from_training": from_training, "arch": arch,
                "capacity": int(capacity), "max_queue": int(max_queue),
                "max_new": int(max_new), "max_seq": max_seq,
                "gpus": int(gpus), "memory_mb": int(memory_mb),
                "eos_id": eos_id, "seed": int(seed),
                "tenant": tenant, "priority": int(priority)}
        if idempotency_key is not None and \
                not self._idem_reserve(idempotency_key, "endpoint",
                                       endpoint_id):
            prev = self._idem_check(idempotency_key)
            if prev is None:
                raise ValueError("concurrent request with the same "
                                 "Idempotency-Key failed; retry")
            return prev
        try:
            ep = self._launch_endpoint(endpoint_id, args, user)
        except Exception:
            self._idem_abort(idempotency_key)
            raise
        resp = {"endpoint_id": endpoint_id, "arch": arch,
                "tenant": tenant, "source_training": from_training,
                "state": ep.state()}
        if idempotency_key is not None:
            self._idem_complete(idempotency_key, "endpoint", endpoint_id,
                                resp)
        return resp

    def _launch_endpoint(self, endpoint_id: str, args: Dict,
                         user: str) -> ModelEndpoint:
        """Plan + admit + persist + launch one endpoint. Shared between
        first deployment and crash-recovery re-deploy (same endpoint id,
        args straight from the persisted record)."""
        backend = get_backend("serving")
        # first deploy mints a trace here; recovery re-registered the
        # persisted id already, so trace_of returns it unchanged
        trace_id = self.tracer.trace_of(endpoint_id)
        spec = JobSpec(job_id=endpoint_id, learners=1,
                       gpus_per_learner=int(args["gpus"]),
                       memory_mb=int(args["memory_mb"]),
                       tenant=args["tenant"],
                       priority=int(args["priority"]))
        manifest = {
            "framework": {"name": "repro-lm", "arch": args["arch"]},
            "source_training": args["from_training"],
            "serving": {"capacity": int(args["capacity"]),
                        "max_queue": int(args["max_queue"]),
                        "max_new": int(args["max_new"]),
                        "max_seq": args["max_seq"],
                        "eos_id": args["eos_id"],
                        "seed": int(args["seed"])}}
        with self.tracer.span(endpoint_id, "plan", backend="serving"):
            plan = backend.plan(spec, manifest, self._ctx(manifest))
        plan.meta["trace_id"] = trace_id
        with self.tracer.span(endpoint_id, "admission",
                              tenant=args["tenant"]):
            self.scheduler.check_admission(args["tenant"],
                                           plan.total_resources())
        self._zset(f"/dlaas/jobs/{endpoint_id}/record",
                   {"kind": "endpoint", "args": args, "user": user,
                    "created": time.time(), "trace_id": trace_id})
        ep = ModelEndpoint(endpoint_id, plan, user=user)
        with self._lock:
            self.endpoints[endpoint_id] = ep
        try:
            ep.handle = backend.launch(plan, self.lcm)
        except QuotaExceeded:
            with self._lock:
                self.endpoints.pop(endpoint_id, None)
            self.lcm.kill(endpoint_id)
            try:
                self.zk.delete(f"/dlaas/jobs/{endpoint_id}/record")
            except NoNodeError:
                pass
            raise
        return ep

    def _endpoint(self, endpoint_id: str) -> ModelEndpoint:
        with self._lock:
            ep = self.endpoints.get(endpoint_id)
        if ep is None:
            raise KeyError(endpoint_id)
        return ep

    def list_endpoints(self, user: str = "anon") -> List[Dict]:
        self._meter(user)
        with self._lock:
            eps = list(self.endpoints.values())
        return [{"endpoint_id": ep.endpoint_id, "arch": ep.arch,
                 "state": ep.state(),
                 "source_training": ep.source_training} for ep in eps]

    def endpoint_status(self, endpoint_id: str) -> Dict:
        ep = self._endpoint(endpoint_id)
        state = self.lcm.monitor(endpoint_id)
        if state in _TERMINAL:
            ep.finalize(self.metrics)
        out = ep.status(job_state=state)
        if state in ("QUEUED", "PREEMPTED"):
            out["queue"] = self.lcm.queue_info(endpoint_id)
        return out

    def predict(self, endpoint_id: str, tokens, *,
                max_new: Optional[int] = None,
                deadline_s: Optional[float] = None, user: str = "anon",
                timeout: float = 120.0) -> Dict:
        """Submit one request and block for its completion. Raises
        QueueFull (→429) on admission overflow, EndpointClosed (→409)
        when draining/stopped, DeadlineExceeded (→504) when the request
        misses its deadline."""
        self._meter(user)
        ep = self._endpoint(endpoint_id)
        t0 = time.time()
        req = ep.engine.submit(tokens, max_new=max_new,
                               deadline_s=deadline_s)
        wait_s = (deadline_s + 5.0) if deadline_s is not None else timeout
        req.wait(timeout=wait_s)
        if req.status == "DONE":
            return {"endpoint_id": endpoint_id, "request_id": req.req_id,
                    "tokens": req.tokens,
                    "n_prompt": int(req.prompt.size),
                    "latency_s": round(time.time() - t0, 4)}
        if req.status == "EXPIRED":
            raise DeadlineExceeded(
                f"request {req.req_id} missed its deadline")
        if req.status == "FAILED":
            raise RuntimeError(f"request {req.req_id} failed: "
                               f"{req.error or 'endpoint stopped'}")
        raise DeadlineExceeded(
            f"request {req.req_id} still {req.status} after {wait_s:.0f}s "
            f"(endpoint {ep.state()})")

    def stop_endpoint(self, endpoint_id: str) -> Dict:
        """Stop an endpoint. Serving endpoints drain gracefully (finish
        in-flight + queued work, then the server task exits and the LCM
        reclaims resources). An endpoint that never started serving
        (still QUEUED/PREEMPTED/placing) is killed outright — draining
        alone would leave the dead job competing in the fair-share
        queue forever."""
        ep = self._endpoint(endpoint_id)
        ep.drain()
        if not ep.engine.ready and \
                self.lcm.job_state(endpoint_id) not in (
                    "COMPLETED", "FAILED", "KILLED"):
            self.lcm.kill(endpoint_id)
            ep.finalize(self.metrics)
        return {"endpoint_id": endpoint_id, "state": ep.state()}

    # ---------------------------------------------------------------- helpers
    def wait_for(self, job_id: str, timeout: float = 60.0) -> str:
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = self.lcm.monitor(job_id)
            if st in ("COMPLETED", "FAILED", "KILLED"):
                return st
            time.sleep(0.05)
        return self.lcm.job_state(job_id)
