"""Simulated cluster + Mesos/Marathon-style scheduler (paper §Platform
Services), with the GPU health checking the paper lists as future work.

The datacenter is simulated (nodes, GPUs, failures); the scheduling logic,
state machines, retries and health checks are real code under test. Time
advances via ``tick()`` so tests are deterministic; the REST service runs
a background ticker thread.

Reproduces — and then fixes — the colloquium incident: "GPUs of one of the
machines became unresponsive but our resource manager failed to recognize
this fact and kept scheduling jobs to this node ... a few jobs failed to
start". With ``health_checks=False`` the scheduler behaves like the paper's
system (tasks placed on a bad node fail to start); with ``True`` the
HealthChecker drains the node first.

Copied from ``repro/platform/cluster.py`` unchanged apart from import paths
and one difference: ``_UserError`` and ``_Preempted`` are not defined here
but are ``repro_torch.errors``' ``UserError`` and ``Preempted``, the classes
the port's ``Watchdog`` re-raises. Classes of its own would make
``_run_task`` restart a learner that hit a user error instead of failing
the job. The port imports nothing of ``repro``.

Its logger is named under the port's own ``"repro_torch"`` tree (see
``observability/log.py``), so in a process that loads both packages the
reference's log hubs receive none of the port's records.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.errors import Preempted as _Preempted
from repro_torch.errors import UserError as _UserError

log = logging.getLogger("repro_torch.cluster")


@dataclass
class Resources:
    cpus: float = 1.0
    gpus: int = 0
    memory_mb: int = 1024

    def fits(self, other: "Resources") -> bool:
        return (self.cpus <= other.cpus and self.gpus <= other.gpus
                and self.memory_mb <= other.memory_mb)

    def sub(self, other: "Resources"):
        self.cpus -= other.cpus
        self.gpus -= other.gpus
        self.memory_mb -= other.memory_mb

    def add(self, other: "Resources"):
        self.cpus += other.cpus
        self.gpus += other.gpus
        self.memory_mb += other.memory_mb


# node lifecycle states (k8s-style). Static seed nodes start READY;
# nodes joining through Cluster.register_node start REGISTERING and
# must heartbeat before they accept work. DEAD is reached by an
# explicit failure or by missing heartbeats.
NODE_REGISTERING, NODE_READY, NODE_DRAINING, NODE_DEAD = (
    "REGISTERING", "READY", "DRAINING", "DEAD")


@dataclass
class Node:
    name: str
    capacity: Resources
    free: Resources = None
    alive: bool = True
    draining: bool = False
    gpu_responsive: bool = True        # the colloquium failure mode
    state: str = NODE_READY
    spot: bool = False                 # preemptible: cheaper fair-share
    cost_factor: float = 1.0           # fair-share cost multiplier
    managed: bool = False              # heartbeat-supervised membership
    last_heartbeat: int = 0            # cluster logical clock
    partitioned: bool = False          # network fault: heartbeats lost
    heartbeat_delay: int = 0           # ticks the agent stays silent

    def __post_init__(self):
        if self.free is None:
            self.free = Resources(self.capacity.cpus, self.capacity.gpus,
                                  self.capacity.memory_mb)

    @property
    def schedulable(self) -> bool:
        return self.state == NODE_READY


# task states (Marathon-like)
STAGING, STARTING, RUNNING, FINISHED, FAILED, KILLED, LOST, PREEMPTED = (
    "TASK_STAGING", "TASK_STARTING", "TASK_RUNNING", "TASK_FINISHED",
    "TASK_FAILED", "TASK_KILLED", "TASK_LOST", "TASK_PREEMPTED")


@dataclass
class Task:
    task_id: str
    app_id: str
    resources: Resources
    state: str = STAGING
    node: Optional[str] = None
    restarts: int = 0
    message: str = ""
    # run(task) -> None executes the workload (learner thread entry)
    run: Optional[Callable] = None
    # set by the scheduler when the task must yield its resources; task
    # bodies observe it (Watchdog.maybe_preempt) and exit cleanly
    preempt_event: threading.Event = field(
        default_factory=threading.Event)


@dataclass
class App:
    """A Marathon 'app': N identical tasks (e.g. the learners of a job)."""
    app_id: str
    resources: Resources
    count: int
    max_restarts: int = 3
    tasks: Dict[str, Task] = field(default_factory=dict)
    on_state: Optional[Callable[[Task], None]] = None
    run: Optional[Callable] = None
    tenant: str = "default"
    priority: int = 0
    # gang apps (SPMD pjit workers, serving endpoints) lose/migrate all
    # tasks as one unit: a node dying or draining under one member
    # preempts the whole app so it reincarnates together
    gang: bool = False


class Cluster:
    """Node membership + allocation. Time is a logical clock advanced by
    ``tick()`` (driven from Scheduler.tick): heartbeats, their expiry and
    every lifecycle transition are expressed in ticks, so a seeded fault
    schedule replays to an identical transition log."""

    #: ticks a managed node may stay silent before it is declared DEAD
    HEARTBEAT_TIMEOUT = 3

    def __init__(self, nodes: List[Node],
                 heartbeat_timeout: Optional[int] = None):
        self.nodes: Dict[str, Node] = {n.name: n for n in nodes}
        self.clock = 0
        self.heartbeat_timeout = heartbeat_timeout or self.HEARTBEAT_TIMEOUT
        # ordered lifecycle log: (tick, node, from_state, to_state, reason)
        self.transitions: List[tuple] = []
        self._agents: Dict[str, object] = {}     # name -> NodeWatchdog
        self._listeners: List[Callable] = []     # capacity-change subs
        self._lock = threading.RLock()

    # ---- lifecycle state machine ------------------------------------------
    def _transition(self, node: Node, state: str, reason: str):
        if node.state == state:
            return
        prev = node.state
        node.state = state
        node.alive = state not in (NODE_DEAD,)
        node.draining = state == NODE_DRAINING
        self.transitions.append((self.clock, node.name, prev, state,
                                 reason))
        if state in (NODE_READY, NODE_DEAD):
            self._notify()

    def _notify(self):
        for cb in list(self._listeners):
            try:
                cb(self)
            except Exception as e:       # observers must not wedge ticks
                log.warning("capacity listener failed: %s: %s",
                            type(e).__name__, e)

    def subscribe(self, cb: Callable[["Cluster"], None]):
        """Register a capacity-change listener (fired when a node becomes
        READY or DEAD — the elastic-rescale trigger)."""
        with self._lock:
            self._listeners.append(cb)

    def register_node(self, node: Node, *, spot: bool = False,
                      cost_factor: Optional[float] = None) -> Node:
        """Elastic join: the node enters REGISTERING and becomes READY on
        its first heartbeat (published by its NodeWatchdog each tick)."""
        from repro_torch.platform.watchdog import NodeWatchdog
        with self._lock:
            node.managed = True
            node.spot = spot
            if cost_factor is not None:
                node.cost_factor = cost_factor
            elif spot:
                node.cost_factor = 0.5     # preemptible capacity is cheap
            node.state = NODE_REGISTERING
            node.last_heartbeat = self.clock
            self.nodes[node.name] = node
            self._agents[node.name] = NodeWatchdog(self, node.name)
            self.transitions.append((self.clock, node.name, "-",
                                     NODE_REGISTERING, "node joined"))
            return node

    def remove_node(self, name: str, reason: str = "scaled down") -> bool:
        """Remove a node that holds no work (fully free or DEAD)."""
        with self._lock:
            n = self.nodes.get(name)
            if n is None:
                return False
            busy = n.free.gpus != n.capacity.gpus or \
                n.free.cpus != n.capacity.cpus
            if n.state != NODE_DEAD and busy:
                return False
            self.transitions.append((self.clock, name, n.state,
                                     "REMOVED", reason))
            self.nodes.pop(name)
            self._agents.pop(name, None)
            self._notify()
            return True

    def node_heartbeat(self, name: str):
        """Heartbeat from a node's watchdog agent. Partitioned nodes'
        beats are dropped on the floor — that IS the partition."""
        with self._lock:
            n = self.nodes.get(name)
            if n is None or n.partitioned or n.state == NODE_DEAD:
                return
            n.last_heartbeat = self.clock
            if n.state == NODE_REGISTERING:
                self._transition(n, NODE_READY, "first heartbeat")

    def drain_node(self, name: str, reason: str = "drain requested"):
        with self._lock:
            n = self.nodes[name]
            if n.state in (NODE_READY, NODE_REGISTERING):
                self._transition(n, NODE_DRAINING, reason)

    def tick(self):
        """Advance the logical clock one step: pump node agents (each
        live, un-partitioned managed node self-reports) and expire the
        heartbeats of nodes that stayed silent too long."""
        with self._lock:
            self.clock += 1
            for agent in list(self._agents.values()):
                agent.beat()
            for n in self.nodes.values():
                if n.managed and n.state != NODE_DEAD and \
                        self.clock - n.last_heartbeat > \
                        self.heartbeat_timeout:
                    self._transition(
                        n, NODE_DEAD,
                        f"missed heartbeats for "
                        f"{self.clock - n.last_heartbeat} ticks")

    # ---- fault injection --------------------------------------------------
    def fail_node(self, name: str):
        with self._lock:
            self._transition(self.nodes[name], NODE_DEAD, "node failed")

    def recover_node(self, name: str):
        with self._lock:
            n = self.nodes[name]
            n.partitioned = False
            n.heartbeat_delay = 0
            n.last_heartbeat = self.clock
            n.free = Resources(n.capacity.cpus, n.capacity.gpus,
                               n.capacity.memory_mb)
            self._transition(n, NODE_READY, "node recovered")

    def partition_node(self, name: str):
        """Network partition: the node keeps running its tasks but its
        heartbeats no longer arrive; after ``heartbeat_timeout`` ticks
        the cluster declares it DEAD (managed nodes only)."""
        with self._lock:
            self.nodes[name].partitioned = True

    def heal_partition(self, name: str):
        with self._lock:
            n = self.nodes[name]
            n.partitioned = False
            n.last_heartbeat = self.clock

    def delay_heartbeats(self, name: str, ticks: int):
        """The node's agent stays silent for ``ticks`` ticks (slow node /
        GC pause); longer than the timeout means a spurious DEAD."""
        with self._lock:
            self.nodes[name].heartbeat_delay = int(ticks)

    def make_gpu_unresponsive(self, name: str):
        with self._lock:
            self.nodes[name].gpu_responsive = False

    # ---- allocation ---------------------------------------------------------
    def allocate(self, res: Resources, *,
                 schedulable: Callable[[Node], bool]) -> Optional[str]:
        with self._lock:
            # best-fit: fewest free GPUs that still fit (bin packing);
            # spot nodes first within a fit class, so cheap capacity
            # absorbs load and on-demand nodes can drain when idle
            cands = [n for n in self.nodes.values()
                     if n.schedulable and res.fits(n.free)
                     and schedulable(n)]
            if not cands:
                return None
            cands.sort(key=lambda n: (n.free.gpus, n.free.cpus,
                                      not n.spot, n.name))
            node = cands[0]
            node.free.sub(res)
            return node.name

    def release(self, name: str, res: Resources):
        with self._lock:
            if name in self.nodes:
                self.nodes[name].free.add(res)

    def idle_fraction(self) -> float:
        with self._lock:
            tot = sum(n.capacity.gpus for n in self.nodes.values()) or 1
            free = sum(n.free.gpus for n in self.nodes.values()
                       if n.alive and not n.draining)
            return free / tot

    def free_gpus(self) -> int:
        with self._lock:
            return sum(n.free.gpus for n in self.nodes.values()
                       if n.schedulable)

    def snapshot(self) -> Dict:
        """Status-surface view: per-node lifecycle + the transition log
        tail (REST GET /v1/cluster and the CLI render this)."""
        with self._lock:
            return {
                "clock": self.clock,
                "nodes": [{
                    "name": n.name, "state": n.state, "spot": n.spot,
                    "cost_factor": n.cost_factor, "managed": n.managed,
                    "gpus": n.capacity.gpus, "free_gpus": n.free.gpus,
                    "cpus": n.capacity.cpus, "free_cpus": n.free.cpus,
                    "heartbeat_age": (self.clock - n.last_heartbeat
                                      if n.managed else None),
                } for n in sorted(self.nodes.values(),
                                  key=lambda n: n.name)],
                "transitions": [
                    {"tick": t, "node": n, "from": a, "to": b,
                     "reason": r}
                    for t, n, a, b, r in self.transitions[-50:]],
            }


class HealthChecker:
    """Probes GPU responsiveness and drains bad nodes — the fix for the
    paper's admitted gap ('we are working to periodically check the GPU
    status and take the node offline')."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.events: List[str] = []

    def probe(self):
        for n in list(self.cluster.nodes.values()):
            if n.alive and not n.gpu_responsive and not n.draining:
                self.cluster.drain_node(n.name, "unresponsive GPU")
                self.events.append(f"drained {n.name}: unresponsive GPU")


class Scheduler:
    """Marathon-style app/task manager over the cluster.

    Multi-tenant: pending tasks live in a FairShareQueue (platform/
    queue.py) ordered by priority, then deficit-weighted fair-share,
    then FIFO. When a higher-priority task cannot be placed anywhere,
    whole lower-priority jobs are preempted (released back to the queue;
    their learners resume from the last checkpoint on re-placement).
    """

    def __init__(self, cluster: Cluster, *, health_checks: bool = True,
                 preemption: bool = True):
        from repro_torch.platform.queue import FairShareQueue
        self.cluster = cluster
        self.health = HealthChecker(cluster) if health_checks else None
        self.preemption = preemption
        self.apps: Dict[str, App] = {}
        self.queue = FairShareQueue()
        self._seq = itertools.count()
        self._lock = threading.RLock()
        self._threads: Dict[str, threading.Thread] = {}
        # optional tick-driven companions (attached by the service /
        # chaos harness): an Autoscaler, a FaultInjector, and the SLO
        # HealthController (platform/health.py; 'health' is the node
        # HealthChecker above — distinct concerns, distinct attrs)
        self.autoscaler = None
        self.faults = None
        self.health_controller = None

    # ---- submission -----------------------------------------------------
    def submit(self, app: App, *, tenant: Optional[str] = None,
               priority: Optional[int] = None) -> App:
        with self._lock:
            if tenant is not None:
                app.tenant = tenant
            if priority is not None:
                app.priority = int(priority)
            # reject apps whose total demand can never fit in the quota
            total = Resources(app.resources.cpus * app.count,
                              app.resources.gpus * app.count,
                              app.resources.memory_mb * app.count)
            self.queue.check_admission(app.tenant, total)
            for i in range(app.count):
                t = Task(task_id=f"{app.app_id}.{i}", app_id=app.app_id,
                         resources=app.resources, run=app.run)
                app.tasks[t.task_id] = t
                self.queue.push(t, app.tenant, app.priority)
            # publish only once tasks is fully populated: monitor() and
            # REST handlers iterate app.tasks without taking our lock
            self.apps[app.app_id] = app
        return app

    def kill_app(self, app_id: str):
        with self._lock:
            app = self.apps.get(app_id)
            if not app:
                return
            for t in app.tasks.values():
                if t.state in (STAGING, STARTING, RUNNING, PREEMPTED):
                    t.preempt_event.set()     # running bodies exit early
                    self._release(t)
                    self._set_state(t, KILLED, "killed by user/LCM")
            self.queue.remove_app(app_id)

    # ---- multi-tenancy ---------------------------------------------------
    def configure_tenant(self, name: str, **kw):
        """Create/update a tenant (weight and/or per-dimension quota);
        None / omitted fields are left unchanged."""
        with self._lock:
            return self.queue.configure_tenant(name, **kw)

    def queue_status(self) -> Dict:
        with self._lock:
            return self.queue.status()

    def tenant_snapshots(self) -> Dict[str, Dict]:
        """Per-tenant snapshot dicts (the durable-billing mirror reads
        these every tick and persists the ones that changed)."""
        with self._lock:
            return {n: t.snapshot() for n, t in self.queue.tenants.items()}

    def restore_tenant(self, name: str, snap: Dict):
        """Rehydrate one tenant from a persisted snapshot (recovery)."""
        with self._lock:
            return self.queue.restore_tenant(name, snap)

    def queue_position(self, app_id: str) -> Optional[int]:
        with self._lock:
            return self.queue.position(app_id)

    def check_admission(self, tenant: str, demand: Resources):
        with self._lock:
            self.queue.check_admission(tenant, demand)

    def _release(self, t: Task):
        """Release a task's node resources and credit its tenant."""
        if t.node:
            self.cluster.release(t.node, t.resources)
            t.node = None
        app = self.apps.get(t.app_id)
        if app:
            self.queue.credit(app.tenant, t)

    # ---- state machine ----------------------------------------------------
    def _set_state(self, t: Task, state: str, msg: str = ""):
        t.state = state
        t.message = msg
        app = self.apps.get(t.app_id)
        if app and app.on_state:
            try:
                app.on_state(t)
            except Exception as e:
                # observer bugs must not wedge the scheduler, but they
                # must be diagnosable
                log.warning("on_state callback for %s failed: %s: %s",
                            t.task_id, type(e).__name__, e)

    def task_failed(self, task_id: str, msg: str = "",
                    user_error: bool = False):
        """Report a task failure. User errors are NOT restarted (paper:
        'restarts failed jobs but not when the job fails due to ... an
        error in the code')."""
        with self._lock:
            t = self._find(task_id)
            if t is None:
                return
            app = self.apps[t.app_id]
            if t.state == PREEMPTED:
                # already requeued by preempt(); only a user error (which
                # would fail again on restart) terminates it
                if user_error:
                    self.queue.remove_task(t.task_id)
                    self._set_state(t, FAILED, msg)
                return
            if t.state in (FINISHED, FAILED, KILLED):
                return   # terminal: a killed task must not be resurrected
            self._release(t)
            self._set_state(t, FAILED, msg)
            if not user_error and t.restarts < app.max_restarts:
                t.restarts += 1
                self._set_state(t, STAGING, f"restart #{t.restarts}")
                self.queue.push(t, app.tenant, app.priority)

    def task_finished(self, task_id: str):
        with self._lock:
            t = self._find(task_id)
            if t is None:
                return
            if t.state == PREEMPTED:
                # raced to completion before it noticed the preemption —
                # honor the result instead of re-running it
                self.queue.remove_task(t.task_id)
            elif t.state in (FINISHED, FAILED, KILLED):
                return   # terminal: don't relabel a killed/failed task
            self._release(t)
            self._set_state(t, FINISHED)

    def _find(self, task_id: str) -> Optional[Task]:
        for app in self.apps.values():
            if task_id in app.tasks:
                return app.tasks[task_id]
        return None

    # ---- preemption ---------------------------------------------------------
    def preempt(self, task_id: str):
        """Release a running task back to the queue. The task body sees
        ``preempt_event`` (via Watchdog.maybe_preempt), exits at the next
        step, and resumes from its last checkpoint when re-placed."""
        with self._lock:
            t = self._find(task_id)
            if t is None:
                return
            if self._preempt_task(t):
                self.queue.tenant(
                    self.apps[t.app_id].tenant).preemptions += 1

    def _preempt_task(self, t: Task) -> bool:
        if t.state not in (STARTING, RUNNING):
            return False
        app = self.apps[t.app_id]
        t.preempt_event.set()
        self._release(t)
        self._set_state(t, PREEMPTED, "preempted by higher-priority job")
        self.queue.push(t, app.tenant, app.priority)
        return True

    def preempt_app(self, app_id: str):
        """Preempt a whole job (all running tasks) — gang semantics, so a
        BSP job never limps along with half its learners evicted. Counts
        as ONE preemption event for the tenant, however many tasks."""
        with self._lock:
            app = self.apps.get(app_id)
            if not app:
                return
            evicted = sum(1 for t in app.tasks.values()
                          if self._preempt_task(t))
            if evicted:
                self.queue.tenant(app.tenant).preemptions += 1

    def _preempt_for(self, entry) -> bool:
        """Free room for ``entry`` by preempting strictly-lower-priority
        jobs, lowest priority first, fewest jobs possible. Returns True
        if enough resources were freed on some node."""
        res = entry.task.resources
        free = {n.name: Resources(n.free.cpus, n.free.gpus,
                                  n.free.memory_mb)
                for n in self.cluster.nodes.values()
                if n.alive and not n.draining
                and (res.gpus == 0 or n.gpu_responsive)}
        if not free:
            return False
        victims = sorted(
            (a for a in self.apps.values()
             if a.priority < entry.priority
             and a.app_id != entry.task.app_id
             and any(t.state == RUNNING and t.node
                     for t in a.tasks.values())),
            key=lambda a: a.priority)
        chosen = []
        for app in victims:
            chosen.append(app)
            for t in app.tasks.values():
                if t.state == RUNNING and t.node in free:
                    free[t.node].add(t.resources)
            target = next((name for name, f in free.items()
                           if res.fits(f)), None)
            if target is not None:
                # evict only jobs actually holding the target node —
                # apps visited along the way that contributed nothing
                # there would lose progress for no resource gain
                for a in chosen:
                    if any(t.state == RUNNING and t.node == target
                           for t in a.tasks.values()):
                        self.preempt_app(a.app_id)
                return True
        return False

    # ---- scheduling tick ---------------------------------------------------
    def tick(self):
        """One scheduling round: clock/heartbeats, fault injection,
        health probe, node-failure detection, drain migration, fair-share
        deficit refresh, queue placement (with preemption), autoscaling."""
        with self._lock:
            self.cluster.tick()
            if self.faults is not None:
                self.faults.step(self)
            if self.health:
                self.health.probe()
            # detect lost tasks on dead nodes -> reschedule (paper: 'if a
            # node fails, the cluster manager automatically restarts the
            # jobs on that node on a different node')
            for app in self.apps.values():
                lost_gang = False
                for t in app.tasks.values():
                    if t.state == RUNNING and t.node and \
                            (t.node not in self.cluster.nodes or
                             not self.cluster.nodes[t.node].alive):
                        self._release(t)
                        self._set_state(t, LOST, "node failed")
                        # the body thread (if any) outlives its node in
                        # the simulation: tell it to yield so the next
                        # incarnation can start
                        t.preempt_event.set()
                        if t.restarts < app.max_restarts:
                            t.restarts += 1
                            lost_gang = lost_gang or app.gang
                            self._set_state(t, STAGING,
                                            f"restart #{t.restarts}")
                            self.queue.push(t, app.tenant, app.priority)
                if lost_gang:
                    # an SPMD gang cannot limp along with a lost member:
                    # evict the survivors too, so the whole gang
                    # reincarnates together (from the last checkpoint)
                    self.preempt_app(app.app_id)
            self._migrate_draining()
            self.queue.refresh_deficits()
            self._place_round()
            if self.autoscaler is not None:
                self.autoscaler.step()
        # the SLO health pass runs OUTSIDE the placement lock: its
        # remediations re-enter scheduler methods (preempt/preempt_app)
        # and touch metrics/LCM surfaces with their own locks
        hc = self.health_controller
        if hc is not None:
            try:
                hc.step(self)
            except Exception as e:
                log.warning("health controller step failed: %s: %s",
                            type(e).__name__, e)

    def _migrate_draining(self):
        """Elastic rescale on shrinking capacity: work running on a
        DRAINING node is requeued exactly like preemption — gang apps as
        one unit — and resumes from its last checkpoint elsewhere."""
        draining = {n.name for n in self.cluster.nodes.values()
                    if n.draining and n.alive}
        if not draining:
            return
        for app in list(self.apps.values()):
            on_node = [t for t in app.tasks.values()
                       if t.state == RUNNING and t.node in draining]
            if not on_node:
                continue
            if app.gang:
                self.preempt_app(app.app_id)
            else:
                evicted = sum(1 for t in on_node if self._preempt_task(t))
                if evicted:
                    self.queue.tenant(app.tenant).preemptions += 1

    def _place_round(self):
        # re-sort after every successful placement so deficit spending
        # takes effect immediately (strict deficit round-robin)
        while True:
            if not any(self._try_place(e) for e in self.queue.ordered()):
                break

    def _try_place(self, entry) -> bool:
        t = entry.task
        if t.state not in (STAGING, PREEMPTED):
            self.queue.remove(entry)           # stale (killed/failed)
            return False
        if not self.queue.within_quota(entry.tenant, t.resources):
            return False                       # held by tenant quota
        th = self._threads.get(t.task_id)
        if th is not None and th.is_alive():
            return False    # previous incarnation still winding down
        res = t.resources
        node = self.cluster.allocate(res, schedulable=lambda n: True)
        if node is None and self.preemption and self._preempt_for(entry):
            node = self.cluster.allocate(res, schedulable=lambda n: True)
        if node is None:
            return False                       # backfill: try next entry
        self.queue.remove(entry)
        # preemptible capacity is billed (and spends fair-share deficit)
        # at the node's discounted cost factor
        self.queue.charge(entry.tenant, t,
                          cost=self.cluster.nodes[node].cost_factor)
        t.node = node
        t.preempt_event.clear()
        nd = self.cluster.nodes[node]
        if res.gpus > 0 and not nd.gpu_responsive:
            # the colloquium incident: placed on a bad node, the
            # container cannot initialize its GPUs
            self.cluster.release(node, res)
            t.node = None
            self.queue.refund(entry.tenant, t)   # don't burn fair share
            self._set_state(t, FAILED,
                            "GPUs unresponsive on node " + node)
            return True
        self._set_state(t, STARTING)
        self._launch(t)
        return True

    def _launch(self, t: Task):
        self._set_state(t, RUNNING)
        if t.run is not None:
            th = threading.Thread(target=self._run_task, args=(t,),
                                  daemon=True)
            self._threads[t.task_id] = th
            th.start()

    def _run_task(self, t: Task):
        try:
            t.run(t)
            self.task_finished(t.task_id)
        except _Preempted:
            pass    # preempt() already released + requeued the task
        except _UserError as e:
            self.task_failed(t.task_id, str(e), user_error=True)
        except Exception as e:  # infrastructure-ish error -> retry
            self.task_failed(t.task_id, f"{type(e).__name__}: {e}")

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for app in self.apps.values():
            for t in app.tasks.values():
                out[t.state] = out.get(t.state, 0) + 1
        return out


UserError = _UserError
Preempted = _Preempted
