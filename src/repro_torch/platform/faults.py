"""Deterministic fault-injection harness (chaos testing, per the
Dependability paper: node churn is the normal case, so the platform is
gated on fault drills rather than on luck).

A ``FaultSchedule`` is a plain list of ``FaultEvent``s — kill / drain /
partition / delay-heartbeats / recover a named node — each triggered
either at a cluster logical-clock tick (``at_tick``) or when a job's
training progress reaches a step (``at_step``, read from the members'
ZooKeeper heartbeats through the LCM). ``FaultSchedule.seeded`` derives
a schedule from a PRNG seed; because triggers are expressed in logical
ticks/steps and the injector runs inside ``Scheduler.tick()``, the same
seed replays to the same cluster transition log every time.

Wiring::

    sched.faults = FaultInjector(FaultSchedule.seeded(7, ["n0", "n1"]),
                                 lcm=lcm)
    # each sched.tick() now fires the events that came due

Copied from ``repro/platform/faults.py`` unchanged: the port imports
nothing of ``repro``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

KILL, DRAIN, PARTITION, DELAY, RECOVER, CRASH_CORE, SLOW = (
    "kill", "drain", "partition", "delay", "recover", "crash_core",
    "slow")


@dataclass(frozen=True)
class FaultEvent:
    kind: str                       # kill | drain | partition | delay |
                                    # recover | crash_core | slow
    node: str                       # crash_core/slow: ignored (use "")
    at_tick: Optional[int] = None   # cluster clock trigger
    at_step: Optional[int] = None   # job-progress trigger (needs job_id)
    job_id: Optional[str] = None
    duration: int = 0               # delay: silent ticks; slow: rounds
                                    # (0 = until the learner restarts)
    member: Optional[int] = None    # slow: victim learner slot
    seconds: float = 0.0            # slow: injected per-push sleep

    def describe(self) -> str:
        trig = (f"tick>={self.at_tick}" if self.at_tick is not None
                else f"{self.job_id}.step>={self.at_step}")
        if self.kind == SLOW:
            return (f"slow {self.job_id}/learner-{self.member or 0} "
                    f"by {self.seconds}s @ {trig}")
        tgt = self.node or "core"
        return f"{self.kind} {tgt} @ {trig}"


class FaultSchedule:
    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = list(events)

    @classmethod
    def seeded(cls, seed: int, nodes: Sequence[str], *,
               n_events: int = 3, horizon: int = 40,
               kinds: Sequence[str] = (KILL, DRAIN)) -> "FaultSchedule":
        """Derive a schedule from a seed: ``n_events`` faults over the
        first ``horizon`` ticks, uniformly over ``nodes`` x ``kinds``.
        Same seed + same arguments -> identical schedule."""
        rng = random.Random(seed)
        events = [FaultEvent(kind=rng.choice(list(kinds)),
                             node=rng.choice(list(nodes)),
                             at_tick=rng.randrange(1, max(2, horizon)))
                  for _ in range(n_events)]
        events.sort(key=lambda e: (e.at_tick, e.node, e.kind))
        return cls(events)

    @classmethod
    def seeded_straggler(cls, seed: int, job_id: str, n_learners: int, *,
                         at_step: int = 3, seconds: float = 0.08,
                         rounds: int = 0) -> "FaultSchedule":
        """One seeded straggler: once ``job_id`` reaches ``at_step``, a
        seed-chosen learner slot starts sleeping ``seconds`` per PS push
        (the health-drill fault). Same seed -> same victim slot."""
        victim = random.Random(seed).randrange(max(1, n_learners))
        return cls([FaultEvent(SLOW, "", at_step=at_step, job_id=job_id,
                               member=victim, seconds=seconds,
                               duration=rounds)])

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)


class FaultInjector:
    """Applies a FaultSchedule from inside the scheduler tick. Step
    triggers are the LCM hook: the injector reads the job's member
    heartbeats (``LifecycleManager.max_step``) so an event like "kill
    the learner's node once step 15 is reached" fires at the same
    training progress on every run."""

    def __init__(self, schedule: FaultSchedule, lcm=None,
                 metrics=None, core=None, tracer=None):
        self.schedule = schedule
        self.lcm = lcm
        self.metrics = metrics
        self.core = core            # crash_core target (DLaaSCore)
        self.tracer = tracer        # fault firings land in the timeline
        self._pending: List[FaultEvent] = list(schedule)
        self.fired: List[Dict] = []

    def done(self) -> bool:
        return not self._pending

    def step(self, scheduler):
        cluster = scheduler.cluster
        due = []
        for ev in self._pending:
            if ev.at_step is not None:
                step = self._job_step(ev.job_id)
                if step is not None and step >= ev.at_step:
                    due.append(ev)
            elif ev.at_tick is not None and cluster.clock >= ev.at_tick:
                due.append(ev)
        for ev in due:
            self._pending.remove(ev)
            applied = self._fire(ev, cluster)
            self.fired.append({"tick": cluster.clock,
                               "event": ev.describe(),
                               "applied": applied})
            if self.metrics is not None:
                self.metrics.incr("cluster", f"faults_{ev.kind}")
            if self.tracer is not None:
                # cluster trace: every firing; plus the job's own trace
                # when the event targets one, so chaos tests can assert
                # cause -> effect ordering inside a single timeline
                attrs = {"fault": ev.kind, "node": ev.node or "core",
                         "tick": cluster.clock, "applied": applied}
                self.tracer.event("cluster", "fault", **attrs)
                if ev.job_id is not None:
                    self.tracer.event(ev.job_id, "fault", **attrs)

    def _job_step(self, job_id: Optional[str]) -> Optional[int]:
        if self.lcm is None or job_id is None:
            return None
        return self.lcm.max_step(job_id)

    def _find_ps(self, job_id: Optional[str]):
        """The job's SoftwareParameterServer (SLOW target), via the core
        record or an explicit ``ps_of`` hook set by tests."""
        hook = getattr(self, "ps_of", None)
        if hook is not None:
            return hook(job_id)
        if self.core is None or job_id is None:
            return None
        rec = self.core.trainings.get(job_id) or {}
        plan = rec.get("plan")
        return plan.meta.get("ps") if plan is not None else None

    def _fire(self, ev: FaultEvent, cluster) -> bool:
        if ev.kind == CRASH_CORE:
            # SIGKILL-equivalent for the control plane itself: detach the
            # journal and abandon the process state. Nothing graceful
            # happens — recovery is the NEXT core's problem.
            if self.core is None:
                return False
            self.core.crash()
            return True
        if ev.kind == SLOW:
            # degrade one PS learner slot: the software PS injects a
            # per-push sleep (cleared when that learner restarts)
            ps = self._find_ps(ev.job_id)
            if ps is None:
                return False
            ps.slow_learner(ev.member or 0, seconds=ev.seconds,
                            rounds=ev.duration)
            return True
        if ev.node not in cluster.nodes:
            return False
        if ev.kind == KILL:
            cluster.fail_node(ev.node)
        elif ev.kind == DRAIN:
            cluster.drain_node(ev.node, "fault injection")
        elif ev.kind == PARTITION:
            cluster.partition_node(ev.node)
        elif ev.kind == DELAY:
            cluster.delay_heartbeats(ev.node, ev.duration)
        elif ev.kind == RECOVER:
            cluster.recover_node(ev.node)
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        return True
