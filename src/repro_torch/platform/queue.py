"""Multi-tenant job queue: priorities, per-tenant quotas, weighted
fair-share (deficit round-robin) and preemption bookkeeping.

The IBM DLaaS follow-up papers (Dependability in a Multi-tenant
Multi-framework DL Platform, arXiv:1805.06801; FfDL, arXiv:1909.06526)
make admission control, per-user quotas and preemptive scheduling the
centerpiece of the production service. This module is the pure
data-structure half of that design; the Scheduler (platform/cluster.py)
drives it from ``tick()``.

Ordering rule, applied every time the scheduler asks for candidates:

  1. higher ``priority`` first (strict — a priority band is never
     outscheduled by fair-share pressure from a lower band);
  2. within a band, larger tenant *deficit* first. Every scheduling
     round the tenants with queued work split one unit of deficit in
     proportion to their weights; placing a task spends ``max(1, gpus)``
     of it. A starved tenant's deficit therefore grows until its entries
     rise above tenants that have been consuming the cluster, and
     long-run placements converge to the weight ratio — weighted
     fair-share without timestamps or global state;
  3. submission order (FIFO) as the tie-break, which also makes the
     single-tenant case degrade to the original FIFO scheduler.

Quotas cap a tenant's *concurrent* resource footprint. A job whose
total demand can never fit inside the quota is rejected at submission
(``QuotaExceeded``); a job that merely has to wait for its tenant's
running work to drain is held in the queue (``held_by_quota``).

Copied from ``repro/platform/queue.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TYPE_CHECKING

from repro_torch.platform.cluster import Resources

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.platform.cluster import Task


class QuotaExceeded(Exception):
    """Job demand cannot ever fit inside the tenant's quota."""


@dataclass
class Tenant:
    name: str
    weight: float = 1.0
    quota: Optional[Resources] = None     # cap on concurrent usage
    deficit: float = 0.0                  # fair-share credit (DRR)
    in_use: Resources = field(default_factory=lambda: Resources(0, 0, 0))
    gpu_seconds: float = 0.0              # lifetime metering
    cost_units: float = 0.0               # gpu_seconds x node cost factor
    placements: int = 0
    preemptions: int = 0                  # times this tenant was preempted

    def snapshot(self) -> Dict:
        return {
            "weight": self.weight,
            "quota": ({"cpus": self.quota.cpus, "gpus": self.quota.gpus,
                       "memory_mb": self.quota.memory_mb}
                      if self.quota else None),
            "deficit": round(self.deficit, 3),
            "in_use": {"cpus": self.in_use.cpus, "gpus": self.in_use.gpus,
                       "memory_mb": self.in_use.memory_mb},
            "gpu_seconds": round(self.gpu_seconds, 3),
            "cost_units": round(self.cost_units, 3),
            "placements": self.placements,
            "preemptions": self.preemptions,
        }


# quota dimensions left unspecified are unlimited within cluster capacity
UNLIMITED = Resources(cpus=1e9, gpus=10 ** 9, memory_mb=10 ** 12)


@dataclass
class QueueEntry:
    task: "Task"
    tenant: str
    priority: int
    seq: int
    enqueued_ts: float


class FairShareQueue:
    """Priority + deficit-weighted-fair-share queue over pending tasks.

    Not thread-safe by itself — the Scheduler serializes access under
    its own lock, exactly as it did for the old pending list.
    """

    def __init__(self):
        self.tenants: Dict[str, Tenant] = {}
        self._entries: List[QueueEntry] = []
        self._seq = itertools.count()
        # task_id -> (place time, node cost factor)
        self._charged_at: Dict[str, tuple] = {}

    # ---- tenant registry --------------------------------------------------
    def tenant(self, name: str) -> Tenant:
        if name not in self.tenants:
            self.tenants[name] = Tenant(name)
        return self.tenants[name]

    def configure_tenant(self, name: str, *,
                         weight: Optional[float] = None,
                         quota_cpus: Optional[float] = None,
                         quota_gpus: Optional[int] = None,
                         quota_memory_mb: Optional[int] = None) -> Tenant:
        """Per-field tenant update: None means leave-unchanged. Quota
        dimensions merge into the existing quota rather than replacing
        it, so capping memory cannot silently drop a GPU cap."""
        t = self.tenant(name)
        if weight is not None:
            t.weight = float(weight)
        if any(q is not None for q in (quota_cpus, quota_gpus,
                                       quota_memory_mb)):
            base = t.quota or UNLIMITED
            t.quota = Resources(
                cpus=quota_cpus if quota_cpus is not None else base.cpus,
                gpus=quota_gpus if quota_gpus is not None else base.gpus,
                memory_mb=(quota_memory_mb if quota_memory_mb is not None
                           else base.memory_mb))
        return t

    def restore_tenant(self, name: str, snap: Dict) -> Tenant:
        """Rehydrate a tenant from a persisted ``snapshot()`` dict after
        a control-plane crash. Billing (gpu_seconds/cost_units) and
        fair-share standing (deficit, placements, preemptions) carry
        over; ``in_use`` is deliberately zeroed — nothing is placed yet
        in the recovered process, and relaunched jobs re-charge as the
        scheduler places them."""
        t = self.tenant(name)
        t.weight = float(snap.get("weight", t.weight))
        q = snap.get("quota")
        if q is not None:
            t.quota = Resources(cpus=q["cpus"], gpus=q["gpus"],
                                memory_mb=q["memory_mb"])
        t.deficit = float(snap.get("deficit", 0.0))
        t.in_use = Resources(0, 0, 0)
        t.gpu_seconds = float(snap.get("gpu_seconds", 0.0))
        t.cost_units = float(snap.get("cost_units", 0.0))
        t.placements = int(snap.get("placements", 0))
        t.preemptions = int(snap.get("preemptions", 0))
        return t

    # ---- admission --------------------------------------------------------
    def check_admission(self, tenant: str, demand: Resources):
        """Reject work whose total demand can never fit in the quota."""
        q = self.tenant(tenant).quota
        if q is None or demand.fits(q):
            return
        over = [f"{name} {got} > quota {cap:g}"
                for name, got, cap in (("cpus", demand.cpus, q.cpus),
                                       ("gpus", demand.gpus, q.gpus),
                                       ("memory_mb", demand.memory_mb,
                                        q.memory_mb))
                if got > cap]
        raise QuotaExceeded(
            f"tenant {tenant!r}: job demand exceeds tenant quota "
            f"({'; '.join(over)})")

    def within_quota(self, tenant: str, res: Resources) -> bool:
        t = self.tenant(tenant)
        if t.quota is None:
            return True
        want = Resources(t.in_use.cpus + res.cpus,
                         t.in_use.gpus + res.gpus,
                         t.in_use.memory_mb + res.memory_mb)
        return want.fits(t.quota)

    # ---- queue ------------------------------------------------------------
    def push(self, task: "Task", tenant: str, priority: int):
        self.tenant(tenant)
        self._entries.append(QueueEntry(
            task=task, tenant=tenant, priority=priority,
            seq=next(self._seq), enqueued_ts=time.time()))

    def remove(self, entry: QueueEntry):
        try:
            self._entries.remove(entry)
        except ValueError:
            pass

    def remove_app(self, app_id: str):
        self._entries = [e for e in self._entries
                         if e.task.app_id != app_id]

    def remove_task(self, task_id: str):
        self._entries = [e for e in self._entries
                         if e.task.task_id != task_id]

    def contains(self, task_id: str) -> bool:
        return any(e.task.task_id == task_id for e in self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def ordered(self) -> List[QueueEntry]:
        """Current scheduling order (priority, then deficit, then FIFO)."""
        return sorted(
            self._entries,
            key=lambda e: (-e.priority,
                           -self.tenant(e.tenant).deficit,
                           e.seq))

    # ---- fair-share accounting -------------------------------------------
    def refresh_deficits(self):
        """One scheduling round: tenants with queued work split one unit
        of deficit in proportion to their weights (normalized DRR).
        Matching aggregate earn to aggregate spend keeps deficits
        bounded, so placements converge to the weight ratio instead of
        the heaviest backlog monopolizing the cluster."""
        # a tenant only earns while it has work the scheduler COULD
        # place — entries held by the tenant's own quota don't count,
        # else a capped tenant banks unbounded deficit and monopolizes
        # its band in a burst once the quota frees
        waiting = {e.tenant for e in self._entries
                   if self.within_quota(e.tenant, e.task.resources)}
        total_w = sum(self.tenant(n).weight for n in waiting)
        if total_w <= 0:
            return
        for name in waiting:
            t = self.tenant(name)
            t.deficit += t.weight / total_w

    def charge(self, tenant: str, task: "Task", cost: float = 1.0):
        """Record a placement: consume deficit, track concurrent usage.
        ``cost`` is the node's cost factor (< 1 for spot/preemptible
        capacity): it scales both the fair-share spend and the metered
        cost, so running on cheap nodes burns less of a tenant's share."""
        t = self.tenant(tenant)
        t.in_use.add(task.resources)
        t.deficit -= max(1.0, float(task.resources.gpus)) * cost
        t.placements += 1
        self._charged_at[task.task_id] = (time.time(), cost)

    def credit(self, tenant: str, task: "Task"):
        """Record a release: return concurrent usage, meter gpu-seconds
        and billed cost. No-op for tasks never charged (still queued)."""
        placed = self._charged_at.pop(task.task_id, None)
        if placed is None:
            return
        placed_ts, cost = placed
        t = self.tenant(tenant)
        t.in_use.sub(task.resources)
        held = time.time() - placed_ts
        t.gpu_seconds += task.resources.gpus * held
        t.cost_units += task.resources.gpus * held * cost

    def refund(self, tenant: str, task: "Task"):
        """Undo a charge for a placement that never ran (e.g. landed on
        a GPU-unresponsive node): restore usage AND the fair-share
        deficit/placement count, so failed placements don't burn the
        tenant's share."""
        placed = self._charged_at.pop(task.task_id, None)
        if placed is None:
            return
        _, cost = placed
        t = self.tenant(tenant)
        t.in_use.sub(task.resources)
        t.deficit += max(1.0, float(task.resources.gpus)) * cost
        t.placements -= 1

    # ---- introspection ----------------------------------------------------
    def position(self, app_id: str) -> Optional[int]:
        """0-based position of an app's best-placed entry, None if absent."""
        for i, e in enumerate(self.ordered()):
            if e.task.app_id == app_id:
                return i
        return None

    def status(self) -> Dict:
        entries = []
        for i, e in enumerate(self.ordered()):
            entries.append({
                "position": i,
                "task_id": e.task.task_id,
                "app_id": e.task.app_id,
                "tenant": e.tenant,
                "priority": e.priority,
                "state": e.task.state,
                "held_by_quota": not self.within_quota(
                    e.tenant, e.task.resources),
                "waiting_s": round(time.time() - e.enqueued_ts, 3),
            })
        return {"entries": entries,
                "tenants": {n: t.snapshot()
                            for n, t in sorted(self.tenants.items())}}
