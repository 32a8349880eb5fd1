"""Autoscaler: elastic node provisioning from queue depth and tenant
demand (paper §Platform Services — the IaaS layer the DLaaS control
plane rents capacity from).

Driven from ``Scheduler.tick()`` after placement, so it reacts to the
*residual* queue: demand that the current READY capacity could not
absorb. Scale-up adds spot (preemptible) nodes first — they bill at a
discounted fair-share cost factor — and every new node walks the full
lifecycle (REGISTERING, first heartbeat, READY) before it accepts work.
Scale-down drains idle autoscaled nodes and removes them once empty;
seed (static) nodes are never touched. All decisions are functions of
the logical clock and queue state only, so a seeded run replays to an
identical transition log.

Copied from ``repro/platform/autoscale.py`` unchanged apart from import
paths: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

from repro_torch.platform.cluster import Node, Resources


class Autoscaler:
    def __init__(self, scheduler, *, max_nodes: int = 16,
                 node_gpus: int = 4, node_cpus: float = 8.0,
                 node_memory_mb: int = 32000, spot: bool = True,
                 spot_cost: float = 0.5, idle_ticks: int = 10):
        self.scheduler = scheduler
        self.max_nodes = max_nodes
        self.node_gpus = max(1, node_gpus)
        self.node_cpus = node_cpus
        self.node_memory_mb = node_memory_mb
        self.spot = spot
        self.spot_cost = spot_cost
        self.idle_ticks = idle_ticks
        self._seq = itertools.count()
        self._idle = 0
        self._mine: List[str] = []       # nodes this autoscaler added
        self.scale_ups = 0
        self.scale_downs = 0
        self.events: List[Dict] = []
        # one-shot scale-up hint from the SLO HealthController: a
        # queue-wait burn means demand is waiting LONG, which residual
        # free-GPU math alone may not see (quota-shaped backlogs)
        self._hint_reason: str = ""

    def hint_scale_up(self, reason: str = "slo"):
        """Ask the next ``step()`` to add one node (subject to
        ``max_nodes``) regardless of the residual-backlog math."""
        self._hint_reason = reason or "slo"

    # ---- demand / capacity signals ----------------------------------------
    def queued_demand(self) -> Resources:
        """Aggregate demand of queue entries the scheduler WOULD place if
        capacity existed — entries held by their tenant's own quota are
        excluded (adding nodes cannot help them)."""
        q = self.scheduler.queue
        demand = Resources(cpus=0.0, gpus=0, memory_mb=0)
        for e in list(q._entries):
            if e.task.state not in ("TASK_STAGING", "TASK_PREEMPTED"):
                continue
            if not q.within_quota(e.tenant, e.task.resources):
                continue
            demand.add(e.task.resources)
        return demand

    def pending_capacity(self) -> int:
        """GPUs on autoscaled nodes still REGISTERING (joined but not yet
        heartbeated) — counted so one backlog doesn't add nodes twice."""
        return sum(n.capacity.gpus
                   for n in self.scheduler.cluster.nodes.values()
                   if n.managed and n.state == "REGISTERING")

    # ---- one decision round ------------------------------------------------
    def step(self):
        cluster = self.scheduler.cluster
        if self._hint_reason:
            reason, self._hint_reason = self._hint_reason, ""
            self._idle = 0
            if len(cluster.nodes) < self.max_nodes:
                self._add_node(cluster)
                self.events[-1] = {**self.events[-1],
                                   "action": "scale_up_hint",
                                   "reason": reason}
        demand = self.queued_demand()
        backlog = demand.gpus if demand.gpus > 0 else \
            (1 if demand.cpus > 0 else 0)
        free = cluster.free_gpus() + self.pending_capacity()
        if backlog > free:
            self._idle = 0
            need = backlog - free
            n_new = min(-(-need // self.node_gpus),        # ceil div
                        self.max_nodes - len(cluster.nodes))
            for _ in range(max(0, n_new)):
                self._add_node(cluster)
            return
        if backlog == 0 and len(self.scheduler.queue) == 0:
            self._idle += 1
        else:
            self._idle = 0
        if self._idle >= self.idle_ticks:
            self._shrink(cluster)
        self._reap(cluster)

    def _add_node(self, cluster):
        name = f"{'spot' if self.spot else 'auto'}-{next(self._seq)}"
        node = Node(name, Resources(cpus=self.node_cpus,
                                    gpus=self.node_gpus,
                                    memory_mb=self.node_memory_mb))
        cluster.register_node(node, spot=self.spot,
                              cost_factor=(self.spot_cost if self.spot
                                           else 1.0))
        self._mine.append(name)
        self.scale_ups += 1
        self.events.append({"tick": cluster.clock, "action": "scale_up",
                            "node": name})

    def _shrink(self, cluster):
        """Drain ONE fully-idle autoscaled node per tick (youngest
        first), so a brief lull doesn't flush the whole elastic pool."""
        for name in reversed(self._mine):
            n = cluster.nodes.get(name)
            if n is None or n.state != "READY":
                continue
            if n.free.gpus == n.capacity.gpus and \
                    n.free.cpus == n.capacity.cpus:
                cluster.drain_node(name, "autoscaler: idle")
                self.scale_downs += 1
                self.events.append({"tick": cluster.clock,
                                    "action": "scale_down", "node": name})
                return

    def _reap(self, cluster):
        """Remove autoscaled nodes that finished draining or died."""
        for name in list(self._mine):
            n = cluster.nodes.get(name)
            if n is None:
                self._mine.remove(name)
                continue
            if n.state == "DEAD" or (
                    n.state == "DRAINING"
                    and n.free.gpus == n.capacity.gpus
                    and n.free.cpus == n.capacity.cpus):
                if cluster.remove_node(name, "autoscaler: reaped"):
                    self._mine.remove(name)

    def stats(self) -> Dict:
        return {"max_nodes": self.max_nodes,
                "node_gpus": self.node_gpus,
                "spot": self.spot, "spot_cost": self.spot_cost,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "managed_nodes": list(self._mine),
                "events": self.events[-20:]}
