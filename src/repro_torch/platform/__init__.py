"""Copies of the ``repro.platform`` modules: journal, ZooKeeper,
watchdog, storage, metrics, cluster (scheduler), queue (fair share), lcm,
and the modules only ``DLaaSCore`` wires: health (the SLO control loop),
autoscale and faults (chaos drills)."""
from repro_torch.platform.autoscale import Autoscaler
from repro_torch.platform.faults import (FaultEvent, FaultInjector,
                                         FaultSchedule)
from repro_torch.platform.health import HealthController

__all__ = ["Autoscaler", "FaultEvent", "FaultInjector", "FaultSchedule",
           "HealthController"]
