"""Model-serving subsystem of the port: managed inference endpoints over
the same control plane that runs training.

  engine.py    — InferenceEngine: continuous-batching decode runtime
                 (slot-based cache, bounded admission queue, per-request
                 deadlines)
  endpoint.py  — ModelEndpoint lifecycle (DEPLOYING→READY→DRAINING→
                 STOPPED) + the ``serving`` execution backend that plans
                 endpoints as LCM jobs

What the reference's ``repro/serving/__init__.py`` exports.
"""
from repro_torch.serving.engine import (DeadlineExceeded, EndpointClosed,
                                        InferenceEngine, InferenceRequest,
                                        QueueFull)
from repro_torch.serving.endpoint import (DEPLOYING_E, DRAINING_E,
                                          FAILED_E, ModelEndpoint, READY_E,
                                          ServingBackend, STOPPED_E)

__all__ = [
    "DeadlineExceeded", "EndpointClosed", "InferenceEngine",
    "InferenceRequest", "QueueFull",
    "ModelEndpoint", "ServingBackend",
    "DEPLOYING_E", "READY_E", "DRAINING_E", "STOPPED_E", "FAILED_E",
]
