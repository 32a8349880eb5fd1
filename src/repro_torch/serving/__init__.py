from repro_torch.serving.engine import (  # noqa: F401
    EndpointClosed, InferenceEngine, InferenceRequest, QueueFull)
