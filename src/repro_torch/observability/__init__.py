"""Platform observability layer of the port: copies of the reference's
``repro/observability`` modules, exporting what its ``__init__`` exports.

  * ``trace``  — distributed tracing: spans per job lifecycle phase in a
    ring-buffered ``TraceStore``, per-job timelines;
  * ``export`` — Prometheus text exposition (``GET /metrics``), without
    the reference's autotune-cache families;
  * ``log``    — structured logging under the ``"repro_torch"`` logger
    tree, a job/trace context filter and the per-job ``JobLogHub`` behind
    ``logs?follow=1``;
  * ``slo``    — SLO specs, burn-rate evaluation, anomaly detectors and
    the ``AlertManager`` behind ``GET /v1/alerts``;
  * ``stream`` — the ``BoundedStream`` every live tap hands out.
"""
from repro_torch.observability.export import (DEFAULT_BUCKETS,
                                              parse_prometheus_text,
                                              prometheus_text)
from repro_torch.observability.log import (ContextFilter, JobLogHub,
                                           job_log_context, register_hub,
                                           setup_logging, unregister_hub)
from repro_torch.observability.slo import (Alert, AlertManager, BurnWindow,
                                           SLOSpec, SLOTracker, burn_rate,
                                           detect_checkpoint_stall,
                                           detect_queue_growth,
                                           detect_stragglers)
from repro_torch.observability.stream import BoundedStream
from repro_torch.observability.trace import (Span, TraceStore, Tracer,
                                             maybe_span, new_trace_id)

__all__ = [
    "Alert", "AlertManager", "BoundedStream", "BurnWindow",
    "ContextFilter", "DEFAULT_BUCKETS", "JobLogHub", "SLOSpec",
    "SLOTracker", "Span", "TraceStore", "Tracer", "burn_rate",
    "detect_checkpoint_stall", "detect_queue_growth", "detect_stragglers",
    "job_log_context", "maybe_span", "new_trace_id",
    "parse_prometheus_text", "prometheus_text", "register_hub",
    "setup_logging", "unregister_hub",
]
