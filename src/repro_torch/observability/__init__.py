"""What the port needs of ``repro.observability``: ``BoundedStream``
(``stream.py``, a copy), tracing (``trace.py``, a copy) and the
histogram buckets of ``repro/observability/export.py:36``."""
from repro_torch.observability.stream import BoundedStream
from repro_torch.observability.trace import (Span, TraceStore, Tracer,
                                             maybe_span, new_trace_id)

# default latency buckets for span-duration histograms (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

__all__ = ["BoundedStream", "DEFAULT_BUCKETS", "Span", "TraceStore",
           "Tracer", "maybe_span", "new_trace_id"]
