"""Explicit-propagation distributed tracing for the control plane.

No ambient context magic: a ``trace_id`` is minted when a job is
submitted, persisted on the durable job record and the ExecutionPlan
meta, and every layer that touches the job asks the shared ``Tracer``
for spans by ``job_id``. That makes propagation crash-proof (a recovered
core re-registers the persisted trace_id and the job's timeline
continues in the same trace) and keeps task bodies free of thread-local
plumbing.

Span taxonomy (see docs/ARCHITECTURE.md for the full table):

  * root span ``job`` — submission to terminal state;
  * phase spans derived from LCM state writes, non-overlapping by
    construction (each transition closes the open phase at the exact
    timestamp the next one opens): ``queue_wait`` (QUEUED),
    ``place`` (DEPLOYING), ``run`` (PROCESSING), ``preempted``;
  * instrumentation spans parented under the open phase: ``plan``,
    ``admission``, ``warm_compile``, sampled ``step``,
    ``checkpoint_publish``, serving ``prefill`` / ``request``;
  * point events (zero-duration): ``recovery``, ``relaunch``,
    ``fault``, ``node_transition``, sampled ``decode``.

Spans live in a ring-buffered ``TraceStore`` (traces evict LRU, spans
per trace evict oldest) so a long-lived service holds bounded memory no
matter how many jobs flow through.

Copied from ``repro/observability/trace.py`` unchanged: the port imports
nothing of ``repro``.

Its logger is named under the port's own ``"repro_torch"`` tree (see
``observability/log.py``), so in a process that loads both packages the
reference's log hubs receive none of the port's records.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

# pseudo-job under which platform-wide events (node transitions, fault
# injections, recovery passes) are recorded; per-job timelines fold in
# the slice of this trace that overlaps the job's lifetime
CLUSTER_TRACE = "cluster"

log = logging.getLogger("repro_torch.trace")

# sampled step spans: every Nth training step / decode batch gets a span
# (all steps would swamp the ring for zero extra insight)
TRACE_STEP_SAMPLE = int(os.environ.get("DLAAS_TRACE_STEP_SAMPLE", "8"))

# LCM job state -> phase span name
_PHASE_OF_STATE = {"QUEUED": "queue_wait", "DEPLOYING": "place",
                   "PROCESSING": "run", "PREEMPTED": "preempted"}
_TERMINAL = ("COMPLETED", "FAILED", "KILLED")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:8]


class Span:
    """One timed operation (or a zero-duration point event)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attrs", "status", "kind")

    def __init__(self, trace_id: str, name: str, start: float, *,
                 parent_id: Optional[str] = None, kind: str = "span",
                 attrs: Optional[Dict] = None):
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict = attrs or {}
        self.status = "ok"
        self.kind = kind                     # span | event

    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> Dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "kind": self.kind, "start": self.start, "end": self.end,
                "duration_s": self.duration(), "status": self.status,
                "attrs": dict(self.attrs)}


class TraceStore:
    """Ring-buffered span storage: at most ``max_traces`` traces (LRU on
    write), at most ``spans_per_trace`` spans each (oldest drop)."""

    def __init__(self, max_traces: int = 256,
                 spans_per_trace: int = 2048):
        self.max_traces = max_traces
        self.spans_per_trace = spans_per_trace
        self._traces: "OrderedDict[str, deque]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, span: Span):
        with self._lock:
            ring = self._traces.get(span.trace_id)
            if ring is None:
                ring = self._traces[span.trace_id] = deque(
                    maxlen=self.spans_per_trace)
            else:
                self._traces.move_to_end(span.trace_id)
            ring.append(span)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def spans(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def span_count(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._traces.values())

    def drop(self, trace_id: str):
        with self._lock:
            self._traces.pop(trace_id, None)


class Tracer:
    """Mints traces per job, derives lifecycle phase spans from LCM
    state writes, and reconstructs per-job timelines.

    A span is recorded into the store the moment it STARTS (the store
    holds the live object, so ``end()`` mutates in place) — an open span
    is visible in the timeline of a running or crashed job.
    """

    def __init__(self, store: Optional[TraceStore] = None, *,
                 clock: Callable[[], float] = time.time,
                 on_span_end: Optional[Callable[[Span], None]] = None):
        self.store = store or TraceStore()
        self.clock = clock
        self.on_span_end = on_span_end
        self._lock = threading.RLock()
        self._jobs: Dict[str, str] = {}          # job_id -> trace_id
        self._root: Dict[str, Span] = {}         # job_id -> root span
        self._phase: Dict[str, Span] = {}        # job_id -> open phase
        self._last_state: Dict[str, str] = {}

    # ---- registration ----------------------------------------------------
    def register_job(self, job_id: str,
                     trace_id: Optional[str] = None) -> str:
        """Bind (or re-bind, for crash recovery with the persisted id) a
        job to a trace and open its root span."""
        with self._lock:
            known = self._jobs.get(job_id)
            if known is not None and (trace_id is None
                                      or trace_id == known):
                return known
            tid = trace_id or new_trace_id()
            self._jobs[job_id] = tid
            root = Span(tid, "job", self.clock(),
                        attrs={"job_id": job_id})
            self._root[job_id] = root
            self._phase.pop(job_id, None)
            self._last_state.pop(job_id, None)
            self.store.record(root)
            return tid

    def trace_of(self, job_id: str) -> str:
        """The job's trace id, minting (and opening a root) lazily so an
        uninstrumented caller never loses spans."""
        with self._lock:
            tid = self._jobs.get(job_id)
            return tid if tid is not None else self.register_job(job_id)

    # ---- spans -----------------------------------------------------------
    def start(self, job_id: str, name: str, *,
              parent: Optional[Span] = None, **attrs) -> Span:
        with self._lock:
            tid = self.trace_of(job_id)
            if parent is None:
                parent = self._phase.get(job_id) or self._root.get(job_id)
            sp = Span(tid, name, self.clock(),
                      parent_id=parent.span_id if parent else None,
                      attrs=attrs)
            self.store.record(sp)
            return sp

    def _fire_span_end(self, span: Span):
        """The latency-mirror hook must never break tracing."""
        if self.on_span_end is None:
            return
        try:
            self.on_span_end(span)
        except Exception as e:
            log.debug("on_span_end hook failed for %s: %s: %s",
                      span.name, type(e).__name__, e)

    def end(self, span: Optional[Span], status: str = "ok", **attrs):
        if span is None or span.end is not None:
            return
        span.end = self.clock()
        span.status = status
        if attrs:
            span.attrs.update(attrs)
        if span.kind == "span":
            self._fire_span_end(span)

    @contextlib.contextmanager
    def span(self, job_id: str, name: str, **attrs):
        sp = self.start(job_id, name, **attrs)
        try:
            yield sp
        except BaseException as e:
            self.end(sp, status="error", error=type(e).__name__)
            raise
        else:
            self.end(sp)

    def event(self, job_id: str, name: str, **attrs):
        """Zero-duration point event in the job's trace."""
        with self._lock:
            tid = self.trace_of(job_id)
            parent = self._phase.get(job_id) or self._root.get(job_id)
            sp = Span(tid, name, self.clock(),
                      parent_id=parent.span_id if parent else None,
                      kind="event", attrs=attrs)
            sp.end = sp.start
            self.store.record(sp)
            return sp

    # ---- lifecycle phases (driven by LCM state writes) -------------------
    def job_state_change(self, job_id: str, state: str):
        """Close the open phase span and open the next one at the same
        timestamp — phases tile the job's lifetime without overlap."""
        with self._lock:
            if self._last_state.get(job_id) == state:
                return
            self._last_state[job_id] = state
            now = self.clock()
            open_phase = self._phase.pop(job_id, None)
            if open_phase is not None and open_phase.end is None:
                open_phase.end = now
                self._fire_span_end(open_phase)
            root = self._root.get(job_id)
            if state in _TERMINAL:
                if root is not None and root.end is None:
                    root.end = now
                    root.attrs["state"] = state
                return
            name = _PHASE_OF_STATE.get(state)
            if name is None:
                return
            sp = Span(self.trace_of(job_id), name, now,
                      parent_id=root.span_id if root else None,
                      attrs={"state": state})
            self._phase[job_id] = sp
            self.store.record(sp)

    # ---- reconstruction --------------------------------------------------
    def timeline(self, job_id: str) -> Dict:
        """The job's spans (start-ordered) plus the slice of the cluster
        trace (node transitions, fault firings, recovery passes) that
        overlaps the job's lifetime — one merged causal record."""
        with self._lock:
            tid = self._jobs.get(job_id)
        if tid is None:
            raise KeyError(f"no trace for job {job_id!r}")
        spans = sorted(self.store.spans(tid),
                       key=lambda s: (s.start, s.end or float("inf")))
        now = self.clock()
        t0 = spans[0].start if spans else now
        t1 = max((s.end or now) for s in spans) if spans else now
        folded: List[Dict] = []
        with self._lock:
            ctid = self._jobs.get(CLUSTER_TRACE)
        if ctid is not None and ctid != tid:
            folded = [s.to_dict() for s in self.store.spans(ctid)
                      if s.kind == "event" and t0 <= s.start <= t1]
        return {"job_id": job_id, "trace_id": tid,
                "start": t0, "end": t1,
                "spans": [s.to_dict() for s in spans],
                "cluster_events": folded}

    def has_trace(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._jobs


@contextlib.contextmanager
def maybe_span(tracer: Optional[Tracer], job_id: str, name: str,
               **attrs):
    """Span context that degrades to a no-op when no tracer is wired
    (direct backend/engine construction in unit tests)."""
    if tracer is None:
        yield None
        return
    with tracer.span(job_id, name, **attrs) as sp:
        yield sp
