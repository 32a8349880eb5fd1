"""Structured logging with job/trace context and per-job live taps.

All platform modules log through the stdlib ``logging`` tree under the
``"repro"`` root. Two pieces make those lines observable per job:

  * ``job_log_context`` / ``ContextFilter`` — a contextvar carries
    (job_id, trace_id, member) across the code running on behalf of a
    job; the filter stamps every LogRecord with those fields (defaulting
    to "-") so formatters and routing never KeyError. Call sites that
    are not under a context can pass ``extra={"job_id": ...}`` directly.
  * ``JobLogHub`` — per-job bounded tail (for the non-follow logs API)
    plus BoundedStream subscribers (for ``logs?follow=1``). A module
    level ``HubHandler`` on the "repro" logger routes any record that
    carries a job_id into every registered hub; cores register their hub
    on construction and unregister on close/crash.

``setup_logging()`` is idempotent and stdlib-only.

Copied from ``repro/observability/log.py`` unchanged apart from import
paths and one difference: ``setup_logging`` configures the port's own
``"repro_torch"`` logger tree, not ``"repro"``, and every logger of the
port is under it. One tree for both packages would route records to
whichever package set it up first: in a process that loads both, the
other package's hubs would receive nothing, or each other's job lines.
The port imports nothing of ``repro``.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.observability.stream import BoundedStream

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "repro_job_log_ctx", default=None)


@contextlib.contextmanager
def job_log_context(job_id: str, trace_id: Optional[str] = None,
                    member: Optional[str] = None):
    """Bind log records emitted in this (coroutine/thread) scope to a
    job. Contextvars propagate into threads only at spawn time, so task
    bodies enter this inside their own thread."""
    token = _ctx.set({"job_id": job_id, "trace_id": trace_id or "-",
                      "member": member or "-"})
    try:
        yield
    finally:
        _ctx.reset(token)


class ContextFilter(logging.Filter):
    """Stamp job_id/trace_id/member onto every record (explicit
    ``extra`` wins over the ambient context)."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _ctx.get() or {}
        for field in ("job_id", "trace_id", "member"):
            if getattr(record, field, None) in (None, ""):
                setattr(record, field, ctx.get(field, "-"))
        return True


class JobLogHub:
    """Per-job log fan-out: a bounded tail ring for replay plus live
    BoundedStream subscribers for ``?follow=1`` streams.

    Every published record gets a per-job monotonically increasing
    ``seq`` so a follower can replay the tail and then dedupe the live
    stream against it.
    """

    def __init__(self, tail: int = 512, sub_maxlen: int = 256):
        self.tail_len = tail
        self.sub_maxlen = sub_maxlen
        self._lock = threading.Lock()
        self._tails: Dict[str, deque] = {}
        self._seq: Dict[str, int] = {}
        self._subs: Dict[str, List[BoundedStream]] = {}

    def publish(self, job_id: str, line: str, *,
                level: str = "INFO", trace_id: str = "-",
                member: str = "-", ts: Optional[float] = None) -> Dict:
        rec = {"type": "log", "job_id": job_id, "line": line,
               "level": level, "trace_id": trace_id, "member": member,
               "ts": ts if ts is not None else time.time()}
        with self._lock:
            seq = self._seq.get(job_id, 0) + 1
            self._seq[job_id] = seq
            rec["seq"] = seq
            ring = self._tails.get(job_id)
            if ring is None:
                ring = self._tails[job_id] = deque(maxlen=self.tail_len)
            ring.append(rec)
            subs = list(self._subs.get(job_id, ()))
        for s in subs:
            s.put(rec)
        return rec

    def tail(self, job_id: str, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            recs = list(self._tails.get(job_id, ()))
        return recs if n is None else recs[-n:]

    def subscribe(self, job_id: str) -> BoundedStream:
        s = BoundedStream(maxlen=self.sub_maxlen)
        with self._lock:
            self._subs.setdefault(job_id, []).append(s)
        return s

    def unsubscribe(self, job_id: str, stream: BoundedStream):
        with self._lock:
            subs = self._subs.get(job_id)
            if subs and stream in subs:
                subs.remove(stream)
                if not subs:
                    del self._subs[job_id]
        stream.close()

    def drop(self, job_id: str):
        """Forget a job's tail and close its live subscribers (endpoint
        teardown must not leak streams)."""
        with self._lock:
            self._tails.pop(job_id, None)
            self._seq.pop(job_id, None)
            subs = self._subs.pop(job_id, [])
        for s in subs:
            s.close()

    def job_ids(self) -> List[str]:
        with self._lock:
            return list(self._tails)


# hubs that HubHandler fans records into; a DLaaSCore registers its hub
# for the core's lifetime (tests may run several cores sequentially)
_hubs: List[JobLogHub] = []
_hubs_lock = threading.Lock()


def register_hub(hub: JobLogHub):
    with _hubs_lock:
        if hub not in _hubs:
            _hubs.append(hub)


def unregister_hub(hub: JobLogHub):
    with _hubs_lock:
        if hub in _hubs:
            _hubs.remove(hub)


class HubHandler(logging.Handler):
    """Route job-scoped log records into every registered JobLogHub."""

    def emit(self, record: logging.LogRecord):
        job_id = getattr(record, "job_id", "-")
        if not job_id or job_id == "-":
            return
        try:
            line = record.getMessage()
        except Exception:
            return
        with _hubs_lock:
            hubs = list(_hubs)
        for hub in hubs:
            try:
                hub.publish(job_id, line, level=record.levelname,
                            trace_id=getattr(record, "trace_id", "-"),
                            member=getattr(record, "member", "-"),
                            ts=record.created)
            except Exception:
                # a broken tap must never break logging; handleError
                # honors logging.raiseExceptions (stderr in dev, silent
                # in production)
                self.handleError(record)


_FMT = ("%(asctime)s %(levelname)s %(name)s "
        "[job=%(job_id)s trace=%(trace_id)s] %(message)s")


def setup_logging() -> logging.Logger:
    """Configure the "repro" logger tree once: context filter, a stderr
    handler at $DLAAS_LOG_LEVEL (default WARNING), and the hub router at
    DEBUG. Safe to call from every core construction."""
    root = logging.getLogger("repro_torch")
    if getattr(root, "_repro_observability", False):
        return root
    root._repro_observability = True
    root.setLevel(logging.DEBUG)
    root.propagate = False
    # the filter lives on the handlers: logger-level filters don't see
    # records propagated up from child loggers ("repro.job", ...)
    ctx_filter = ContextFilter()
    level = os.environ.get("DLAAS_LOG_LEVEL", "WARNING").upper()
    stderr = logging.StreamHandler()
    stderr.setLevel(getattr(logging, level, logging.WARNING))
    stderr.setFormatter(logging.Formatter(_FMT))
    stderr.addFilter(ctx_filter)
    root.addHandler(stderr)
    hub_router = HubHandler(level=logging.DEBUG)
    hub_router.addFilter(ctx_filter)
    root.addHandler(hub_router)
    return root
