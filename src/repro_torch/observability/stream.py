"""Bounded pub-sub stream — the one primitive behind every live tap.

A ``BoundedStream`` is a drop-oldest ring the producer pushes dict
records into and exactly one consumer drains. Producers never block and
never grow memory without bound (a slow/stalled HTTP client simply loses
the oldest records); consumers block on ``get`` with a timeout so a
streaming handler can interleave liveness checks.

Both the MetricsService metric tap (``?follow=1`` on /metrics streams)
and the JobLogHub log tap (``logs?follow=1``) hand these out.

Copied from ``repro/observability/stream.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional


class BoundedStream:
    def __init__(self, maxlen: int = 256):
        self._q: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._ev = threading.Event()
        self.closed = False
        self.dropped = 0                # records lost to the ring bound

    def put(self, rec: Dict):
        """Producer side: never blocks; oldest record drops at the
        bound."""
        with self._lock:
            if self.closed:
                return
            if len(self._q) == self._q.maxlen:
                self.dropped += 1
            self._q.append(rec)
        self._ev.set()

    def get(self, timeout: Optional[float] = None) -> Optional[Dict]:
        """Consumer side: next record, or None on timeout/close."""
        while True:
            with self._lock:
                if self._q:
                    return self._q.popleft()
                if self.closed:
                    return None
                self._ev.clear()
            if not self._ev.wait(timeout):
                return None

    def drain(self) -> List[Dict]:
        """Everything currently buffered, without blocking."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
        return out

    def close(self):
        """Producer-side teardown (e.g. MetricsService.drop): wakes a
        blocked consumer, which then sees None."""
        with self._lock:
            self.closed = True
        self._ev.set()
