"""Metrics service + training-progress analytics (paper §Understanding
Training Progress).

Implements the six progress indicators from the paper's user interviews:
  (1) is accuracy better than random guessing?
  (2) has accuracy plateaued? (notify/early-stop candidate)
  (3) has a checkpoint been persisted at iteration k?
  (4) did the learning rate change (accuracy jump point)?
  (5) is accuracy stable over a long window?
  (6) validation cadence and duration.
plus the platform-side indicators (idle nodes, communication overhead)
that are "useful in optimizing the DLaaS platform but not exposed to the
user".

Also includes the extensible log-parser service: pluggable parsers turn
raw log streams into the common JSON-list format the visualization
component consumes (paper §Platform Architecture (2)).

Copied from ``repro/platform/metrics.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.

Its logger is named under the port's own ``"repro_torch"`` tree (see
``observability/log.py``), so in a process that loads both packages the
reference's log hubs receive none of the port's records.
"""
from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.observability.export import DEFAULT_BUCKETS
from repro_torch.observability.stream import BoundedStream

log = logging.getLogger("repro_torch.metrics")

# every Series is a bounded ring: long jobs emit one loss per step
# forever, and an unbounded list was the platform's slowest memory leak
SERIES_CAP = 65536
EVENTS_CAP = 4096


@dataclass
class Series:
    steps: List[int] = field(default_factory=list)
    values: List[float] = field(default_factory=list)

    def add(self, step: int, value: float, cap: int = SERIES_CAP):
        self.steps.append(step)
        self.values.append(float(value))
        if len(self.values) > cap:
            del self.steps[:-cap]
            del self.values[:-cap]

    def window(self, n: int) -> List[float]:
        return self.values[-n:]


class _Counter:
    """Typed handle over one MetricsService counter."""

    __slots__ = ("_m", "_scope", "_name")

    def __init__(self, m: "MetricsService", scope: str, name: str):
        self._m, self._scope, self._name = m, scope, name

    def inc(self, value: float = 1.0):
        self._m.incr(self._scope, self._name, value)

    def get(self) -> float:
        return self._m.counters(self._scope).get(self._name, 0.0)


class _Gauge:
    __slots__ = ("_m", "_scope", "_name")

    def __init__(self, m: "MetricsService", scope: str, name: str):
        self._m, self._scope, self._name = m, scope, name

    def set(self, value: float):
        self._m.set_gauge(self._scope, self._name, value)

    def get(self) -> Optional[float]:
        with self._m._lock:
            return self._m._gauges.get(self._scope, {}).get(self._name)


class _Histogram:
    __slots__ = ("_m", "_scope", "_name", "_buckets")

    def __init__(self, m: "MetricsService", scope: str, name: str,
                 buckets: Tuple[float, ...]):
        self._m, self._scope, self._name = m, scope, name
        self._buckets = buckets

    def observe(self, value: float):
        self._m.observe(self._scope, self._name, value,
                        buckets=self._buckets)


class MetricsService:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, Dict[str, Series]] = defaultdict(
            lambda: defaultdict(Series))
        self._events: Dict[str, List[Dict]] = defaultdict(list)
        self._counters: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._gauges: Dict[str, Dict[str, float]] = defaultdict(dict)
        self._hists: Dict[str, Dict[str, Dict]] = defaultdict(dict)
        self._subs: List[Callable[[str, str, int, float], None]] = []
        # per-job live taps for the ?follow=1 metric streams
        self._streams: Dict[str, List[BoundedStream]] = defaultdict(list)

    # ---- ingestion ----------------------------------------------------------
    def _fanout(self, job_id: str, metric: str, step: int,
                value: float):
        """Fire legacy callbacks + live stream taps (outside the lock:
        subscribers may call back into the service)."""
        for cb in self._subs:
            try:
                cb(job_id, metric, step, value)
            except Exception as e:
                log.warning("subscriber failed for %s/%s: %s: %s",
                            job_id, metric, type(e).__name__, e)
        self._publish(job_id, {"type": "metric", "job_id": job_id,
                               "metric": metric, "step": step,
                               "value": value, "ts": time.time()})

    def _publish(self, job_id: str, rec: Dict):
        with self._lock:
            taps = list(self._streams.get(job_id, ()))
        for s in taps:
            s.put(rec)

    def record(self, job_id: str, metric: str, step: int, value: float):
        with self._lock:
            self._series[job_id][metric].add(step, value)
        self._fanout(job_id, metric, step, value)

    def record_bounded(self, job_id: str, metric: str, step: int,
                       value: float, keep: int = 4096):
        """Record into a rolling-window series capped at ``keep``
        entries. For long-lived producers (serving endpoints emit one
        latency per request and one occupancy per decode step forever)
        an unbounded Series would grow RSS without limit; percentiles
        over the window are a rolling view, which is what an endpoint's
        p50/p99 should mean anyway."""
        with self._lock:
            self._series[job_id][metric].add(step, value, cap=keep)
        self._fanout(job_id, metric, step, value)

    def incr(self, job_id: str, counter: str, value: float = 1.0):
        """Atomic monotonic counter — safe against concurrent learners
        (a bare ``+=`` on a shared attribute drops increments)."""
        with self._lock:
            self._counters[job_id][counter] += value

    def counters(self, job_id: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters[job_id])

    def set_gauge(self, scope: str, name: str, value: float):
        with self._lock:
            self._gauges[scope][name] = float(value)

    def observe(self, scope: str, name: str, value: float,
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        """One histogram observation (non-cumulative bucket counts; the
        exporter cumulates at render time)."""
        with self._lock:
            h = self._hists[scope].get(name)
            if h is None:
                h = self._hists[scope][name] = {
                    "buckets": list(buckets),
                    "counts": [0] * len(buckets),
                    "sum": 0.0, "count": 0}
            for i, bound in enumerate(h["buckets"]):
                if value <= bound:
                    h["counts"][i] += 1
                    break
            h["sum"] += float(value)
            h["count"] += 1

    # typed wrappers: call sites migrate from stringly incr() onto these
    def counter(self, scope: str, name: str) -> _Counter:
        return _Counter(self, scope, name)

    def gauge(self, scope: str, name: str) -> _Gauge:
        return _Gauge(self, scope, name)

    def histogram(self, scope: str, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> _Histogram:
        return _Histogram(self, scope, name, buckets)

    def event(self, job_id: str, kind: str, step: int, **kw):
        rec = {"kind": kind, "step": step, "ts": time.time(), **kw}
        with self._lock:
            ev = self._events[job_id]
            ev.append(rec)
            if len(ev) > EVENTS_CAP:
                del ev[:-EVENTS_CAP]
        self._publish(job_id, {"type": "event", "job_id": job_id, **rec})

    def subscribe(self, cb: Callable[[str, str, int, float], None]):
        self._subs.append(cb)

    # ---- live streaming ------------------------------------------------------
    def stream(self, job_id: str, maxlen: int = 256) -> BoundedStream:
        """A bounded live tap on one job's metric/event flow (the
        ``/v1/trainings/<id>/metrics?follow=1`` feed)."""
        s = BoundedStream(maxlen=maxlen)
        with self._lock:
            self._streams[job_id].append(s)
        return s

    def unsubscribe_stream(self, job_id: str, stream: BoundedStream):
        with self._lock:
            taps = self._streams.get(job_id)
            if taps and stream in taps:
                taps.remove(stream)
                if not taps:
                    del self._streams[job_id]
        stream.close()

    # ---- queries ---------------------------------------------------------------
    def series(self, job_id: str, metric: str) -> Series:
        with self._lock:
            return self._series[job_id][metric]

    def metrics(self, job_id: str) -> List[str]:
        with self._lock:
            return sorted(self._series[job_id])

    def percentile(self, job_id: str, metric: str,
                   q: float) -> Optional[float]:
        """q-th percentile (nearest-rank) of a series' values — e.g.
        p50/p99 request latency for a serving endpoint.

        Contract (the SLO engine leans on these edges): an empty or
        unknown series returns ``None`` — never raises; a single-sample
        series returns that sample for every q; q is effectively
        clamped to [0, 100], so q <= 0 gives the minimum and q >= 100
        the maximum."""
        with self._lock:
            vals = sorted(self._series[job_id][metric].values)
        if not vals:
            return None
        idx = max(0, min(len(vals) - 1,
                         int(math.ceil(q / 100.0 * len(vals))) - 1))
        return vals[idx]

    def drop(self, job_id: str):
        """Unregister a job's metrics (series, events, counters) — the
        endpoint-teardown path: the owner snapshots what it needs, then
        drops the rest so a long-lived service doesn't accumulate
        per-endpoint state forever. Live stream subscribers are closed
        and detached too — a torn-down endpoint must not leak taps."""
        with self._lock:
            self._series.pop(job_id, None)
            self._events.pop(job_id, None)
            self._counters.pop(job_id, None)
            self._gauges.pop(job_id, None)
            self._hists.pop(job_id, None)
            taps = self._streams.pop(job_id, [])
        for s in taps:
            s.close()

    def events(self, job_id: str, kind: Optional[str] = None) -> List[Dict]:
        with self._lock:
            ev = list(self._events[job_id])
        return [e for e in ev if kind is None or e["kind"] == kind]

    # ---- exporter snapshots (consumed by observability.export) ---------------
    def counters_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {scope: dict(cs)
                    for scope, cs in self._counters.items()}

    def gauges_snapshot(self) -> List[Tuple[str, str, float]]:
        with self._lock:
            return [(scope, name, v)
                    for scope, gs in self._gauges.items()
                    for name, v in gs.items()]

    def hists_snapshot(self) -> List[Tuple[str, str, Dict]]:
        with self._lock:
            return [(scope, name,
                     {"buckets": list(h["buckets"]),
                      "counts": list(h["counts"]),
                      "sum": h["sum"], "count": h["count"]})
                    for scope, hs in self._hists.items()
                    for name, h in hs.items()]

    def last_values(self) -> List[Tuple[str, str, int, float]]:
        """Last point of every series — the ``dlaas_job_metric_last``
        gauge family."""
        with self._lock:
            return [(job_id, metric, s.steps[-1], s.values[-1])
                    for job_id, ms in self._series.items()
                    for metric, s in ms.items() if s.values]

    def to_json(self, job_id: str) -> str:
        """The 'common JSON list format' of the visualization pipeline."""
        with self._lock:
            out = []
            for metric, s in self._series[job_id].items():
                out.extend({"metric": metric, "step": st, "value": v}
                           for st, v in zip(s.steps, s.values))
        return json.dumps(out)

    # ---- the six progress indicators ------------------------------------------
    def better_than_random(self, job_id: str, n_classes: int,
                           metric: str = "accuracy") -> Optional[bool]:
        s = self.series(job_id, metric)
        if not s.values:
            return None
        return s.values[-1] > 1.0 / n_classes

    def plateaued(self, job_id: str, metric: str = "loss",
                  window: int = 10, rel_eps: float = 1e-3) -> bool:
        s = self.series(job_id, metric)
        w = s.window(window)
        if len(w) < window:
            return False
        best_before = min(s.values[:-window]) if len(s.values) > window \
            else float("inf")
        return min(w) > best_before * (1 - rel_eps)

    def checkpoints(self, job_id: str) -> List[Dict]:
        return self.events(job_id, "checkpoint")

    def lr_changes(self, job_id: str) -> List[Dict]:
        s = self.series(job_id, "lr")
        out = []
        for i in range(1, len(s.values)):
            if s.values[i] != s.values[i - 1]:
                out.append({"step": s.steps[i], "from": s.values[i - 1],
                            "to": s.values[i]})
        return out

    def stable(self, job_id: str, metric: str = "accuracy",
               window: int = 20, max_cv: float = 0.02) -> bool:
        w = self.series(job_id, metric).window(window)
        if len(w) < window:
            return False
        mu = sum(w) / len(w)
        if mu == 0:
            return False
        var = sum((x - mu) ** 2 for x in w) / len(w)
        return math.sqrt(var) / abs(mu) <= max_cv

    def validation_cadence(self, job_id: str) -> Dict:
        ev = self.events(job_id, "validation")
        if len(ev) < 2:
            return {"count": len(ev)}
        gaps = [b["step"] - a["step"] for a, b in zip(ev, ev[1:])]
        durs = [e.get("duration_s", 0.0) for e in ev]
        return {"count": len(ev), "mean_gap_steps": sum(gaps) / len(gaps),
                "mean_duration_s": sum(durs) / len(durs)}

    # ---- platform indicators ------------------------------------------------
    def comm_overhead(self, job_id: str) -> Optional[float]:
        """fraction of round time spent in push/pull sync."""
        sync = self.series(job_id, "sync_time_s").values
        total = self.series(job_id, "round_time_s").values
        if not sync or not total:
            return None
        return sum(sync) / max(sum(total), 1e-9)


# ---------------------------------------------------------------------------
# Extensible log parsing (paper: custom parsers per framework/log source)
# ---------------------------------------------------------------------------


class LogParserService:
    """Parses raw log streams into (metric, step, value) triples via
    pluggable regex parsers — 'extensibility here allows for the
    installation of custom parsers to collect and correlate data'."""

    def __init__(self, metrics: MetricsService):
        self.metrics = metrics
        self._parsers: List[Callable[[str], List[Dict]]] = []
        self.register_regex(
            r"step[= ](?P<step>\d+).*?loss[= ](?P<loss>[\d.eE+-]+)",
            {"loss": "loss"})
        self.register_regex(
            r"step[= ](?P<step>\d+).*?acc(uracy)?[= ](?P<acc>[\d.eE+-]+)",
            {"acc": "accuracy"})

    def register_regex(self, pattern: str, fields: Dict[str, str]):
        rx = re.compile(pattern)

        def parse(line: str) -> List[Dict]:
            m = rx.search(line)
            if not m:
                return []
            step = int(m.group("step"))
            out = []
            for grp, metric in fields.items():
                try:
                    out.append({"metric": metric, "step": step,
                                "value": float(m.group(grp))})
                except (IndexError, ValueError):
                    pass
            return out
        self._parsers.append(parse)

    def register(self, parser: Callable[[str], List[Dict]]):
        self._parsers.append(parser)

    def feed(self, job_id: str, line: str) -> int:
        n = 0
        for p in self._parsers:
            try:
                recs = p(line)
            except Exception as e:
                # a broken custom parser must not break the feed (or the
                # other parsers) for every subsequent log line
                log.warning("log parser failed on %r: %s: %s",
                            line, type(e).__name__, e,
                            extra={"job_id": job_id})
                continue
            for rec in recs:
                self.metrics.record(job_id, rec["metric"], rec["step"],
                                    rec["value"])
                n += 1
        return n
