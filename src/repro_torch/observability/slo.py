"""Declarative SLOs, multi-window burn-rate evaluation, and anomaly
detectors — the signal half of the platform's immune system.

The model follows the SRE burn-rate playbook: an SLO is an objective
over a ratio of good/bad observations ("99% of requests under the
latency threshold"), and an alert fires when the *error-budget burn
rate* — the rate at which the objective's failure allowance is being
consumed — exceeds a factor over BOTH a long and a short window. The
long window keeps the alert from flapping on blips; the short window
makes it resolve quickly once the burn stops.

    burn = (bad / total) / (1 - objective)

burn == 1.0 means the budget is being spent exactly at the sustainable
rate; burn >= factor over both windows of a ``BurnWindow`` means the
budget will be exhausted ``factor``x too fast, so page.

Windows here are scaled to the smoke-test timescale (seconds, not the
canonical 1h/5m) — the math is timescale-free.

Alongside the ratio SLOs live three anomaly detectors for hot paths
where a ratio is the wrong shape:

  * ``detect_stragglers`` — per-slot BSP arrival lag at the parameter
    server. The BSP barrier inverts learner-side timing (fast learners
    block *waiting* for the straggler, so their push latency looks
    huge while the straggler's looks tiny); the PS-side arrival time
    relative to the round's first arrival is the honest signal.
  * ``detect_queue_growth`` — serving admission queue monotonically
    growing toward its bound (saturation before the p99 SLO notices).
  * ``detect_checkpoint_stall`` — checkpoint-publish cadence broken
    (steps since the last publish far exceeds the observed cadence).

``AlertManager`` is the sink: deduplicating fire/resolve bookkeeping, a
bounded history, live ``BoundedStream`` taps for ``alerts?follow=1``,
and a remediation log the HealthController appends to
(``platform/health.py`` owns the acting half).

Copied from ``repro/observability/slo.py`` unchanged apart from import
paths and the logger's name (under ``"repro_torch"``, see ``log.py``):
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from statistics import median
from typing import Dict, List, Optional, Tuple

from repro_torch.observability.stream import BoundedStream

log = logging.getLogger("repro_torch.slo")


def burn_rate(bad: float, total: float, objective: float) -> float:
    """Error-budget burn rate: (bad/total) / (1 - objective).

    Total under the math's domain: zero observations burn nothing
    (0.0); a zero-width budget (objective >= 1.0) burns infinitely
    fast the moment anything fails, and not at all when nothing does.
    Never raises, never returns a negative value.
    """
    if total <= 0:
        return 0.0
    bad = max(0.0, min(float(bad), float(total)))
    err = bad / float(total)
    budget = 1.0 - objective
    if budget <= 0:
        return float("inf") if bad > 0 else 0.0
    return err / budget


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window alerting rule: fire when the burn rate is at
    least ``factor`` over BOTH the long and the short window."""
    long_s: float
    short_s: float
    factor: float


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective. ``kind`` groups alerts for the
    taxonomy/remediation mapping; ``scope`` is the entity (tenant,
    endpoint id, job id) the SLI is measured for."""
    name: str
    kind: str                       # queue_wait | availability | latency_p99 | throughput
    scope: str
    objective: float                # e.g. 0.95 -> 5% error budget
    threshold: float = 0.0          # SLI threshold defining "bad", for display
    windows: Tuple[BurnWindow, ...] = (BurnWindow(3.0, 0.75, 2.0),)
    severity: str = "page"          # page | ticket
    description: str = ""


class SLOTracker:
    """Good/bad observations for one SLOSpec, kept in a bounded
    time-indexed ring, evaluated against the spec's burn windows."""

    def __init__(self, spec: SLOSpec, *, cap: int = 4096):
        self.spec = spec
        self._obs: deque = deque(maxlen=cap)   # (t, good, bad)
        self._lock = threading.Lock()

    def observe(self, good: float, bad: float,
                now: Optional[float] = None):
        with self._lock:
            self._obs.append((time.time() if now is None else now,
                              float(good), float(bad)))

    def burn(self, window_s: float, now: Optional[float] = None) -> float:
        """Burn rate over the trailing ``window_s`` seconds."""
        now = time.time() if now is None else now
        lo = now - window_s
        good = bad = 0.0
        with self._lock:
            for t, g, b in self._obs:
                if t >= lo:
                    good += g
                    bad += b
        return burn_rate(bad, good + bad, self.spec.objective)

    def evaluate(self, now: Optional[float] = None) -> Dict:
        """Evaluate every window; firing iff some window has BOTH its
        long- and short-window burn at or above its factor."""
        now = time.time() if now is None else now
        detail = []
        firing = False
        worst = 0.0
        for w in self.spec.windows:
            bl = self.burn(w.long_s, now)
            bs = self.burn(w.short_s, now)
            hit = bl >= w.factor and bs >= w.factor
            firing = firing or hit
            worst = max(worst, min(bl, bs))
            detail.append({"long_s": w.long_s, "short_s": w.short_s,
                           "factor": w.factor, "burn_long": round(bl, 4),
                           "burn_short": round(bs, 4), "firing": hit})
        return {"name": self.spec.name, "kind": self.spec.kind,
                "scope": self.spec.scope,
                "objective": self.spec.objective,
                "firing": firing, "burn": round(worst, 4),
                "windows": detail}


@dataclass
class Alert:
    """One alert instance (firing or resolved)."""
    seq: int
    name: str
    kind: str
    scope: str
    severity: str
    state: str                       # firing | resolved
    since: float
    value: float = 0.0
    labels: Dict = field(default_factory=dict)
    resolved_at: Optional[float] = None

    def to_dict(self) -> Dict:
        return {"seq": self.seq, "name": self.name, "kind": self.kind,
                "scope": self.scope, "severity": self.severity,
                "state": self.state, "since": self.since,
                "resolved_at": self.resolved_at,
                "value": self.value, "labels": dict(self.labels)}


class AlertManager:
    """Deduplicating alert sink with bounded history, live stream taps,
    and the remediation log.

    ``fire`` on an already-active (name, scope) refreshes its value
    without emitting a duplicate record; ``resolve`` moves it to
    history. Every transition (and every remediation) is published to
    subscribed ``BoundedStream`` taps as an NDJSON-able dict.
    """

    def __init__(self, *, history: int = 256):
        self._lock = threading.Lock()
        self._seq = 0
        self._active: Dict[Tuple[str, str], Alert] = {}
        self._history: deque = deque(maxlen=history)
        self._remediations: deque = deque(maxlen=history)
        self._streams: List[BoundedStream] = []
        self.fired_total = 0
        self.resolved_total = 0

    # ---- transitions -----------------------------------------------------
    def fire(self, name: str, kind: str, scope: str, *,
             severity: str = "page", value: float = 0.0,
             now: Optional[float] = None, **labels) -> Alert:
        now = time.time() if now is None else now
        with self._lock:
            key = (name, scope)
            al = self._active.get(key)
            if al is not None:
                al.value = float(value)
                al.labels.update(labels)
                return al
            self._seq += 1
            self.fired_total += 1
            al = Alert(self._seq, name, kind, scope, severity, "firing",
                       now, float(value), dict(labels))
            self._active[key] = al
        log.warning("alert firing: %s kind=%s scope=%s value=%.4g",
                    name, kind, scope, value)
        self._publish({"type": "alert", **al.to_dict()})
        return al

    def resolve(self, name: str, scope: str,
                now: Optional[float] = None) -> Optional[Alert]:
        now = time.time() if now is None else now
        with self._lock:
            al = self._active.pop((name, scope), None)
            if al is None:
                return None
            al.state = "resolved"
            al.resolved_at = now
            self.resolved_total += 1
            self._history.append(al)
        log.info("alert resolved: %s scope=%s", name, scope)
        self._publish({"type": "alert", **al.to_dict()})
        return al

    def record_remediation(self, action: str, *, alert: str, scope: str,
                           now: Optional[float] = None, **detail) -> Dict:
        now = time.time() if now is None else now
        rec = {"type": "remediation", "action": action, "alert": alert,
               "scope": scope, "ts": now, **detail}
        with self._lock:
            self._remediations.append(rec)
        log.warning("remediation: %s for alert=%s scope=%s %s",
                    action, alert, scope, detail or "")
        self._publish(rec)
        return rec

    # ---- queries ---------------------------------------------------------
    def active(self) -> List[Dict]:
        with self._lock:
            return [a.to_dict() for a in sorted(
                self._active.values(), key=lambda a: a.seq)]

    def history(self) -> List[Dict]:
        with self._lock:
            return [a.to_dict() for a in self._history]

    def remediations(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._remediations]

    def is_active(self, name: str, scope: str) -> bool:
        with self._lock:
            return (name, scope) in self._active

    def counts_by_kind(self) -> Dict[str, Dict[str, float]]:
        """Active count per (kind, severity) + total fired per kind —
        the ``dlaas_alerts_*`` exporter feed."""
        with self._lock:
            active: Dict[Tuple[str, str], int] = {}
            for a in self._active.values():
                k = (a.kind, a.severity)
                active[k] = active.get(k, 0) + 1
            fired: Dict[str, int] = {}
            for a in list(self._active.values()) + list(self._history):
                fired[a.name] = fired.get(a.name, 0) + 1
            actions: Dict[str, int] = {}
            for r in self._remediations:
                actions[r["action"]] = actions.get(r["action"], 0) + 1
        return {"active": {f"{k}|{s}": v for (k, s), v in active.items()},
                "fired": fired, "remediations": actions}

    # ---- live taps -------------------------------------------------------
    def stream(self, maxlen: int = 256) -> BoundedStream:
        s = BoundedStream(maxlen=maxlen)
        with self._lock:
            self._streams.append(s)
        return s

    def unsubscribe(self, stream: BoundedStream):
        with self._lock:
            if stream in self._streams:
                self._streams.remove(stream)
        stream.close()

    def _publish(self, rec: Dict):
        with self._lock:
            taps = list(self._streams)
        for s in taps:
            s.put(rec)


# --------------------------------------------------------------------------
# anomaly detectors
# --------------------------------------------------------------------------

def detect_stragglers(metrics, job_id: str, n_learners: int, *,
                      ratio: float = 3.0, min_abs_s: float = 0.02,
                      tail: int = 4) -> List[Dict]:
    """PS-round straggler detection from per-slot BSP arrival lag.

    ``software_ps.push`` records ``ps_lag_s.<slot>`` — each slot's
    arrival time relative to the round's FIRST arrival — so a healthy
    gang shows near-zero lag everywhere and a straggler shows a lag
    equal to how long it kept the barrier waiting. A slot is an outlier
    when its tail-mean lag exceeds ``ratio`` x the median of the OTHER
    slots' tail-means, with an absolute floor ``min_abs_s`` so healthy
    sub-millisecond jitter can never trip the ratio.
    """
    if n_learners < 2:
        return []
    lags: Dict[int, float] = {}
    for slot in range(n_learners):
        vals = metrics.series(job_id, f"ps_lag_s.{slot}").window(tail)
        if vals:
            lags[slot] = sum(vals) / len(vals)
    if len(lags) < 2:
        return []
    out = []
    for slot, lag in sorted(lags.items()):
        others = [v for s, v in lags.items() if s != slot]
        base = max(median(others), min_abs_s)
        if lag > ratio * base:
            out.append({"slot": slot, "lag_s": round(lag, 4),
                        "median_others_s": round(median(others), 4),
                        "ratio": round(lag / base, 2)})
    return out


def detect_queue_growth(stats: Dict, history: List[float], *,
                        window: int = 8, frac: float = 0.75) -> bool:
    """Serving admission-queue saturation: the last ``window`` depth
    samples are non-decreasing AND the latest is at ``frac`` of the
    queue bound. ``history`` is the caller's rolling depth samples
    (most recent last); ``stats`` is ``engine.stats()``."""
    max_queue = stats.get("max_queue") or 0
    if max_queue <= 0 or len(history) < window:
        return False
    tail = history[-window:]
    if any(b < a for a, b in zip(tail, tail[1:])):
        return False
    return tail[-1] >= frac * max_queue


def detect_checkpoint_stall(metrics, job_id: str, current_step: int, *,
                            factor: float = 3.0,
                            min_interval: int = 4) -> Optional[Dict]:
    """Checkpoint-publish stall: steps since the last publish exceed
    ``factor`` x the job's observed (or configured) cadence. Needs at
    least one checkpoint to infer a cadence — a job that never
    checkpoints is a config choice, not a stall."""
    cps = metrics.checkpoints(job_id)
    if not cps:
        return None
    steps = [c["step"] for c in cps]
    if len(steps) >= 2:
        gaps = [b - a for a, b in zip(steps, steps[1:]) if b > a]
        cadence = min(gaps) if gaps else steps[0]
    else:
        cadence = max(steps[0], min_interval)
    cadence = max(cadence, min_interval)
    since = current_step - steps[-1]
    if since > factor * cadence:
        return {"last_checkpoint_step": steps[-1],
                "current_step": current_step,
                "steps_since": since, "cadence": cadence}
    return None
