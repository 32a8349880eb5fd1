"""HealthController — the acting half of the platform's immune system.

``observability/slo.py`` owns the math (burn rates, trackers, alert
bookkeeping, anomaly detectors); this module owns the control loop. The
Scheduler calls ``step()`` once per tick (outside its placement lock),
and each throttled evaluation pass:

  1. samples SLIs from the live platform surfaces — per-tenant queue
     wait (fair-share queue ``waiting_s``), per-endpoint availability
     (engine counter deltas) and p99 latency, per-training steps/s
     against the roofline attainable floor;
  2. runs the anomaly detectors — PS-round straggler lag, serving
     admission-queue growth, checkpoint-publish stalls;
  3. fires/resolves alerts through the shared ``AlertManager``; and
  4. maps firing alerts onto the platform's existing remediation
     hooks, with a per-alert cooldown so a persistent burn cannot
     machine-gun the same action every tick:

       straggler            -> preempt that learner task (the drain/
                               requeue path; its next incarnation
                               rejoins the gang clean)
       queue-wait burn      -> autoscaler scale-up hint
       endpoint p99 burn    -> shed load (halve the admission bound ->
                               429 earlier), then escalate: pend an
                               extra decode slot and recycle the server
                               task so its next incarnation applies it
       checkpoint stall     -> request an on-demand checkpoint
       throughput floor     -> ticket alert only (diagnosis, not
                               auto-action: the cause is usually the
                               job itself)

Every alert transition and remediation lands in the trace timeline
(job trace for job-scoped alerts, cluster trace otherwise), in
MetricsService platform counters (exported as ``dlaas_alerts_*``), and
on the ``AlertManager`` streams behind ``GET /v1/alerts?follow=1``.

Copied from ``repro/platform/health.py`` unchanged apart from import
paths and the logger's name (under ``"repro_torch"``, see
``observability/log.py``): the port imports nothing of ``repro``. Its
throughput SLO reads ``status.perf``, the port's roofline of the
learner step on H100 constants (``analysis/perf.py``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.observability.slo import (AlertManager, BurnWindow, SLOSpec,
                                     SLOTracker, detect_checkpoint_stall,
                                     detect_queue_growth,
                                     detect_stragglers)
from repro_torch.observability.trace import CLUSTER_TRACE

log = logging.getLogger("repro_torch.health")

_TERMINAL = ("COMPLETED", "FAILED", "KILLED")

# smoke-timescale default burn windows (the math is timescale-free;
# production would use 1h/5m at factor 14.4 per the SRE workbook)
DEFAULT_WINDOWS = (BurnWindow(3.0, 0.75, 2.0),)


class HealthController:
    """Consumes MetricsService/engine/queue signals, fires SLO + anomaly
    alerts, and drives auto-remediation through existing hooks."""

    def __init__(self, core, *, autoscaler=None,
                 windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS,
                 min_eval_interval_s: float = 0.05,
                 cooldown_s: float = 3.0,
                 queue_wait_s: float = 5.0,
                 queue_wait_objective: float = 0.9,
                 availability_objective: float = 0.95,
                 p99_threshold_s: float = 2.0,
                 p99_objective: float = 0.9,
                 throughput_floor_frac: float = 0.5,
                 throughput_objective: float = 0.8,
                 straggler_ratio: float = 3.0,
                 straggler_min_abs_s: float = 0.02,
                 remediate: bool = True):
        self.core = core
        self.autoscaler = autoscaler
        self.windows = tuple(windows)
        self.min_eval_interval_s = min_eval_interval_s
        self.cooldown_s = cooldown_s
        self.queue_wait_s = queue_wait_s
        self.queue_wait_objective = queue_wait_objective
        self.availability_objective = availability_objective
        self.p99_threshold_s = p99_threshold_s
        self.p99_objective = p99_objective
        self.throughput_floor_frac = throughput_floor_frac
        self.throughput_objective = throughput_objective
        self.straggler_ratio = straggler_ratio
        self.straggler_min_abs_s = straggler_min_abs_s
        self.remediate = remediate

        self.alerts = AlertManager()
        self._lock = threading.Lock()       # tracker/table mutation only
        self._trackers: Dict[Tuple[str, str], SLOTracker] = {}
        self._last_eval = 0.0
        self._last_remediation: Dict[Tuple[str, str], float] = {}
        # per-endpoint rolling state for counter deltas / queue history
        self._ep_counts: Dict[str, Dict[str, int]] = {}
        self._ep_qdepth: Dict[str, List[float]] = {}
        self._shed_stage: Dict[str, int] = {}
        self.steps = 0

    # ---- tracker registry ------------------------------------------------
    def _tracker(self, kind: str, scope: str, objective: float,
                 threshold: float, severity: str = "page",
                 description: str = "") -> SLOTracker:
        key = (kind, scope)
        with self._lock:
            tr = self._trackers.get(key)
            if tr is None:
                spec = SLOSpec(name=f"slo_{kind}", kind=kind, scope=scope,
                               objective=objective, threshold=threshold,
                               windows=self.windows, severity=severity,
                               description=description)
                tr = self._trackers[key] = SLOTracker(spec)
        return tr

    # ---- the control loop ------------------------------------------------
    def step(self, scheduler=None):
        """One throttled health pass. Called from the Scheduler tick
        (outside its lock — remediations re-enter scheduler methods) but
        safe to call directly from tests."""
        now = time.time()
        if now - self._last_eval < self.min_eval_interval_s:
            return
        self._last_eval = now
        self.steps += 1
        scheduler = scheduler if scheduler is not None \
            else self.core.scheduler
        try:
            self._sample_queue_wait(now)
        except Exception as e:
            log.debug("queue-wait sampling failed: %s: %s",
                      type(e).__name__, e)
        try:
            self._sample_endpoints(now)
        except Exception as e:
            log.debug("endpoint sampling failed: %s: %s",
                      type(e).__name__, e)
        try:
            self._sample_trainings(now)
        except Exception as e:
            log.debug("training sampling failed: %s: %s",
                      type(e).__name__, e)
        self._evaluate(scheduler, now)

    # ---- SLI sampling ----------------------------------------------------
    def _sample_queue_wait(self, now: float):
        """Per-tenant fair-share queue wait: bad when the tenant's
        longest-waiting entry exceeds the threshold."""
        raw = self.core.scheduler.queue_status()
        worst: Dict[str, float] = {}
        for e in raw.get("entries", ()):
            w = float(e.get("waiting_s", 0.0))
            worst[e["tenant"]] = max(worst.get(e["tenant"], 0.0), w)
        for tenant, wait in worst.items():
            tr = self._tracker(
                "queue_wait", tenant, self.queue_wait_objective,
                self.queue_wait_s,
                description="fair-share queue wait per tenant")
            bad = 1.0 if wait > self.queue_wait_s else 0.0
            tr.observe(1.0 - bad, bad, now)

    _BAD_COUNTERS = ("rejected_total", "expired_total", "failed_total")

    def _sample_endpoints(self, now: float):
        with self.core._lock:
            eps = list(self.core.endpoints.items())
        for eid, ep in eps:
            eng = getattr(ep, "engine", None)
            if eng is None or self.core.lcm.job_state(eid) in _TERMINAL:
                continue
            st = eng.stats()
            # availability: delta of settled-good vs settled-bad since
            # the last pass (counters are monotonic)
            prev = self._ep_counts.get(eid, {})
            good = st["completed_total"] - prev.get("completed_total", 0)
            bad = sum(st[k] - prev.get(k, 0) for k in self._BAD_COUNTERS)
            self._ep_counts[eid] = {
                k: st[k] for k in ("completed_total",) + self._BAD_COUNTERS}
            if good or bad:
                self._tracker(
                    "availability", eid, self.availability_objective, 1.0,
                    description="request success ratio per endpoint"
                ).observe(good, bad, now)
            # p99 latency: one threshold observation per pass
            p99 = st.get("p99_latency_s")
            if p99 is not None:
                slow = 1.0 if p99 > self.p99_threshold_s else 0.0
                self._tracker(
                    "latency_p99", eid, self.p99_objective,
                    self.p99_threshold_s,
                    description="p99 request latency per endpoint"
                ).observe(1.0 - slow, slow, now)
            # admission-queue growth (anomaly, not a burn SLO)
            hist = self._ep_qdepth.setdefault(eid, [])
            hist.append(float(st.get("queue_depth", 0)))
            del hist[:-64]
            if detect_queue_growth(st, hist):
                self._fire("queue_growth", "anomaly", eid,
                           severity="page",
                           value=hist[-1],
                           max_queue=st.get("max_queue", 0))
            else:
                self._resolve("queue_growth", eid)

    def _sample_trainings(self, now: float):
        with self.core._lock:
            recs = list(self.core.trainings.items())
        for jid, rec in recs:
            if self.core.lcm.job_state(jid) != "PROCESSING":
                # clear any straggler/stall alert for a job that left
                # PROCESSING (terminal, preempted, paused)
                self._resolve_prefix(jid)
                continue
            plan = rec.get("plan")
            spec = rec.get("spec")
            if plan is None:
                continue
            # -- PS straggler lag (anomaly) --------------------------------
            ps = plan.meta.get("ps")
            n_learners = getattr(spec, "learners", 1) if spec else 1
            if ps is not None and n_learners > 1:
                outliers = detect_stragglers(
                    self.core.metrics, jid, n_learners,
                    ratio=self.straggler_ratio,
                    min_abs_s=self.straggler_min_abs_s)
                hot = {o["slot"] for o in outliers}
                for o in outliers:
                    self._fire("straggler", "anomaly",
                               f"{jid}/learner-{o['slot']}",
                               severity="page", value=o["lag_s"],
                               job_id=jid, slot=o["slot"],
                               ratio=o["ratio"])
                for slot in range(n_learners):
                    if slot not in hot:
                        self._resolve("straggler", f"{jid}/learner-{slot}")
            # -- checkpoint-publish stall (anomaly) ------------------------
            loss = self.core.metrics.series(jid, "loss")
            step_now = loss.steps[-1] if loss.steps else 0
            stall = detect_checkpoint_stall(self.core.metrics, jid,
                                            step_now)
            if stall is not None:
                self._fire("checkpoint_stall", "anomaly", jid,
                           severity="ticket",
                           value=stall["steps_since"], job_id=jid,
                           **{k: v for k, v in stall.items()
                              if k != "steps_since"})
            else:
                self._resolve("checkpoint_stall", jid)
            # -- steps/s floor vs roofline attainable (burn SLO) -----------
            perf = plan.meta.get("perf")
            if perf is not None:
                try:
                    from repro_torch.analysis.perf import \
                        measured_rate_from_metrics
                    snap = perf.snapshot(measured_rate_from_metrics(
                        self.core.metrics, jid))
                except Exception:
                    snap = {}
                att = snap.get("attainable_steps_per_s")
                meas = snap.get("measured_steps_per_s")
                if att and meas is not None:
                    floor = self.throughput_floor_frac * att
                    slow = 1.0 if meas < floor else 0.0
                    self._tracker(
                        "throughput", jid, self.throughput_objective,
                        floor, severity="ticket",
                        description="steps/s vs roofline attainable"
                    ).observe(1.0 - slow, slow, now)

    # ---- alert transitions (side effects centralized) --------------------
    def _job_of(self, kind: str, scope: str, labels: Dict) -> str:
        """Which trace an alert's events land in."""
        jid = labels.get("job_id") or scope.split("/", 1)[0]
        if self.core._known_job(jid):
            return jid
        return CLUSTER_TRACE

    def _fire(self, name: str, kind: str, scope: str, *,
              severity: str = "page", value: float = 0.0, **labels):
        if self.alerts.is_active(name, scope):
            self.alerts.fire(name, kind, scope, severity=severity,
                             value=value, **labels)
            return
        self.alerts.fire(name, kind, scope, severity=severity,
                         value=value, **labels)
        m = self.core.metrics
        m.incr("platform", "alerts_fired_total")
        m.incr("platform", f"alerts_fired_{name}")
        self.core.tracer.event(self._job_of(kind, scope, labels),
                               "alert", alert=name, kind=kind,
                               scope=scope, severity=severity,
                               value=value)

    def _resolve(self, name: str, scope: str):
        al = self.alerts.resolve(name, scope)
        if al is None:
            return
        self.core.metrics.incr("platform", "alerts_resolved_total")
        self.core.tracer.event(self._job_of(al.kind, scope, al.labels),
                               "alert", alert=name, kind=al.kind,
                               scope=scope, state="resolved")
        if name in ("slo_latency_p99", "queue_growth") \
                and not (self.alerts.is_active("slo_latency_p99", scope)
                         or self.alerts.is_active("queue_growth", scope)):
            self._unshed(scope)

    def _resolve_prefix(self, jid: str):
        for al in self.alerts.active():
            if al["scope"] == jid or al["scope"].startswith(jid + "/"):
                self._resolve(al["name"], al["scope"])
        # drop the job's SLO trackers too: a preempted/terminal job's
        # stale burn history must not refire the alert every pass while
        # the job isn't even running (fire/resolve flap); a fresh
        # tracker is rebuilt from live SLIs once it's PROCESSING again
        with self._lock:
            for key in [k for k, t in self._trackers.items()
                        if t.spec.scope == jid
                        or t.spec.scope.startswith(jid + "/")]:
                del self._trackers[key]

    # ---- evaluation + remediation ----------------------------------------
    def _evaluate(self, scheduler, now: float):
        with self._lock:
            trackers = list(self._trackers.values())
        for tr in trackers:
            ev = tr.evaluate(now)
            spec = tr.spec
            if ev["firing"]:
                self._fire(spec.name, spec.kind, spec.scope,
                           severity=spec.severity, value=ev["burn"])
            else:
                self._resolve(spec.name, spec.scope)
        if not self.remediate:
            return
        for al in self.alerts.active():
            try:
                self._remediate(al, scheduler, now)
            except Exception as e:
                log.warning("remediation for %s/%s failed: %s: %s",
                            al["name"], al["scope"],
                            type(e).__name__, e)

    def _cooled(self, name: str, scope: str, now: float) -> bool:
        key = (name, scope)
        last = self._last_remediation.get(key)
        if last is not None and now - last < self.cooldown_s:
            return False
        self._last_remediation[key] = now
        return True

    def _record(self, action: str, al: Dict, now: float, **detail):
        self.alerts.record_remediation(action, alert=al["name"],
                                       scope=al["scope"], now=now,
                                       **detail)
        self.core.metrics.incr("platform", "remediations_total")
        self.core.metrics.incr("platform", f"remediations_{action}")
        self.core.tracer.event(
            self._job_of(al["kind"], al["scope"], al["labels"]),
            "remediation", action=action, alert=al["name"],
            scope=al["scope"], **detail)

    def _remediate(self, al: Dict, scheduler, now: float):
        name, scope = al["name"], al["scope"]
        if name == "straggler":
            if not self._cooled(name, scope, now):
                return
            jid = al["labels"]["job_id"]
            slot = al["labels"]["slot"]
            task_id = f"{jid}-learners.{slot}"
            scheduler.preempt(task_id)
            self._record("restart_learner", al, now, task=task_id)
        elif name == "slo_queue_wait":
            if self.autoscaler is None \
                    or not self._cooled(name, scope, now):
                return
            self.autoscaler.hint_scale_up(reason=f"queue_wait:{scope}")
            self._record("scale_up_hint", al, now, tenant=scope)
        elif name in ("slo_latency_p99", "queue_growth"):
            if not self._cooled("latency", scope, now):
                return
            eng = self._engine(scope)
            if eng is None:
                return
            stage = self._shed_stage.get(scope, 0)
            if stage == 0:
                eng.shed(0.5)
                self._shed_stage[scope] = 1
                self._record("shed_load", al, now,
                             shed_limit=eng.stats().get("shed_limit"))
            else:
                eng.add_slot(1)
                eng.unshed()
                self._shed_stage[scope] = 0
                # recycle the server task: the next incarnation's
                # start() applies the pended slot
                scheduler.preempt_app(f"{scope}-servers")
                self._record("add_replica_slot", al, now,
                             capacity=eng.capacity + 1)
        elif name == "checkpoint_stall":
            if not self._cooled(name, scope, now):
                return
            jid = al["labels"].get("job_id", scope)
            try:
                self.core.checkpoint_training(jid)
            except KeyError:
                return
            self._record("request_checkpoint", al, now, job=jid)
        # slo_availability / slo_throughput: diagnosis alerts — the
        # queue-growth/latency paths already act on the serving side,
        # and a slow training is the job's own physics

    def _engine(self, endpoint_id: str):
        with self.core._lock:
            ep = self.core.endpoints.get(endpoint_id)
        return getattr(ep, "engine", None) if ep is not None else None

    def _unshed(self, endpoint_id: str):
        eng = self._engine(endpoint_id)
        if eng is not None and self._shed_stage.pop(endpoint_id, 0):
            eng.unshed()

    # ---- surfaces ---------------------------------------------------------
    def slo_status(self) -> List[Dict]:
        """Every tracker's current evaluation (GET /v1/slo)."""
        now = time.time()
        with self._lock:
            trackers = list(self._trackers.values())
        return [t.evaluate(now) for t in trackers]

    def alert_report(self) -> Dict:
        """Active + recent alerts and the remediation log
        (GET /v1/alerts)."""
        return {"active": self.alerts.active(),
                "history": self.alerts.history(),
                "remediations": self.alerts.remediations()}
