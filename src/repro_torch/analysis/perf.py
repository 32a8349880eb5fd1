"""Live per-job roofline estimates — the service behind ``status.perf``:
the counterpart of ``repro/analysis/perf.py``.

At plan (or engine-start) time each backend hands a :class:`JobPerf` a
callable that counts its hot program — the software-PS learner step
(``LMPlugin.program_cost``) or the serving decode step — on the meta
device (``analysis/roofline.py:count_program``). The count runs on a
background thread, once per job; it launches nothing and allocates no
device memory, so it need not wait for the step's kernel build. The
result is folded together with the live measured rate into the
``status.perf`` payload::

    {"state": "ready", "bound": "memory-bound",
     "flops_per_step_per_device": ..., "hbm_gb_per_step": ...,
     "attainable_steps_per_s": ..., "measured_steps_per_s": ...,
     "pct_of_attainable": 12.3,
     "summary": "12.3% of attainable FLOPs, memory-bound"}

The machine model is the H100 SXM roofline (``PEAK_FLOPS``/``HBM_BW`` in
analysis/roofline.py): the estimate describes the program the job runs
on the card, so the attainable rate is the card's ceiling — a CPU job
honestly reports a tiny ``pct_of_attainable``. Disable with
``DLAAS_PERF=0`` (the payload then reports ``{"state": "disabled"}``).

Where this differs from the reference: ``start_async(cost_fn,
wait_event)`` takes a callable that returns ``count_program``'s dict
(the analysis itself), where the reference's takes one that returns HLO
text and analyses it; and ``JobPerf`` has no ``kernel_scopes`` (the
port's kernels count as one step each in ``count_program``).
"""
from __future__ import annotations

import atexit
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.perf")


def enabled() -> bool:
    return os.environ.get("DLAAS_PERF", "1") != "0"


# Estimate threads are tracked and joined from atexit: shutdown flips the
# flag (threads waiting at their gate bail out immediately; no new count
# starts) and counts in flight get a bounded grace period. One count
# runs at a time — estimates are advisory, so they should contend with
# at most one job's real work, not with each other.
_live: List[threading.Thread] = []
_live_lock = threading.Lock()
_shutdown = threading.Event()
_lower_gate = threading.Lock()


@atexit.register
def _drain_estimate_threads(_timeout: float = 60.0) -> None:
    _shutdown.set()
    with _live_lock:
        threads = list(_live)
    deadline = time.time() + _timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.time()))


class JobPerf:
    """Roofline estimate of one job's hot program, computed once in the
    background and snapshotted into every status poll."""

    def __init__(self, job_id: str, metrics=None, *, unit: str = "step"):
        self.job_id = job_id
        self.metrics = metrics
        self.unit = unit
        self.state = "pending" if enabled() else "disabled"
        self.analysis: Optional[Dict] = None
        self.error: Optional[str] = None
        self._lock = threading.Lock()

    # ---- producer -------------------------------------------------------
    def start_async(self, cost_fn: Callable[[], Dict],
                    wait_event: Optional[threading.Event] = None) -> None:
        """Take ``cost_fn()``'s analysis (``count_program``'s dict) on a
        daemon thread. ``wait_event``, when given, is honored first.
        Idempotent: only the first call (per JobPerf) starts a thread —
        re-incarnated job bodies may call again after a preemption."""
        if _shutdown.is_set():
            return
        with self._lock:
            if self.state != "pending":
                return
            self.state = "running"

        def run():
            try:
                if wait_event is not None:
                    # poll in short slices so shutdown interrupts the wait
                    deadline = time.time() + 300
                    while (time.time() < deadline
                           and not _shutdown.is_set()
                           and not wait_event.wait(timeout=1.0)):
                        pass
                if _shutdown.is_set():
                    with self._lock:
                        self.error = "interpreter shutdown"
                        self.state = "error"
                    return
                with _lower_gate:
                    analysis = cost_fn()
                with self._lock:
                    self.analysis = analysis
                    self.state = "ready"
                if self.metrics is not None:
                    self.metrics.incr(self.job_id,
                                      "perf_estimates_total")
                    snap = self.snapshot()
                    self.metrics.record(
                        self.job_id, "perf_attainable_per_s", 0,
                        snap.get("attainable_%ss_per_s" % self.unit, 0.0))
                    self.metrics.event(self.job_id, "perf_estimate", 0,
                                       bound=snap.get("bound"))
            except Exception as e:       # advisory: log, never crash a job
                with self._lock:
                    self.error = f"{type(e).__name__}: {e}"
                    self.state = "error"
                log.warning("perf estimate failed for %s: %s",
                            self.job_id, self.error)
            finally:
                with _live_lock:
                    if t in _live:
                        _live.remove(t)
        t = threading.Thread(target=run, daemon=True,
                             name=f"perf-{self.job_id}")
        with _live_lock:
            _live.append(t)
        t.start()

    # ---- consumer -------------------------------------------------------
    def snapshot(self, measured_per_s: Optional[float] = None) -> Dict:
        """The ``status.perf`` payload, optionally folded with a live
        measured rate (steps/s for training, decode steps/s for
        serving)."""
        with self._lock:
            state, analysis, error = self.state, self.analysis, self.error
        out: Dict = {"state": state, "unit": self.unit}
        if error:
            out["error"] = error
        if analysis is None:
            return out
        terms = {"compute": analysis["compute_s"],
                 "memory": analysis["memory_s"],
                 "collective": analysis["collective_s"]}
        dominant = max(terms, key=terms.get)
        bound_s = max(terms.values())
        attainable = 1.0 / bound_s if bound_s > 0 else float("inf")
        out.update({
            "bound": f"{dominant}-bound",
            "flops_per_step_per_device": analysis["flops_per_device"],
            "hbm_gb_per_step": round(
                analysis["hbm_bytes_per_device"] / 1e9, 6),
            "compute_s": analysis["compute_s"],
            "memory_s": analysis["memory_s"],
            "collective_s": analysis["collective_s"],
            f"attainable_{self.unit}s_per_s": round(attainable, 3),
        })
        if measured_per_s is not None and measured_per_s > 0:
            pct = 100.0 * measured_per_s / attainable \
                if attainable not in (0.0, float("inf")) else 0.0
            out[f"measured_{self.unit}s_per_s"] = round(measured_per_s, 3)
            out["pct_of_attainable"] = round(pct, 3)
            out["summary"] = (f"{pct:.1f}% of attainable FLOPs, "
                              f"{dominant}-bound")
        else:
            out["summary"] = (f"{dominant}-bound, attainable "
                              f"{attainable:.1f} {self.unit}s/s "
                              f"on the accelerator roofline")
        return out


def measured_rate_from_metrics(metrics, job_id: str,
                               metric: str = "round_time_s",
                               tail: int = 10) -> Optional[float]:
    """Mean live rate (1/round-time) over the last ``tail`` recorded
    rounds — the measured term of ``pct_of_attainable``."""
    if metrics is None:
        return None
    series = metrics.series(job_id, metric)
    vals = [v for v in series.values[-tail:] if v > 0]
    if not vals:
        return None
    return len(vals) / sum(vals)
