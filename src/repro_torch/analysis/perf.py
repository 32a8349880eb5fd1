"""``JobPerf``: the ``status.perf`` payload of a job or an endpoint.

A stand-in for ``repro/analysis/perf.py``'s ``JobPerf``. The reference
estimates each job's hot program by parsing its compiled XLA HLO against
TPU v5e constants; the port has no HLO, and its roofline on H100
constants, with FLOP and byte counts taken from torch, is still to be
written. Until then every ``JobPerf`` of the port is in the reference's
disabled state, the one ``DLAAS_PERF=0`` gives there
(``perf.py:40-41``, ``:143-153``): ``start_async`` starts nothing and
``snapshot`` returns ``{"state": "disabled", "unit": unit}``. The
constructor and both signatures are the reference's, so backends and
endpoints call it as they call the reference's.

``measured_rate_from_metrics`` is a copy of the reference's
(``perf.py:184-197``): the live rate the service layer hands to
``snapshot``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class JobPerf:
    """Roofline estimate of one job's hot program: disabled."""

    def __init__(self, job_id: str, metrics=None, *, unit: str = "step"):
        self.job_id = job_id
        self.metrics = metrics
        self.unit = unit
        self.state = "disabled"

    def start_async(self, lower_fn: Callable[[], str],
                    wait_event: Optional[threading.Event] = None) -> None:
        """No estimate to start: ``lower_fn`` is never called."""

    def snapshot(self, measured_per_s: Optional[float] = None) -> Dict:
        """The ``status.perf`` payload of the disabled state."""
        return {"state": self.state, "unit": self.unit}


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
