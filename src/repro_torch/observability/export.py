"""Prometheus text exposition for the platform (``GET /metrics``).

Stdlib-only and duck-typed against the core: ``build_platform_families``
reads the public status surfaces (queue/cluster snapshots, endpoint
engine stats, journal stats, autotune cache counters) plus the
MetricsService typed stores (``_counters``/``_gauges``/``_hists``) and
renders version 0.0.4 text exposition.

Every catalogued family emits its ``# HELP``/``# TYPE`` header even when
it currently has no samples — scrapers (and verify.sh) can assert on a
stable name catalogue regardless of platform state.

``parse_prometheus_text`` is the matching strict validator: verify.sh
and the tests feed scraped output through it and fail on any malformed
line, so the exporter can never silently drift from the format.

Copied from ``repro/observability/export.py`` unchanged apart from
import paths and the logger's name (under ``"repro_torch"``, see
``log.py``): the three autotune-cache families
(``dlaas_autotune_cache_*``) read the port's own cache
(``kernels/autotune.py``). The port imports nothing of ``repro``.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("repro_torch.export")

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?[0-9]+))?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

# default latency buckets for span-duration histograms (seconds)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


def sanitize(name: str) -> str:
    """Coerce an arbitrary metric/counter name into a legal Prometheus
    metric-name fragment."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    f = float(value)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Family:
    """One metric family: name, type, help, and its samples."""

    def __init__(self, name: str, mtype: str, help_text: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"bad metric type {mtype!r}")
        self.name = name
        self.mtype = mtype
        self.help_text = help_text
        # (suffix, labels, value) — suffix is "" except histogram parts
        self._samples: List[Tuple[str, Dict, float]] = []

    def add(self, value: float, **labels):
        self._samples.append(("", labels, float(value)))
        return self

    def add_histogram(self, hist: Dict, **labels):
        """``hist`` holds non-cumulative per-bucket ``counts`` aligned
        with ``buckets`` bounds, plus ``sum`` and ``count``."""
        bounds = list(hist.get("buckets", ()))
        counts = list(hist.get("counts", ()))
        cum = 0
        for bound, c in zip(bounds, counts):
            cum += c
            self._samples.append(
                ("_bucket", dict(labels, le=_fmt(bound)), float(cum)))
        total = int(hist.get("count", cum))
        self._samples.append(
            ("_bucket", dict(labels, le="+Inf"), float(total)))
        self._samples.append(("_sum", labels, float(hist.get("sum", 0.0))))
        self._samples.append(("_count", labels, float(total)))
        return self

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help_text}",
                 f"# TYPE {self.name} {self.mtype}"]
        for suffix, labels, value in self._samples:
            if labels:
                body = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(
                    f"{self.name}{suffix}{{{body}}} {_fmt(value)}")
            else:
                lines.append(f"{self.name}{suffix} {_fmt(value)}")
        return "\n".join(lines)


def render(families: List[Family]) -> str:
    return "\n".join(f.render() for f in families) + "\n"


def parse_prometheus_text(text: str) -> Dict:
    """Strict-ish validator for version 0.0.4 text exposition. Returns
    ``{"families": {name: type}, "samples": {name: count}}``; raises
    ValueError naming the first malformed line."""
    families: Dict[str, str] = {}
    samples: Dict[str, int] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {i}: malformed comment: {line!r}")
            if not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {i}: bad family name: {line!r}")
            if parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(f"line {i}: bad TYPE: {line!r}")
                families[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
        raw_labels = m.group("labels")
        if raw_labels is not None and raw_labels != "":
            stripped = _LABEL_PAIR_RE.sub("", raw_labels)
            if stripped.strip(", ") != "":
                raise ValueError(f"line {i}: malformed labels: {line!r}")
            for k, _ in _LABEL_PAIR_RE.findall(raw_labels):
                if not _LABEL_RE.match(k):
                    raise ValueError(
                        f"line {i}: bad label name {k!r}: {line!r}")
        val = m.group("value")
        if val not in ("NaN", "+Inf", "-Inf"):
            try:
                float(val)
            except ValueError:
                raise ValueError(f"line {i}: bad value: {line!r}")
        samples[m.group("name")] = samples.get(m.group("name"), 0) + 1
    return {"families": families, "samples": samples}


# --------------------------------------------------------------------------
# platform collector
# --------------------------------------------------------------------------

def build_platform_families(core) -> List[Family]:
    """Snapshot the whole platform into metric families. ``core`` is a
    DLaaSCore (duck-typed: every section degrades to an empty family if
    its surface is missing or raises)."""
    fams: List[Family] = []

    # -- queue ------------------------------------------------------------
    fq = Family("dlaas_queue_depth", "gauge",
                "Queued tasks per tenant in the fair-share queue.")
    fams.append(fq)
    try:
        qs = core.queue_status()
        per_tenant: Dict[str, int] = {
            t: 0 for t in qs.get("tenants", {})}
        for row in qs.get("queue", ()):
            per_tenant[row["tenant"]] = (
                per_tenant.get(row["tenant"], 0)
                + int(row.get("tasks_queued", 1)))
        for tenant, depth in sorted(per_tenant.items()):
            fq.add(depth, tenant=tenant)
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'queue', type(e).__name__, e)

    # -- cluster ----------------------------------------------------------
    fn = Family("dlaas_cluster_nodes", "gauge",
                "Nodes per lifecycle state.")
    fg = Family("dlaas_cluster_gpus_free", "gauge",
                "Schedulable free GPUs across the cluster.")
    fc = Family("dlaas_cluster_clock", "gauge",
                "Scheduler tick clock.")
    fams += [fn, fg, fc]
    try:
        snap = core.cluster.snapshot()
        by_state: Dict[str, int] = {}
        for n in snap.get("nodes", ()):
            by_state[n["state"]] = by_state.get(n["state"], 0) + 1
        for state, count in sorted(by_state.items()):
            fn.add(count, state=state)
        fg.add(core.cluster.free_gpus())
        fc.add(snap.get("clock", 0))
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'cluster', type(e).__name__, e)

    # -- serving ----------------------------------------------------------
    fo = Family("dlaas_slot_occupancy", "gauge",
                "Active decode slots per serving endpoint.")
    fsq = Family("dlaas_serving_queue_depth", "gauge",
                 "Admission-queue depth per serving endpoint.")
    fams += [fo, fsq]
    try:
        with core._lock:
            eps = list(core.endpoints.items())
        for ep_id, ep in eps:
            eng = getattr(ep, "engine", None)
            if eng is None:
                continue
            st = eng.stats()
            fo.add(st.get("active", 0), endpoint=ep_id)
            fsq.add(st.get("queue_depth", 0), endpoint=ep_id)
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'serving', type(e).__name__, e)

    # -- autotune cache ---------------------------------------------------
    fae = Family("dlaas_autotune_cache_entries", "gauge",
                 "Autotune cache entries loaded in process.")
    fah = Family("dlaas_autotune_cache_hits_total", "counter",
                 "Autotune cache hits this process.")
    fam_ = Family("dlaas_autotune_cache_misses_total", "counter",
                  "Autotune cache misses this process.")
    fams += [fae, fah, fam_]
    try:
        from repro_torch.kernels.autotune import get_cache
        cache = get_cache()
        fae.add(cache.size())
        fah.add(cache.hits)
        fam_.add(cache.misses)
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'autotune', type(e).__name__, e)

    # -- journal ----------------------------------------------------------
    fj = {key: Family(f"dlaas_journal_{key}", mtype, help_text)
          for key, mtype, help_text in (
              ("seq", "counter", "Journal write sequence number."),
              ("snapshot", "gauge",
               "1 when recovery replayed from a snapshot."),
              ("records_replayed", "gauge",
               "Journal records replayed at last recovery."),
              ("dropped", "gauge",
               "Corrupt journal records dropped at last recovery."),
              ("since_compact", "gauge",
               "Appends since the last snapshot compaction."),
              ("compactions_total", "counter",
               "Snapshot compactions performed by this process."))}
    fams += list(fj.values())
    try:
        js = core.zk.journal_live_stats()
        for key, fam in fj.items():
            fam.add(js.get(key, 0))
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'journal', type(e).__name__, e)

    # -- MetricsService typed stores --------------------------------------
    metrics = getattr(core, "metrics", None)
    fp = Family("dlaas_platform_events_total", "counter",
                "Platform counters from MetricsService (platform and "
                "cluster scopes).")
    fjc = Family("dlaas_job_counter", "counter",
                 "Per-job counters from MetricsService.")
    fjm = Family("dlaas_job_metric_last", "gauge",
                 "Last recorded value per job metric series.")
    fams += [fp, fjc, fjm]
    if metrics is not None:
        try:
            counters = metrics.counters_snapshot()
            for scope in ("platform", "cluster"):
                for name, v in sorted(counters.pop(scope, {}).items()):
                    fp.add(v, scope=scope, counter=sanitize(name))
            for job_id, cs in sorted(counters.items()):
                for name, v in sorted(cs.items()):
                    fjc.add(v, job_id=job_id, counter=sanitize(name))
            for job_id, metric, step, value in metrics.last_values():
                fjm.add(value, job_id=job_id, metric=sanitize(metric))
        except Exception as e:
            # a broken surface degrades to an empty family;
            # a scrape must never 500
            log.debug("%s collector failed: %s: %s",
                      'counters', type(e).__name__, e)
        # gauges set via metrics.set_gauge land as their own families
        try:
            for scope, name, value in metrics.gauges_snapshot():
                f = Family(f"dlaas_{sanitize(scope)}_{sanitize(name)}",
                           "gauge", f"Gauge {name} ({scope}).")
                f.add(value)
                fams.append(f)
        except Exception as e:
            # a broken surface degrades to an empty family;
            # a scrape must never 500
            log.debug("%s collector failed: %s: %s",
                      'gauges', type(e).__name__, e)
        # span-latency histograms observed by the tracer mirror
        try:
            for scope, name, hist in metrics.hists_snapshot():
                f = Family(f"dlaas_{sanitize(name)}", "histogram",
                           f"Histogram {name} ({scope}).")
                f.add_histogram(hist)
                fams.append(f)
        except Exception as e:
            # a broken surface degrades to an empty family;
            # a scrape must never 500
            log.debug("%s collector failed: %s: %s",
                      'histograms', type(e).__name__, e)

    # -- SLO engine / alerts ----------------------------------------------
    fsb = Family("dlaas_slo_burn_rate", "gauge",
                 "Worst-window error-budget burn rate per SLO tracker.")
    fso = Family("dlaas_slo_objective", "gauge",
                 "Configured objective per SLO tracker.")
    faa = Family("dlaas_alerts_active", "gauge",
                 "Currently-firing alerts by kind and severity.")
    faf = Family("dlaas_alerts_fired_total", "counter",
                 "Alerts ever fired, by alert name.")
    far = Family("dlaas_alerts_remediations_total", "counter",
                 "Auto-remediations taken, by action.")
    fams += [fsb, fso, faa, faf, far]
    try:
        health = core.health
        for ev in health.slo_status():
            fsb.add(min(ev["burn"], 1e12), slo=ev["kind"],
                    scope=ev["scope"])
            fso.add(ev["objective"], slo=ev["kind"], scope=ev["scope"])
        counts = health.alerts.counts_by_kind()
        for key, n in sorted(counts["active"].items()):
            kind, severity = key.split("|", 1)
            faa.add(n, kind=kind, severity=severity)
        for name, n in sorted(counts["fired"].items()):
            faf.add(n, alert=name)
        for action, n in sorted(counts["remediations"].items()):
            far.add(n, action=action)
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'slo', type(e).__name__, e)

    # -- tracing ----------------------------------------------------------
    ft = Family("dlaas_trace_spans", "gauge",
                "Spans currently held in the trace ring.")
    fams.append(ft)
    try:
        ft.add(core.tracer.store.span_count())
    except Exception as e:
        # a broken surface degrades to an empty family;
        # a scrape must never 500
        log.debug("%s collector failed: %s: %s",
                  'tracer', type(e).__name__, e)

    return fams


def prometheus_text(core) -> str:
    return render(build_platform_families(core))
