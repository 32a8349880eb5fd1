"""DLaaS REST API (paper §User Experience: 'interacting with the DLaaS
REST API, either by directly invoking the REST API endpoints, or by using
the DLaaS command-line interface').

Endpoints (v1):
  POST   /v1/models                      {manifest: "<yaml>"} -> model_id
                                         — or deploy an INFERENCE
                                         endpoint: {from_training: <tid>}
                                         (weights from a completed
                                         training) or {arch: <arch-id>}
                                         (fresh init), plus optional
                                         capacity/max_queue/max_new/
                                         max_seq/eos_id/gpus/tenant/
                                         priority -> endpoint_id
  GET    /v1/models                      manifests + serving endpoints
  GET    /v1/models/<id>                 manifest, or endpoint status
                                         (state DEPLOYING|READY|DRAINING|
                                         STOPPED|FAILED + request/latency/
                                         occupancy stats)
  POST   /v1/models/<id>/predict         {tokens: [..], max_new,
                                          deadline_s} -> generated tokens
                                         (429 queue full, 409 draining,
                                          504 deadline missed)
  DELETE /v1/models/<id>                 delete manifest — or drain+stop
                                         a serving endpoint
  POST   /v1/trainings                   {model_id, overrides, tenant,
                                          priority} -> training_id
                                         (429 if the tenant quota can
                                          never fit the job; overrides
                                          may set "distribution":
                                          software-ps|pjit to pick the
                                          execution backend, and
                                          "compression": none|int8 /
                                          "ps_shards": N to tune the
                                          software-PS data plane)
  GET    /v1/trainings
  GET    /v1/trainings/<id>              status + member states +
                                         progress + execution backend +
                                         data_plane (software-ps: wire
                                         bytes pre/post compression,
                                         compression ratio, fused
                                         aggregation ms/round)
  DELETE /v1/trainings/<id>              terminate
  GET    /v1/trainings/<id>/logs         collected logs + structured tail
  GET    /v1/trainings/<id>/logs?follow=1   chunked NDJSON live log
                                         stream off the job's log-hub
                                         tap (tail replay + live records,
                                         deduped by seq; max_s= bounds
                                         the follow window)
  GET    /v1/trainings/<id>/logs/stream  chunked live stream (websocket
                                         analogue of the visualization API)
  GET    /v1/trainings/<id>/timeline     merged trace timeline: lifecycle
                                         phase spans (queue_wait/place/
                                         run), instrumentation spans
                                         (plan/step/checkpoint_publish),
                                         recovery events + overlapping
                                         cluster events
  GET    /v1/trainings/<id>/metrics?follow=1  chunked NDJSON live metric
                                         stream (snapshot line, then
                                         records off the metrics tap)
  GET    /metrics                        whole-platform Prometheus text
                                         exposition (queue depths, node
                                         states, span latencies, journal
                                         counters, per-job
                                         metrics)
  GET    /v1/trainings/<id>/perf         roofline estimate: bound,
                                         attainable vs measured rate
  GET    /v1/trainings/<id>/metrics      common JSON-list metric format
  GET    /v1/trainings/<id>/model        trained weights (binary)
  GET    /v1/cluster                     node lifecycle states, transition
                                         log tail, autoscaler + chaos
                                         drill stats
  POST   /v1/cluster/nodes               {gpus, cpus, memory_mb, spot,
                                          name} — elastically join a node
  POST   /v1/cluster/drain               {node} — cordon + drain; running
                                         work requeues like a preemption
  POST   /v1/trainings/<id>/rescale      requeue the job's gang so it
                                         rebuilds at current capacity
  GET    /v1/queue                       fair-share queue + tenant shares
  GET    /v1/tenants                     per-tenant quota accounting
  POST   /v1/tenants                     {name, weight, quota_gpus, ...}
                                         (403 unless the token is in
                                          core.admin_users, when set)
  GET    /v1/usage                       API metering per user
  GET    /v1/recovery                    last crash-recovery report:
                                         journal replay stats + which
                                         trainings resumed/requeued/
                                         were abandoned + endpoints
                                         redeployed
  GET    /v1/alerts                      SLO/anomaly alerts: active set,
                                         resolved history, remediation
                                         log (auto-restarts, scale-up
                                         hints, load sheds)
  GET    /v1/alerts?follow=1             chunked NDJSON live alert
                                         stream: one snapshot line, then
                                         alert/remediation records as
                                         the health controller emits
                                         them (max_s= bounds the window)
  GET    /v1/slo                         burn-rate evaluation of every
                                         tracked SLO (queue-wait,
                                         availability, p99 latency,
                                         training throughput)

Auth: ``Authorization: Bearer <user-token>``; the token's user is the
metering principal. ``Idempotency-Key: <key>`` on POST /v1/trainings or
POST /v1/models makes the submission replay-safe: retrying with the same
key (including after a control-plane crash) returns the original job
instead of creating — or billing — a duplicate. Stdlib-only
(ThreadingHTTPServer).

The port's counterpart of ``repro/service/rest.py``: the same routes,
bodies and HTTP codes over the port's ``DLaaSCore``. ``DLaaSServer``
passes ``device`` and ``arch_cfgs`` (like every other keyword) to the
core. Run it as

    python -m repro_torch.service.rest <workdir> [port] [device]

where ``device`` defaults to CUDA (the server refuses to start without
a card) and ``cpu`` runs the plain PyTorch path. ``/metrics`` has no
autotune-cache families (``observability/export.py``).
"""
from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from repro_torch.errors import UserError
from repro_torch.platform.queue import QuotaExceeded
from repro_torch.service.core import DLaaSCore
from repro_torch.serving.engine import (DeadlineExceeded, EndpointClosed,
                                        QueueFull)


def _user_of(handler) -> str:
    auth = handler.headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        return auth[len("Bearer "):].strip() or "anon"
    return "anon"


class _Handler(BaseHTTPRequestHandler):
    core: DLaaSCore = None  # set by serve()

    # ---- helpers -----------------------------------------------------------
    def _json(self, obj, code: int = 200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str):
        self._json({"error": msg}, code)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0) or 0)
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    def log_message(self, *a):  # quiet
        pass

    def _route(self):
        """Path segments + a flat query dict (the path may carry
        ``?follow=1`` etc. — never route on the raw self.path)."""
        url = urlsplit(self.path)
        parts = [p for p in url.path.split("/") if p]
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        return parts, query

    # ---- routing -----------------------------------------------------------
    def do_POST(self):
        user = _user_of(self)
        # client-supplied submission key: replaying the same request
        # (same key) returns the original job instead of a duplicate
        idem = self.headers.get("Idempotency-Key") or None
        parts, _ = self._route()
        try:
            if len(parts) == 4 and parts[:2] == ["v1", "models"] \
                    and parts[3] == "predict":
                body = self._body()
                try:
                    return self._json(self.core.predict(
                        parts[2], body.get("tokens") or [],
                        max_new=body.get("max_new"),
                        deadline_s=body.get("deadline_s"), user=user))
                except KeyError as e:
                    return self._err(404, f"no such endpoint: {e}")
            if parts == ["v1", "models"]:
                body = self._body()
                if "manifest" in body:
                    return self._json(
                        self.core.deploy_model(body["manifest"], user,
                                               idempotency_key=idem),
                        201)
                # serving: deploy an inference endpoint from a completed
                # training job's weights, or fresh from an arch
                kw = {k: body[k] for k in
                      ("from_training", "arch", "capacity", "max_queue",
                       "max_new", "max_seq", "gpus", "memory_mb",
                       "eos_id", "seed", "tenant", "priority")
                      if body.get(k) is not None}
                return self._json(
                    self.core.deploy_endpoint(user=user,
                                              idempotency_key=idem,
                                              **kw), 201)
            if parts == ["v1", "trainings"]:
                body = self._body()
                return self._json(
                    self.core.create_training(
                        body["model_id"], body.get("overrides"), user,
                        tenant=body.get("tenant"),
                        priority=body.get("priority"),
                        idempotency_key=idem), 201)
            if len(parts) == 4 and parts[:2] == ["v1", "trainings"] \
                    and parts[3] == "rescale":
                return self._json(self.core.rescale_training(parts[2]))
            if parts == ["v1", "cluster", "nodes"]:
                if not self.core.is_admin(user):
                    return self._err(
                        403, f"user {user!r} may not administer nodes")
                body = self._body()
                kw = {k: body[k] for k in
                      ("gpus", "cpus", "memory_mb", "spot", "name")
                      if body.get(k) is not None}
                return self._json(self.core.add_node(**kw), 201)
            if parts == ["v1", "cluster", "drain"]:
                if not self.core.is_admin(user):
                    return self._err(
                        403, f"user {user!r} may not administer nodes")
                body = self._body()
                return self._json(self.core.drain_node(body["node"]))
            if parts == ["v1", "tenants"]:
                if not self.core.is_admin(user):
                    return self._err(
                        403, f"user {user!r} may not administer tenants")
                body = self._body()

                def num(key, cast):
                    v = body.get(key)
                    return cast(v) if v is not None else None
                return self._json(self.core.register_tenant(
                    body["name"],
                    weight=num("weight", float),
                    quota_gpus=num("quota_gpus", int),
                    quota_cpus=num("quota_cpus", float),
                    quota_memory_mb=num("quota_memory_mb", int)), 201)
            return self._err(404, f"no route POST {self.path}")
        except (QuotaExceeded, QueueFull) as e:
            return self._err(429, str(e))
        except EndpointClosed as e:
            return self._err(409, str(e))
        except DeadlineExceeded as e:
            return self._err(504, str(e))
        except (KeyError, ValueError, UserError) as e:
            # UserError: bad manifest input (e.g. unknown
            # framework.distribution) — the job's fault, HTTP 400
            return self._err(400, str(e))

    def do_GET(self):
        user = _user_of(self)
        parts, query = self._route()
        follow = query.get("follow", "") in ("1", "true", "yes")
        try:
            if parts == ["metrics"]:
                body = self.core.prometheus_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["v1", "models"]:
                rows = [{**r, "kind": "manifest"}
                        for r in self.core.list_models(user)]
                rows += [{**r, "kind": "endpoint"}
                         for r in self.core.list_endpoints(user)]
                return self._json(rows)
            if len(parts) == 3 and parts[:2] == ["v1", "models"]:
                if parts[2] in self.core.endpoints:
                    return self._json(self.core.endpoint_status(parts[2]))
                m = self.core.get_model(parts[2])
                return self._json({"model_id": parts[2],
                                   "manifest": m["manifest"]})
            if parts == ["v1", "trainings"]:
                return self._json(self.core.list_trainings(user))
            if len(parts) == 3 and parts[:2] == ["v1", "trainings"]:
                return self._json(self.core.training_status(parts[2]))
            if len(parts) == 4 and parts[3] == "logs":
                if follow:
                    return self._follow_logs(
                        parts[2],
                        max_s=min(float(query.get("max_s", 5.0)), 60.0))
                return self._json(
                    {"logs": self.core.training_logs(parts[2]),
                     "structured": self.core.loghub.tail(parts[2])})
            if len(parts) == 4 and parts[3] == "timeline":
                return self._json(self.core.training_timeline(parts[2]))
            if len(parts) == 4 and parts[3] == "perf":
                return self._json(self.core.training_perf(parts[2]))
            if len(parts) == 5 and parts[3] == "logs" \
                    and parts[4] == "stream":
                return self._stream_logs(parts[2])
            if len(parts) == 4 and parts[3] == "metrics":
                if follow:
                    return self._follow_metrics(
                        parts[2],
                        max_s=min(float(query.get("max_s", 5.0)), 60.0))
                body = self.core.training_metrics(parts[2]).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if len(parts) == 4 and parts[3] == "model":
                data = self.core.download_model(parts[2])
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if parts == ["v1", "cluster"]:
                return self._json(self.core.cluster_status())
            if parts == ["v1", "queue"]:
                return self._json(self.core.queue_status())
            if parts == ["v1", "tenants"]:
                return self._json(self.core.tenant_usage())
            if parts == ["v1", "usage"]:
                return self._json(self.core.usage)
            if parts == ["v1", "recovery"]:
                return self._json(self.core.recovery_report())
            if parts == ["v1", "alerts"]:
                if follow:
                    return self._follow_alerts(
                        max_s=min(float(query.get("max_s", 5.0)), 60.0))
                return self._json(self.core.alerts())
            if parts == ["v1", "slo"]:
                return self._json(self.core.slo_status())
            return self._err(404, f"no route GET {self.path}")
        except KeyError as e:
            return self._err(404, str(e))
        except Exception as e:
            return self._err(500, f"{type(e).__name__}: {e}")

    def do_DELETE(self):
        parts, _ = self._route()
        try:
            if len(parts) == 3 and parts[1] == "models":
                if parts[2] in self.core.endpoints:
                    # serving endpoint: drain (finish in-flight), then
                    # the LCM decommissions the server task
                    return self._json(self.core.stop_endpoint(parts[2]))
                self.core.delete_model(parts[2])
                return self._json({"deleted": parts[2]})
            if len(parts) == 3 and parts[1] == "trainings":
                self.core.terminate_training(parts[2])
                return self._json({"terminated": parts[2]})
            return self._err(404, f"no route DELETE {self.path}")
        except KeyError as e:
            return self._err(404, str(e))

    # ---- live streaming (chunked; websocket analogue) ----------------------
    def _start_chunked(self, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, data: bytes):
        if not data:
            return
        self.wfile.write(f"{len(data):X}\r\n".encode())
        self.wfile.write(data + b"\r\n")
        self.wfile.flush()

    def _end_chunked(self):
        # final zero-length chunk per RFC
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _terminal(self, job_id: str) -> bool:
        return self.core.lcm.job_state(job_id) in ("COMPLETED",
                                                   "FAILED", "KILLED")

    def _stream_logs(self, job_id: str, max_s: float = 5.0):
        """Legacy znode-log polling stream (logs/stream route)."""
        self._start_chunked("text/plain")
        sent = 0
        t0 = time.time()
        while time.time() - t0 < max_s:
            logs = self.core.training_logs(job_id)
            for line in logs[sent:]:
                self._chunk((line + "\n").encode())
            sent = len(logs)
            if self._terminal(job_id):
                break
            time.sleep(0.05)
        self._end_chunked()

    def _follow_logs(self, job_id: str, max_s: float = 5.0):
        """``logs?follow=1``: replay the structured tail, then stream
        live records off the job's log-hub tap as NDJSON. Tail and live
        stream are deduped by the per-job ``seq``."""
        try:
            tail, stream = self.core.log_stream(job_id)
        except KeyError:
            return self._err(404, f"no such job: {job_id!r}")
        self._start_chunked("application/x-ndjson")
        last_seq = 0
        try:
            for rec in tail:
                self._chunk((json.dumps(rec) + "\n").encode())
                last_seq = rec.get("seq", 0)
            t0 = time.time()
            while time.time() - t0 < max_s:
                rec = stream.get(timeout=0.2)
                if rec is None:
                    if stream.closed or self._terminal(job_id):
                        break
                    continue
                if rec.get("seq", 0) <= last_seq:
                    continue        # already replayed from the tail
                self._chunk((json.dumps(rec) + "\n").encode())
        finally:
            self.core.loghub.unsubscribe(job_id, stream)
        self._end_chunked()

    def _follow_alerts(self, max_s: float = 5.0):
        """``/v1/alerts?follow=1``: one snapshot line (active alerts +
        remediation log so far), then live alert/remediation records as
        NDJSON. Platform-wide — bounded only by ``max_s``."""
        stream = self.core.alert_stream()
        self._start_chunked("application/x-ndjson")
        try:
            snap = {"type": "snapshot", **self.core.alerts()}
            self._chunk((json.dumps(snap) + "\n").encode())
            t0 = time.time()
            while time.time() - t0 < max_s:
                rec = stream.get(timeout=0.2)
                if rec is None:
                    if stream.closed:
                        break
                    continue
                self._chunk((json.dumps(rec) + "\n").encode())
        finally:
            self.core.health.alerts.unsubscribe(stream)
        self._end_chunked()

    def _follow_metrics(self, job_id: str, max_s: float = 5.0):
        """``metrics?follow=1``: one snapshot line (the series so far),
        then live metric/event records as NDJSON."""
        try:
            stream = self.core.metric_stream(job_id)
        except KeyError:
            return self._err(404, f"no such job: {job_id!r}")
        self._start_chunked("application/x-ndjson")
        try:
            snap = {"type": "snapshot",
                    "metrics": json.loads(
                        self.core.training_metrics(job_id))}
            self._chunk((json.dumps(snap) + "\n").encode())
            t0 = time.time()
            while time.time() - t0 < max_s:
                rec = stream.get(timeout=0.2)
                if rec is None:
                    if stream.closed or self._terminal(job_id):
                        break
                    continue
                self._chunk((json.dumps(rec) + "\n").encode())
        finally:
            self.core.metrics.unsubscribe_stream(job_id, stream)
        self._end_chunked()


class DLaaSServer:
    """Owns the HTTP server + core; context-manager friendly."""

    def __init__(self, workdir: str, port: int = 0, **core_kw):
        self.core = DLaaSCore(workdir, **core_kw)
        handler = type("Handler", (_Handler,), {"core": self.core})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "DLaaSServer":
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.core.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def serve(workdir: str, port: int = 8080,
          device: Optional[str] = None):  # pragma: no cover
    srv = DLaaSServer(workdir, port, device=device).start()
    sys.stdout.write(f"DLaaS listening on {srv.url}\n")
    sys.stdout.flush()
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":  # pragma: no cover
    serve(sys.argv[1] if len(sys.argv) > 1 else "/tmp/dlaas",
          int(sys.argv[2]) if len(sys.argv) > 2 else 8080,
          sys.argv[3] if len(sys.argv) > 3 else None)
