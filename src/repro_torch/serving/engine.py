"""Continuous-batching inference runtime — the serving data plane of the
port, mirroring ``repro.serving.engine``'s public behaviour:

  * **slot-based cache** — one batched cache of ``capacity`` slots (K/V
    for the dense family, the SSD state and conv tail for the ssm
    family, both for the hybrid), each slot with its own write position
    (``pos`` is a
    (capacity,) vector), so slots at different depths decode in one
    call;
  * **continuous batching** — finished sequences retire at once and
    queued requests are prefilled into the freed slots mid-flight
    (equal-length queue neighbours prefill together as one batch);
  * **bounded admission queue** — ``submit`` raises ``QueueFull`` when
    the queue is full, and every request may carry a deadline, enforced
    while queued and while decoding.

Where the JAX engine differs in mechanism:
  * decode is one batched ``model.decode`` over the slot dimension with a
    per-slot position vector; it replaces ``jit(vmap(decode_one))``;
  * prefill writes each request's cache rows straight into its slot of
    the batched cache; it replaces ``_pad_prefill`` + ``_splice``;
  * weights and cache live on an explicit ``device`` (CUDA unless the
    caller passes ``device="cpu"``), and ``seed`` drives a
    ``torch.Generator`` on that device.
Greedy (argmax) sampling keeps the engine deterministic. ``perf`` is
the decode step's roofline estimate (``status.perf``, unit
``decode_step``): ``start`` counts one batched ``model.decode`` of
``capacity`` slots over the slot cache on the meta device
(``analysis/roofline.py:count_program``) on a background thread, where
the JAX engine analyses the decode jit's compiled HLO.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.perf import JobPerf
from repro_torch.analysis.roofline import count_program
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.errors import UserError
from repro_torch.models import make_model
from repro_torch.models.layers import map_leaves
from repro_torch.observability.trace import TRACE_STEP_SAMPLE, maybe_span
from repro_torch.weights import flat_size, params_from_flat

log = logging.getLogger("repro_torch.serving")
job_log = logging.getLogger("repro_torch.job")

# request states
R_QUEUED, R_RUNNING, R_DONE, R_REJECTED, R_EXPIRED, R_FAILED = (
    "QUEUED", "RUNNING", "DONE", "REJECTED", "EXPIRED", "FAILED")


class QueueFull(Exception):
    """Admission queue at capacity (HTTP 429)."""


class EndpointClosed(Exception):
    """Endpoint draining/stopped: no new requests accepted (HTTP 409)."""


class DeadlineExceeded(Exception):
    """Request deadline elapsed before completion (HTTP 504)."""


@dataclass
class InferenceRequest:
    req_id: str
    prompt: np.ndarray                      # (P,) int32
    max_new: int
    deadline: Optional[float]               # absolute wall-clock, or None
    submitted: float = field(default_factory=time.time)
    status: str = R_QUEUED
    tokens: List[int] = field(default_factory=list)
    error: str = ""
    done: threading.Event = field(default_factory=threading.Event)
    finished_ts: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class InferenceEngine:
    """Continuous-batching greedy decoder over a slot-based cache.

    Thread model: ``submit``/``stats``/``drain`` are safe from any
    thread; ``start`` + ``run`` belong to the single server thread.
    ``run`` honours the same step-boundary contract as the JAX engine:
    preemption via ``wd.maybe_preempt``, pause via
    ``control.wait_while_paused``; an aborted run re-queues its in-flight
    requests so the next one resumes them.

    Beside ``stats()`` (the JAX engine's keys) the engine keeps
    ``prefill_batches``, ``prefill_seconds`` and ``decode_seconds``: host
    time around each prefill batch and decode step, each ending in the
    device-to-host copy of its sampled tokens, so on the card it covers
    the device work too.
    """

    def __init__(self, cfg: ArchConfig, *, capacity: int = 2,
                 max_seq: int = 64, max_queue: int = 16,
                 default_max_new: int = 16, eos_id: Optional[int] = None,
                 seed: int = 0, metrics=None, endpoint_id: str = "endpoint",
                 tracer=None, device: DeviceLike = None):
        if cfg.family == "encdec":
            raise UserError(
                "serving supports decoder-family archs only (dense/moe/"
                f"ssm/hybrid/vlm); {cfg.arch_id!r} is encoder-decoder")
        if capacity < 1 or max_queue < 1 or max_seq < 2:
            raise UserError("capacity/max_queue must be >= 1, max_seq >= 2")
        self.cfg = cfg
        # UserError for a family not ported; no remat, as the reference's
        # ENGINE_OPTS
        self.model = make_model(cfg, opts={"remat": "none"})
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.max_seq = int(max_seq)
        self.max_queue = int(max_queue)
        self.default_max_new = int(default_max_new)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.metrics = metrics
        self.endpoint_id = endpoint_id
        self.tracer = tracer
        self._req_spans: Dict[str, object] = {}  # req_id -> open span

        self._lock = threading.RLock()
        self._queue: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._ready = threading.Event()
        self._draining = False
        self._released = False
        self._slots: List[Optional[InferenceRequest]] = \
            [None] * self.capacity
        self._next_tok = np.zeros(self.capacity, np.int64)
        self._cache = None
        # SLO remediation knobs: a shed limit tightens admission below
        # max_queue; pended slots grow capacity at the NEXT start() (the
        # slot cache is shaped by capacity)
        self._shed_limit: Optional[int] = None
        self._pending_slots = 0
        self.params = None
        # accounting (guarded by _lock; mirrored into metrics). Latencies
        # are a rolling window: endpoints are long-lived.
        self._counts = collections.Counter()
        self._latencies: collections.deque = collections.deque(
            maxlen=4096)
        self._decode_steps = 0
        self._occupied_slot_steps = 0
        self._first_decode_t: Optional[float] = None
        self._last_decode_t: Optional[float] = None
        self.prefill_batches = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        # roofline estimate of the decode step (status.perf), counted in
        # the background once the weights are built
        self.perf = JobPerf(endpoint_id or "endpoint", metrics,
                            unit="decode_step")

    @property
    def flat_size(self) -> int:
        """Length of the flat f32 weight vector (the training wire /
        results-store layout) this engine's arch expects."""
        return flat_size(self.cfg)

    # ---- lifecycle --------------------------------------------------------
    def start(self, flat_params: Optional[np.ndarray] = None):
        """Load weights and build the slot cache; flips the engine READY.
        ``flat_params`` is the flat f32 vector a training uploaded (None:
        fresh init from ``seed`` on the engine's device)."""
        with self._lock:
            if self._pending_slots:
                self.capacity += self._pending_slots
                self._pending_slots = 0
                self._slots = [None] * self.capacity
                self._next_tok = np.zeros(self.capacity, np.int64)
            # drop the previous incarnation's buffers before allocating
            self._cache = None
            self.params = None
        if flat_params is not None:
            flat_params = np.asarray(flat_params, np.float32).reshape(-1)
            if flat_params.size != self.flat_size:
                raise UserError(
                    f"weights size {flat_params.size} does not match "
                    f"arch {self.cfg.arch_id!r} ({self.flat_size} params)")
            params = params_from_flat(flat_params, self.cfg, self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            params = self.model.init(gen)
        cache = self.model.empty_cache(self.capacity, self.max_seq,
                                       self.device)
        with self._lock:
            self.params = params
            self._cache = cache
            self._released = False
            self._ready.set()
        self.perf.start_async(self._decode_cost(params))

    def _decode_cost(self, params):
        """A callable that counts one batched decode step of
        ``capacity`` slots over a ``max_seq`` slot cache on the meta
        device. The weights' shapes are snapshot now (the live ones are
        dropped at release); nothing touches the card."""
        meta = map_leaves(lambda _, t: torch.empty_like(t, device="meta"),
                          params)
        capacity, max_seq = self.capacity, self.max_seq

        def cost():
            cache = self.model.empty_cache(capacity, max_seq, "meta")
            toks = torch.zeros((capacity, 1), dtype=torch.int64,
                               device="meta")
            with torch.no_grad():
                return count_program(self.model.decode, meta, cache,
                                     {"tokens": toks})
        return cost

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def released(self) -> bool:
        return self._released

    def drain(self):
        """Stop accepting requests; ``run`` exits once in-flight and
        already-queued work finishes."""
        with self._lock:
            self._draining = True
        self._wake.set()

    def release(self):
        """Teardown: free the weights and slot cache and fail any
        still-queued requests closed."""
        with self._lock:
            self._draining = True
            self._released = True
            pending = list(self._queue)
            self._queue.clear()
            self._cache = None
            self.params = None
            self._ready.clear()
        now = time.time()
        for r in pending:
            self._settle(r, R_FAILED, now, error="endpoint stopped")
        self._wake.set()

    # ---- admission --------------------------------------------------------
    def submit(self, prompt, max_new: Optional[int] = None,
               deadline_s: Optional[float] = None) -> InferenceRequest:
        """Admit one request (any thread). Raises ``QueueFull`` when the
        bounded queue is at capacity, ``EndpointClosed`` when draining,
        ``UserError`` on malformed input."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        max_new = int(max_new if max_new is not None
                      else self.default_max_new)
        if prompt.size == 0 or max_new < 1:
            raise UserError("prompt must be non-empty and max_new >= 1")
        if prompt.size + max_new > self.max_seq:
            raise UserError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"the endpoint's max_seq ({self.max_seq})")
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab_size:
            raise UserError(
                f"token ids must be in [0, {self.cfg.vocab_size})")
        req = InferenceRequest(
            req_id=f"req-{uuid.uuid4().hex[:8]}", prompt=prompt,
            max_new=max_new,
            deadline=(time.time() + float(deadline_s)
                      if deadline_s is not None else None))
        with self._lock:
            if self._draining or self._released:
                raise EndpointClosed(
                    f"endpoint {self.endpoint_id} is not accepting "
                    f"requests")
            self._incr("requests_total")
            limit = (self._shed_limit if self._shed_limit is not None
                     else self.max_queue)
            if len(self._queue) >= limit:
                req.status = R_REJECTED
                req.done.set()
                self._incr("rejected_total")
                raise QueueFull(
                    f"admission queue full ({limit} waiting"
                    + (", load shed" if self._shed_limit is not None
                       else "") + ")")
            self._queue.append(req)
            depth = len(self._queue)
            if self.tracer is not None:
                self._req_spans[req.req_id] = self.tracer.start(
                    self.endpoint_id, "request", req_id=req.req_id,
                    plen=int(prompt.size), max_new=max_new)
        self._gauge("queue_depth", depth)
        self._wake.set()
        return req

    # ---- serve loop -------------------------------------------------------
    def run(self, *, wd=None, control=None):
        """Serve until drained. ``wd`` adds preemption checks and
        heartbeats; ``control`` adds the pause gate; both are observed at
        batch-step boundaries. On abort, in-flight requests re-queue."""
        should_abort = wd.maybe_preempt if wd is not None else None
        served = 0
        try:
            while True:
                if wd is not None:
                    wd.maybe_preempt()
                if control is not None:
                    control.wait_while_paused(should_abort=should_abort)
                self._expire_queued()
                self._admit()
                with self._lock:
                    live = sum(1 for r in self._slots if r is not None)
                    idle_exit = (self._draining and live == 0
                                 and not self._queue)
                if idle_exit:
                    break
                if live:
                    served += self._decode_once()
                    if wd is not None and self._decode_steps % 32 == 0:
                        wd.heartbeat(self._decode_steps, served=served)
                elif self._wake.wait(timeout=0.02):
                    self._wake.clear()
        except BaseException:
            # put in-flight work back at the head of the queue, oldest
            # frontmost, so the next run resumes it in FIFO order
            with self._lock:
                inflight = [r for r in self._slots if r is not None]
                self._slots = [None] * self.capacity
                for r in sorted(inflight, key=lambda r: r.submitted,
                                reverse=True):
                    r.tokens = []
                    r.status = R_QUEUED
                    self._queue.appendleft(r)
                self._ready.clear()
            raise

    # ---- internals --------------------------------------------------------
    def _admit(self):
        """Prefill queued requests into free slots. Equal-length queue
        neighbours are prefilled together as one batch, each row's cache
        written straight into its slot."""
        while True:
            with self._lock:
                if not self._queue or self._cache is None:
                    return
                free = [s for s in range(self.capacity)
                        if self._slots[s] is None]
                if not free:
                    return
                batch = [self._queue.popleft()]
                plen = batch[0].prompt.size
                while (len(batch) < len(free) and self._queue
                       and self._queue[0].prompt.size == plen):
                    batch.append(self._queue.popleft())
                depth = len(self._queue)
                params, cache = self.params, self._cache
            self._gauge("queue_depth", depth)
            slots = free[:len(batch)]
            t0 = time.perf_counter()
            with maybe_span(self.tracer, self.endpoint_id, "prefill",
                             n=len(batch), plen=int(plen)), \
                    torch.no_grad():
                toks = torch.from_numpy(
                    np.stack([r.prompt for r in batch]).astype(np.int64)
                ).to(self.device)
                logits, _ = self.model.prefill(
                    params, {"tokens": toks}, cache=cache,
                    slots=torch.tensor(slots, device=self.device))
                first = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
            dt = time.perf_counter() - t0
            now = time.time()
            with self._lock:
                self.prefill_batches += 1
                self.prefill_seconds += dt
                for req, slot, tok in zip(batch, slots, first):
                    req.status = R_RUNNING
                    req.tokens.append(int(tok))
                    self._slots[slot] = req
                    self._next_tok[slot] = tok
                    self._maybe_retire(slot, req, now)

    def _decode_once(self) -> int:
        t0 = time.perf_counter()
        with torch.no_grad():
            toks = torch.from_numpy(
                self._next_tok.reshape(self.capacity, 1)).to(self.device)
            logits, self._cache = self.model.decode(self.params,
                                                    self._cache,
                                                    {"tokens": toks})
            nxt = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0
        now = time.time()
        live = 0
        with self._lock:
            self.decode_seconds += dt
            for s in range(self.capacity):
                r = self._slots[s]
                if r is None:
                    continue
                live += 1
                r.tokens.append(int(nxt[s]))
                self._next_tok[s] = nxt[s]
                self._maybe_retire(s, r, now)
            self._decode_steps += 1
            self._occupied_slot_steps += live
            if self._first_decode_t is None:
                self._first_decode_t = now
            self._last_decode_t = now
        self._gauge("batch_occupancy", live / self.capacity,
                    step=self._decode_steps)
        if (self.tracer is not None
                and self._decode_steps % TRACE_STEP_SAMPLE == 0):
            self.tracer.event(self.endpoint_id, "decode",
                              step=self._decode_steps, live=live)
        return live

    def _maybe_retire(self, slot: int, req: InferenceRequest, now: float):
        """Retire a finished/expired slot (caller holds the lock)."""
        finished = (len(req.tokens) >= req.max_new
                    or (self.eos_id is not None
                        and req.tokens[-1] == self.eos_id))
        if finished:
            self._slots[slot] = None
            self._settle(req, R_DONE, now)
        elif req.deadline is not None and now > req.deadline:
            self._slots[slot] = None
            self._settle(req, R_EXPIRED, now)

    def _expire_queued(self):
        now = time.time()
        expired = []
        with self._lock:
            if any(r.deadline is not None and now > r.deadline
                   for r in self._queue):
                keep = collections.deque()
                while self._queue:
                    r = self._queue.popleft()
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    else:
                        keep.append(r)
                self._queue = keep
        for r in expired:
            self._settle(r, R_EXPIRED, now)

    def _settle(self, req: InferenceRequest, status: str, now: float,
                error: str = ""):
        """Final bookkeeping for one request (any terminal status)."""
        with self._lock:
            req.status = status
            req.finished_ts = now
            req.error = error
            lat = now - req.submitted
            if status == R_DONE:
                self._latencies.append(lat)
                self._incr("completed_total")
                self._incr("tokens_out_total", len(req.tokens))
                if self.metrics is not None:
                    self.metrics.record_bounded(
                        self.endpoint_id, "latency_s",
                        self._decode_steps, lat)
            elif status == R_EXPIRED:
                self._incr("expired_total")
            elif status == R_FAILED:
                self._incr("failed_total")
            span = self._req_spans.pop(req.req_id, None)
        if span is not None:
            self.tracer.end(span,
                            status=("ok" if status == R_DONE
                                    else "error"),
                            result=status, tokens=len(req.tokens))
        job_log.debug("request %s %s tokens=%d latency=%.4fs",
                      req.req_id, status, len(req.tokens), lat,
                      extra={"job_id": self.endpoint_id})
        req.done.set()

    def _incr(self, counter: str, value: float = 1.0):
        self._counts[counter] += value
        if self.metrics is not None:
            try:
                self.metrics.incr(self.endpoint_id, counter, value)
            except Exception as e:           # accounting must not kill serving
                log.warning("metrics incr failed: %s", e)

    def _gauge(self, metric: str, value: float,
               step: Optional[int] = None):
        if self.metrics is not None:
            try:
                self.metrics.record_bounded(
                    self.endpoint_id, metric,
                    step if step is not None else self._decode_steps,
                    value)
            except Exception as e:
                log.warning("metrics record failed: %s", e)

    # ---- SLO remediation hooks --------------------------------------------
    def shed(self, frac: float = 0.5):
        """Tighten admission to ``frac`` of max_queue (min 1) until
        ``unshed``."""
        with self._lock:
            self._shed_limit = max(1, int(self.max_queue * frac))
        log.warning("endpoint %s shedding load: admission limit %d "
                    "(of %d)", self.endpoint_id, self._shed_limit,
                    self.max_queue)

    def unshed(self):
        with self._lock:
            was, self._shed_limit = self._shed_limit, None
        if was is not None:
            log.info("endpoint %s shed lifted (limit %d -> %d)",
                     self.endpoint_id, was, self.max_queue)

    def add_slot(self, n: int = 1):
        """Pend ``n`` extra decode slots; applied at the next ``start()``."""
        with self._lock:
            self._pending_slots += max(0, int(n))
        log.warning("endpoint %s pending +%d decode slot(s) (capacity "
                    "%d -> %d at next start)", self.endpoint_id, n,
                    self.capacity, self.capacity + self._pending_slots)

    # ---- observability ----------------------------------------------------
    def decode_rate(self) -> Optional[float]:
        """Measured decode steps/s over the serve so far."""
        with self._lock:
            steps = self._decode_steps
            t0, t1 = self._first_decode_t, self._last_decode_t
        if steps >= 2 and t0 is not None and t1 is not None and t1 > t0:
            return (steps - 1) / (t1 - t0)
        return None

    def stats(self) -> Dict:
        """Counters + latency percentiles + occupancy (the JAX engine's
        keys)."""
        with self._lock:
            lat = sorted(self._latencies)
            steps = self._decode_steps
            occ = self._occupied_slot_steps
            out = {
                "requests_total": int(self._counts["requests_total"]),
                "completed_total": int(self._counts["completed_total"]),
                "rejected_total": int(self._counts["rejected_total"]),
                "expired_total": int(self._counts["expired_total"]),
                "failed_total": int(self._counts["failed_total"]),
                "tokens_out_total": int(self._counts["tokens_out_total"]),
                "queue_depth": len(self._queue),
                "active": sum(1 for r in self._slots if r is not None),
                "capacity": self.capacity,
                "max_queue": self.max_queue,
                "shed_limit": self._shed_limit,
                "pending_slots": self._pending_slots,
                "decode_steps": steps,
                "occupied_slot_steps": occ,
                "mean_batch_occupancy": round(
                    occ / (steps * self.capacity), 4) if steps else 0.0,
            }
        if self.metrics is not None:
            p50 = self.metrics.percentile(self.endpoint_id, "latency_s", 50)
            p99 = self.metrics.percentile(self.endpoint_id, "latency_s", 99)
        else:
            p50 = p99 = None
        if p50 is None and lat:               # metrics absent or dropped
            # same nearest-rank formula as MetricsService.percentile
            p50 = lat[max(0, int(np.ceil(0.50 * len(lat))) - 1)]
            p99 = lat[max(0, int(np.ceil(0.99 * len(lat))) - 1)]
        out["p50_latency_s"] = round(p50, 4) if p50 is not None else None
        out["p99_latency_s"] = round(p99, 4) if p99 is not None else None
        return out
