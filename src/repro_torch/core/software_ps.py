"""Software parameter server (paper §Parameter Server) with its state on
the device: the counterpart of ``repro/core/software_ps.py``, with the
same public behaviour (``join``/``leave``/``active``, ``push`` with the
``bsp`` and ``on_arrival`` triggers and the timeout withdraw, ``pull``,
``slow_learner``, ``load_flat``, ``stats()`` with the same keys, and
``PSClient``).

As in the reference, a group of shards stores and aggregates the flat
model, partitioned evenly by shard ID (``ShardLayout``, copied), and each
learner owns a row of a preallocated ``(n_learners, padded)`` receive
buffer that its push writes outside any lock. What differs, by design:

  * **Device-resident state.** ``_params``, ``_m``, ``_v`` and the
    receive rows are tensors on ``device`` (CUDA unless the caller asks
    for the CPU). A push from a learner on the same card never leaves it.
  * **K3 on receive.** A ``CompressedPush`` is dequantized straight into
    the learner's receive row by ``kernels.ops.dequantize`` (the K3
    kernel on CUDA); a dense push is ``copy_``-ed in. The pad tail of
    every row stays zero.
  * **K1 per shard.** A round runs ``kernels.ops.ps_aggregate`` (the K1
    kernel on CUDA) once per shard, on the shard's column slice of the
    receive rows, read through the row stride: the per-shard contiguous
    copy of the reference (``np.ascontiguousarray``, software_ps.py:209)
    is gone. The reference's thread pool for large models is gone too:
    launches are asynchronous, so one thread enqueues every shard's
    update back to back.
  * **One stream.** Learner threads and the PS issue on the device's
    current stream, so device order follows the host order that the
    PS's locks impose (a pull is enqueued after the round's K1 launches
    it waits for).
  * **Pull** copies into a per-learner device buffer, reused by that
    learner's next pull.
  * ``PSClient`` keeps its error-feedback (and, when the pushed vector
    is shorter than the padded layout, staging) buffers on the device
    and quantizes through K2; on a timeout it puts the signal back with
    K3 and an add.
  * ``start()`` is a start barrier the reference lacks: the learner
    body calls it before its first pull, so under the ``bsp`` trigger
    round 0 counts every learner of the job and not only those that
    have joined so far. A slot that never starts (a group placed with
    fewer learners than slots) holds the others back by at most
    ``BSP_TIMEOUT_S``, the wait a BSP push gives a straggler.
  * ``release()`` frees all of that device state once a job has ended:
    the job's plan, learner body and scheduler apps keep referencing the
    server and its clients, and at full width it holds tens of GiB.
    ``stats()`` then answers from a snapshot taken at release; ``push``,
    ``pull`` and ``load_flat`` raise ``RuntimeError``. The reference has
    no such method: its ``training_status`` drops the server from the
    plan when a terminal job is polled.

Solver math is that of ``kernels/ref.py:ps_aggregate_ref`` (K1's plain
version), which CPU tensors take.
"""
from __future__ import annotations

import logging
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.compression import (CompressedPush, make_compressor,
                                          pad_to_block)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

log = logging.getLogger("repro_torch.ps")

# seconds a BSP push waits for the round's other learners before it
# withdraws its contribution, and the start barrier for the job's other
# learners before the first pull goes on without them
BSP_TIMEOUT_S = 30.0

# PS-side solver name -> fused-kernel solver name (kernels/ref.py /
# kernels/ps_aggregate.py). 'easgd' pushes carry beta * (x_i - center)
# already, so the center rule applies the mean with beta = 1.
_FUSED_SOLVER = {"sgd": "sgd", "momentum": "momentum", "adam": "adam",
                 "average": "average", "easgd": "easgd_center"}


@dataclass(frozen=True)
class ShardLayout:
    """Even partition of the flat model by shard ID, fixed at server
    construction (every learner follows the same scheme). ``shard_len``
    is rounded up to the compression block so a compressed push splits
    into per-shard views without re-blocking."""
    size: int               # true (unpadded) model size
    n_shards: int
    shard_len: int          # multiple of compression BLOCK
    padded: int             # n_shards * shard_len

    @classmethod
    def build(cls, size: int, n_shards: int) -> "ShardLayout":
        per = max(1, -(-size // n_shards))
        shard_len = pad_to_block(per)
        return cls(size=size, n_shards=n_shards, shard_len=shard_len,
                   padded=shard_len * n_shards)

    def shard_slice(self, s: int) -> slice:
        return slice(s * self.shard_len, (s + 1) * self.shard_len)

    def valid_len(self, s: int) -> int:
        """Elements of shard ``s`` that map to real (unpadded) model."""
        return max(0, min(self.shard_len, self.size - s * self.shard_len))


def as_flat(x, device: torch.device) -> torch.Tensor:
    """A 1-D f32 or bf16 tensor on ``device`` from a numpy array or a
    tensor (no copy when it already is one)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return x.detach().reshape(-1).to(device)


class SoftwareParameterServer:
    def __init__(self, init_flat, *, n_shards: int = 4,
                 n_learners: int = 1, optimizer: str = "sgd",
                 lr: float = 0.1, trigger: str = "bsp",
                 compression: str = "none",
                 momentum: float = 0.9, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, metrics=None, job_id: str = None,
                 device: DeviceLike = None):
        if trigger not in ("bsp", "on_arrival"):
            raise ValueError(f"trigger {trigger!r}: bsp or on_arrival")
        if optimizer not in _FUSED_SOLVER:
            raise ValueError(optimizer)
        if compression not in ("none", "int8"):
            raise ValueError(f"compression {compression!r}: none or int8")
        self.device = resolve_device(device)
        self.n_learners = n_learners
        self.trigger = trigger
        self.optimizer = optimizer
        self.lr = lr
        self.compression = compression
        self.momentum, self.b1, self.b2, self.eps = momentum, b1, b2, eps
        self.metrics, self.job_id = metrics, job_id
        self._agg_kw = dict(solver=_FUSED_SOLVER[optimizer], lr=lr, b1=b1,
                            b2=b2, eps=eps, momentum=momentum, beta=1.0)

        init = as_flat(init_flat, self.device)
        self.size = init.numel()
        self.layout = ShardLayout.build(self.size, n_shards)
        lay = self.layout
        f32 = dict(dtype=torch.float32, device=self.device)
        # global state: one contiguous block per quantity; shard s owns
        # the contiguous view [s*shard_len, (s+1)*shard_len)
        self._params = torch.zeros(lay.padded, **f32)
        self._params[: self.size] = init
        del init
        self._m = torch.zeros(lay.padded, **f32)
        self._v = torch.zeros(lay.padded, **f32)
        self._step = 0                      # solver step (adam bias corr.)
        self._step_lock = threading.Lock()
        self._shard_locks = [threading.Lock() for _ in range(n_shards)]
        # zero-copy receive: learner i owns row [i]; rows are written
        # outside the round lock so receives overlap across learners
        self._recv = torch.zeros((n_learners, lay.padded), **f32)

        self._members: set = set()
        # slots that have passed the start barrier (``start``) once
        self._started: set = set()
        self._lock = threading.Lock()
        self._bsp_cond = threading.Condition()
        self._bsp_round = 0
        self._arrived: List[int] = []
        self._round_t0: Optional[float] = None   # first arrival this round
        # fault injection: slot -> [sleep_seconds, rounds_left] (0 =
        # until cleared); a restarted learner rejoins clean via leave()
        self._slow: Dict[int, List] = {}
        self._pull_bufs: Dict[int, torch.Tensor] = {}
        # data-plane counters — always mutated under _stats_lock (pushes
        # arrive concurrently; unsynchronized += drops increments)
        self._stats_lock = threading.Lock()
        self.push_count = 0
        self.pull_count = 0
        self.push_timeouts = 0
        self.bytes_pushed_wire = 0
        self.bytes_pushed_dense = 0
        self.bytes_pulled = 0
        self.agg_rounds = 0
        self.agg_time_s = 0.0
        # the clients made on this server (their buffers are freed by
        # release), and stats() frozen at release (None while live)
        self._clients = weakref.WeakSet()
        self._final_stats: Optional[Dict] = None

    # ---- fused aggregation ------------------------------------------------
    def _apply_slots(self, slots: List[int]):
        """One aggregation round over the registered receive rows: one
        fused mean+solver pass (K1) per shard, each under its shard lock
        (ascending, the order of pull/load_flat)."""
        with self._step_lock:
            self._step += 1
            step = self._step
        if len(slots) == self.n_learners:
            rows = self._recv
        elif len(slots) == 1:
            rows = self._recv[slots[0]: slots[0] + 1]   # view, not copy
        else:
            rows = self._recv[slots]    # partial round (member left)
        lay = self.layout
        on_card = self.device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for s in range(lay.n_shards):
            sl = lay.shard_slice(s)
            with self._shard_locks[s]:
                ops.ps_aggregate(rows[:, sl], self._params[sl],
                                 self._m[sl], self._v[sl], step,
                                 **self._agg_kw)
        if on_card:
            # agg time is device time: the launches are asynchronous, so
            # time them with events and wait for the last before reading
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
        with self._stats_lock:
            self.agg_rounds += 1
            self.agg_time_s += dt
            rounds = self.agg_rounds
        if self.metrics is not None and self.job_id is not None:
            self.metrics.record(self.job_id, "agg_time_ms", rounds,
                                dt * 1e3)

    # ---- connection management (paper: join/leave) ------------------------
    def join(self, learner_id: int):
        with self._lock:
            self._members.add(learner_id)

    def leave(self, learner_id: int):
        with self._lock:
            self._members.discard(learner_id)
            # a crashed learner must not deadlock a BSP barrier
        # restart cures an injected slowdown: the replacement
        # incarnation of this slot starts from a clean data plane
        with self._stats_lock:
            self._slow.pop(learner_id % self.n_learners, None)
        with self._bsp_cond:
            self._bsp_cond.notify_all()

    def start(self, learner_id: int) -> bool:
        """Start barrier of the ``bsp`` trigger: mark this learner's slot
        started and wait until every slot of the server has started
        once. A learner calls it after joining (and learner 0 after
        republishing a checkpoint) and before its first pull. Without it
        the BSP barrier counts only the members that have joined so far:
        a learner that starts late lets the first pusher finish round 0
        alone, then pulls those weights for its own step 0. Once every
        slot has started, a restarted learner passes at once; so does
        every learner under ``on_arrival``, which has no rounds. Returns
        False if the other slots did not start within ``BSP_TIMEOUT_S``;
        the caller then goes on with those that did."""
        with self._bsp_cond:
            self._started.add(learner_id % self.n_learners)
            self._bsp_cond.notify_all()
            if self.trigger != "bsp":
                return True
            return self._bsp_cond.wait_for(
                lambda: len(self._started) >= self.n_learners,
                timeout=BSP_TIMEOUT_S)

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._members)

    def _live(self):
        if self._final_stats is not None:
            raise RuntimeError(f"parameter server of job {self.job_id} was "
                               f"released")

    def make_client(self, learner_id: int) -> "PSClient":
        """Learner-side endpoint carrying the per-learner staging and
        error-feedback state for this server's compression setting."""
        return PSClient(self, learner_id, compression=self.compression)

    # ---- receive side -----------------------------------------------------
    def _receive(self, slot: int, payload: Union[torch.Tensor, np.ndarray,
                                                 CompressedPush]):
        """Land a push in the learner's receive row (no lock: the row is
        owned by the pushing learner). Compressed pushes dequantize
        straight into the row (K3) — the dense vector is never
        materialized anywhere else."""
        lay = self.layout
        row = self._recv[slot]
        if isinstance(payload, CompressedPush):
            ops.dequantize(payload.q, payload.scales, out=row)
            return payload.wire_nbytes, payload.dense_nbytes
        flat = as_flat(payload, self.device)
        if flat.numel() not in (self.size, lay.padded):
            raise ValueError(f"push of {flat.numel()} values; the model "
                             f"has {self.size} ({lay.padded} padded)")
        row[: flat.numel()].copy_(flat)
        # pad tail stays zero from construction
        nbytes = flat.numel() * 4
        return nbytes, nbytes

    # ---- push / pull ------------------------------------------------------
    def push(self, learner_id: int, payload,
             timeout: float = BSP_TIMEOUT_S) -> bool:
        """Send locally accumulated gradients (or weights, per solver) —
        a dense f32 vector or a ``CompressedPush`` (int8 + scales).
        Returns False iff a BSP push timed out and its contribution was
        withdrawn (never aggregated) — callers with error-feedback state
        must put the signal back."""
        self._live()
        slot = learner_id % self.n_learners
        # injected slowdown (fault drills): sleep outside every lock so
        # a slow slot delays only itself — exactly like a degraded host
        sleep_s = 0.0
        with self._stats_lock:
            ent = self._slow.get(slot)
            if ent is not None:
                sleep_s = ent[0]
                if ent[1] > 0:
                    ent[1] -= 1
                    if ent[1] == 0:
                        del self._slow[slot]
        if sleep_s > 0:
            time.sleep(sleep_s)
        wire, dense = self._receive(slot, payload)
        with self._stats_lock:
            self.push_count += 1
            self.bytes_pushed_wire += wire
            self.bytes_pushed_dense += dense
        if self.metrics is not None and self.job_id is not None:
            self.metrics.incr(self.job_id, "ps_bytes_wire", wire)
            self.metrics.incr(self.job_id, "ps_bytes_dense", dense)
        if self.trigger == "on_arrival":          # Downpour
            self._apply_slots([slot])
            return True
        # BSP: wait until all ACTIVE learners contributed, then aggregate
        with self._bsp_cond:
            my_round = self._bsp_round
            if slot not in self._arrived:     # re-push after a timeout
                # PS-side straggler signal: arrival time relative to the
                # round's FIRST arrival
                now_pc = time.perf_counter()
                if not self._arrived:
                    self._round_t0 = now_pc
                lag = now_pc - (self._round_t0 or now_pc)
                self._arrived.append(slot)    # replaces the row in place
                if self.metrics is not None and self.job_id is not None:
                    self.metrics.record_bounded(
                        self.job_id, f"ps_lag_s.{slot}",
                        self._bsp_round, lag, keep=256)
            if len(self._arrived) >= max(1, self.active):
                self._finish_round_locked()
            else:
                self._bsp_cond.wait_for(
                    lambda: self._bsp_round != my_round
                    or len(self._arrived) >= max(1, self.active),
                    timeout=timeout)
                # if members left, a later pusher completes the round
                if self._bsp_round == my_round and \
                        len(self._arrived) >= max(1, self.active):
                    self._finish_round_locked()
                elif self._bsp_round == my_round \
                        and slot in self._arrived:
                    # timed out with the round still open: withdraw our
                    # row so a later re-push cannot double-register it.
                    # The contribution is LOST — count and report it.
                    self._arrived.remove(slot)
                    with self._stats_lock:
                        self.push_timeouts += 1
                    log.warning(
                        "BSP push from learner %s timed out after %ss; "
                        "contribution withdrawn", learner_id, timeout,
                        extra={"job_id": self.job_id or "-"})
                    if self.metrics is not None and \
                            self.job_id is not None:
                        self.metrics.incr(self.job_id,
                                          "ps_push_timeouts")
                    return False
        return True

    def _finish_round_locked(self):
        """Aggregate the arrived rows and release the barrier. Caller
        holds ``_bsp_cond``."""
        slots, self._arrived = self._arrived, []
        self._apply_slots(sorted(slots))
        self._bsp_round += 1
        self._bsp_cond.notify_all()

    def pull(self, learner_id: int) -> torch.Tensor:
        """Fetch global weights into this learner's device pull buffer
        (one copy, shard-consistent). The buffer is reused by the
        learner's next pull — consume (or copy) before pulling again."""
        self._live()
        buf = self._pull_bufs.get(learner_id)
        if buf is None:
            buf = self._pull_bufs.setdefault(
                learner_id, torch.empty(self.size, dtype=torch.float32,
                                        device=self.device))
        lay = self.layout
        for s in range(lay.n_shards):
            k = lay.valid_len(s)
            if k == 0:
                break
            with self._shard_locks[s]:
                buf[s * lay.shard_len: s * lay.shard_len + k].copy_(
                    self._params[lay.shard_slice(s)][:k])
        with self._stats_lock:
            self.pull_count += 1
            self.bytes_pulled += buf.numel() * 4
        return buf

    # ---- fault injection ---------------------------------------------------
    def slow_learner(self, slot: int, seconds: float, rounds: int = 0):
        """Inject a per-push delay into one learner slot (the SLOW fault
        kind): every push from ``slot`` sleeps ``seconds`` first, for
        ``rounds`` pushes (0 = until the learner leaves)."""
        with self._stats_lock:
            self._slow[slot % self.n_learners] = [float(seconds),
                                                  int(rounds)]
        log.warning("injected slowdown: slot %d sleeps %.3fs per push "
                    "(%s rounds)", slot % self.n_learners, seconds,
                    rounds or "unbounded",
                    extra={"job_id": self.job_id or "-"})

    # ---- state management -------------------------------------------------
    def load_flat(self, flat):
        """Overwrite the global weights (checkpoint-restore republish)."""
        self._live()
        flat = as_flat(flat, self.device)
        if flat.numel() != self.size:
            raise ValueError(f"load_flat of {flat.numel()} values; the "
                             f"model has {self.size}")
        lay = self.layout
        for s in range(lay.n_shards):
            k = lay.valid_len(s)
            with self._shard_locks[s]:
                view = self._params[lay.shard_slice(s)]
                view[:k].copy_(flat[s * lay.shard_len:
                                    s * lay.shard_len + k])
                view[k:] = 0.0

    # ---- teardown ---------------------------------------------------------
    @property
    def released(self) -> bool:
        return self._final_stats is not None

    def release(self):
        """Free the device state of a job that has ended: params, optimizer
        moments, receive rows, pull buffers, and the error-feedback and
        staging buffers of every client made on this server. ``stats()``
        answers from a snapshot taken here; ``push``, ``pull`` and
        ``load_flat`` raise from now on. Idempotent. Call it only when no
        learner runs any more: a push in flight would lose its round."""
        if self._final_stats is not None:
            return
        snap = self.stats()
        # every shard lock, ascending as pull/load_flat take them, so no
        # aggregation or pull is half done when the tensors go
        for lock in self._shard_locks:
            lock.acquire()
        try:
            self._final_stats = snap
            self._params = self._m = self._v = self._recv = None
            self._pull_bufs = {}
        finally:
            for lock in reversed(self._shard_locks):
                lock.release()
        with self._lock:
            clients = list(self._clients)
        for client in clients:
            client.release()

    # ---- data-plane stats -------------------------------------------------
    @property
    def bytes_moved(self) -> int:
        with self._stats_lock:
            return self.bytes_pushed_wire + self.bytes_pulled

    def stats(self) -> Dict:
        """JSON-ready data-plane counters for status surfaces."""
        if self._final_stats is not None:
            return dict(self._final_stats)
        with self._stats_lock:
            wire, dense = self.bytes_pushed_wire, self.bytes_pushed_dense
            rounds, agg_s = self.agg_rounds, self.agg_time_s
            out = {
                "compression": self.compression,
                "ps_shards": self.layout.n_shards,
                "push_count": self.push_count,
                "pull_count": self.pull_count,
                "push_timeouts": self.push_timeouts,
                "bytes_pushed_wire": wire,
                "bytes_pushed_dense": dense,
                "bytes_pulled": self.bytes_pulled,
                "agg_rounds": rounds,
                "slow_slots": sorted(self._slow),
            }
        out["compression_ratio"] = round(dense / wire, 3) if wire else None
        out["agg_ms_per_round"] = (round(agg_s / rounds * 1e3, 3)
                                   if rounds else None)
        return out


class PSClient:
    """Per-learner push/pull endpoint: owns (under int8 compression) the
    device error-feedback buffer, so quantization is unbiased over time
    (Seide et al. style), and a padded staging buffer made at the first
    push shorter than the padded layout."""

    def __init__(self, ps: SoftwareParameterServer, learner_id: int,
                 compression: str = "none"):
        if compression not in ("none", "int8"):
            raise ValueError(f"compression {compression!r}: none or int8")
        self.ps = ps
        self.learner_id = learner_id
        self.compression = compression
        with ps._lock:
            ps._clients.add(self)
        if compression == "int8":
            self._stage: Optional[torch.Tensor] = None
            self._err = torch.zeros(ps.layout.padded, dtype=torch.float32,
                                    device=ps.device)
            self._compress = make_compressor()

    def release(self):
        """Free the error-feedback and staging buffers (the server's
        ``release`` calls this for each of its clients)."""
        self._err = self._stage = None

    def push(self, flat, timeout: float = BSP_TIMEOUT_S) -> bool:
        self.ps._live()
        if self.compression == "none":
            return self.ps.push(self.learner_id, flat, timeout=timeout)
        flat = as_flat(flat, self.ps.device)
        padded = self.ps.layout.padded
        if flat.numel() == padded:
            x = flat                    # already block-aligned: no copy
        else:
            if self._stage is None:     # pad tail stays zero
                self._stage = torch.zeros(padded, dtype=torch.float32,
                                          device=self.ps.device)
            self._stage[: flat.numel()].copy_(flat)
            x = self._stage
        # K2, new error written in place over the feedback buffer
        q, scales, _ = self._compress(x, self._err, out_err=self._err)
        ok = self.ps.push(
            self.learner_id,
            CompressedPush(q=q, scales=scales,
                           dense_nbytes=flat.numel() * 4),
            timeout=timeout)
        if not ok:
            # BSP timeout: the wire payload was withdrawn unaggregated —
            # put it back into the feedback buffer so the accumulated
            # transmitted signal stays unbiased
            self._err += ops.dequantize(q, scales)
        return ok

    def pull(self) -> torch.Tensor:
        return self.ps.pull(self.learner_id)
