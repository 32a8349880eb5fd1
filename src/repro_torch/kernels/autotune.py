"""Roofline-seeded autotuner for the launch shapes of the port's CUDA
kernels: the counterpart of ``repro/kernels/autotune.py``.

A "block" keeps the reference's meaning, the values one grid step
handles; on the card that is what one thread block (CTA) handles: K1
(``ps_aggregate``) values per CTA of 256 threads, K2 / K3
(``quantize_ef``, ``dequantize``) values per CTA of one warp per
256-value block, K4 (``flash_attention``) ``(block_q, block_k)``, the
query rows and keys of a tile. Per (kernel, shape, dtype, backend) the
flow is the reference's predict -> rank -> measure-top-K sweep:

  1. enumerate the legal candidates: K1 the multiples of 256 that divide
     F, up to 2,048 (8 values a thread, the kernel's instances; and no
     larger than a block whose probe grid still fills one wave of the
     card); K2 / K3 the same up to 8,192 (1,024 threads); K4's
     tensor-core instance (bf16 at hd 64 / 112 / 128) block_q 128 or 64
     (two warpgroups or one) at block_k 64; its CUDA-core instance has
     one shape, its tile, which is never measured;
  2. rank them with a small model of the card: a candidate that does not
     fit (shared memory over a block's 227 KB, or no block resident on
     an SM by threads, registers or shared memory) predicts ``inf``; the
     others predict the larger of their bytes over the HBM rate and
     their operations over the peak rate, stretched where the grid does
     not fill the card, plus ``WAVE_US`` a wave, waves = ceil(CTAs / (132
     x resident CTAs an SM));
  3. measure the top-K survivors with the real kernel (CUDA events, the
     median of ``MEASURE_REPS`` launches after one untimed warm-up) and
     keep the fastest. K1-K3 measure every candidate (``Plan.top_k``):
     their bytes are the same at every block, so only the model's wave
     term ranks them, and their probes take microseconds.

The machine model, one NVIDIA H100 SXM (NVIDIA's data sheet and Hopper
white paper, as the ``hopper-kernels`` guide tables them, and CUDA's
occupancy limits for compute capability 9.0): 132 SMs; 232,448 bytes
(227 KB) of dynamic shared memory a block, 233,472 (228 KB) an SM, of
which CUDA holds 1 KB for each resident block; 65,536 registers, 2,048
threads and 32 blocks an SM; HBM3 at 3.35 TB/s and 989 TFLOP/s of bf16
on the tensor cores (``analysis/roofline.py``'s ``HBM_BW`` and
``PEAK_FLOPS``). ``WAVE_US``, the fixed cost of a wave of blocks (its
launch and a DRAM round trip before its bytes stream), is an order of
magnitude, not a measurement: it only ranks many small CTAs below fewer
larger ones, and the measured top-K decides. Registers a thread come
from each instance's ``__launch_bounds__`` (K4), or are taken as 32 for
the elementwise K1-K3, whose residency their threads bound.

Choices persist in an on-disk JSON cache keyed by ``(kernel, shape,
dtype, backend)`` (merge-on-write, atomic replace; the reference's
format), so a later job pays no tuning; the in-memory mirror makes a
repeat lookup one dictionary read. The backend names the card,
``cuda:<device name>`` (``cpu`` without one), so a record made on another
card, or by the reference sharing the default file, is never read as
this card's. ``DLAAS_AUTOTUNE=0`` disables the tuner (callers launch
``grid.fit_block``'s default: K1 ``fit_block(F, 1024)``, K2 / K3
``fit_block(F, 4096, 256)``; K4 ``(128, 64)``); ``DLAAS_AUTOTUNE_MEASURE``
forces (``1``) or suppresses (``0``) measurement; ``DLAAS_AUTOTUNE_CACHE``
overrides the cache path.

Where it differs from the reference, by design:
  * ``kernels/ops.py`` asks the tuner only for CUDA tensors: the plain
    version (CPU) and the counted path (meta) have no launch shape.
    Measurement runs only on a CUDA device, and never while the current
    stream is being captured into a CUDA graph (the counterpart of the
    reference's ``_under_trace``); there the best predicted candidate
    wins, as in the reference.
  * Every candidate gives the default's bits (the kernels' notes say
    why), and the tuner holds it to that: before timing a candidate it
    compares the candidate's outputs with the default's on the same
    scratch inputs and raises if one bit differs.
  * No failure is swallowed: a probe that fails to build or launch
    raises, as every kernel launch does (the reference falls back to its
    default, ``autotune.py:234-236``).
  * Probes are not path launches: they go through the wrappers with
    ``probe=True``, which leaves the kernels' ``launches`` /
    ``launches_tc`` as they are, and are counted in ``probe_launches``;
    ``tuning_seconds`` sums the wall time spent measuring.
  * Probes run on scratch tensors of their own, never on the caller's
    (K1 updates in place), freed on return, of at most ``PROBE_VALUES``
    values an operand: K1-K3 a prefix of F (they are elementwise and
    bytes-bound, so a choice of a per-CTA shape carries over to any
    longer F); K4 the leading batch rows (then heads, a whole GQA group
    at a time) of q. The record is keyed by the full shape, and its
    predictions are of the full shape.
  * One tuning runs at a time in a process (``_lock``), so concurrent
    callers (learner threads) of one new shape probe it once.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import statistics
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ps_aggregate as _agg
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.grid import fit_block

log = logging.getLogger("repro_torch.autotune")

# Machine-model terms (H100 SXM; see the module docstring for sources)
SMS = 132
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024          # per resident block
REGS_PER_SM = 65_536
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
ELEMENTWISE_REGS = 32          # K1-K3: registers a thread, taken
WAVE_US = 1.0                  # fixed cost of one wave of blocks

MEASURE_REPS = 5               # timed launches per measured candidate
TOP_K = 3                      # measured survivors of the predicted ranking
PROBE_VALUES = 1 << 24         # scratch values an operand of a probe

_DEFAULT_CACHE = os.path.join(tempfile.gettempdir(),
                              "dlaas-autotune-cache.json")

probe_launches = 0             # launches made by the tuner's probes
tuning_seconds = 0.0           # wall seconds spent measuring candidates
_lock = threading.RLock()


def enabled() -> bool:
    return os.environ.get("DLAAS_AUTOTUNE", "1") != "0"


def measurement_allowed() -> bool:
    """Measured timings are meaningful on a card. Force with
    DLAAS_AUTOTUNE_MEASURE=1, suppress with =0."""
    forced = os.environ.get("DLAAS_AUTOTUNE_MEASURE")
    if forced is not None:
        return forced == "1"
    return torch.cuda.is_available()


@functools.lru_cache(maxsize=None)
def _card(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _backend() -> str:
    """``cuda:<name of the current card>``, or ``cpu`` without one."""
    if not torch.cuda.is_available():
        return "cpu"
    return f"cuda:{_card(torch.cuda.current_device())}"


def cache_path() -> str:
    return os.environ.get("DLAAS_AUTOTUNE_CACHE", _DEFAULT_CACHE)


class AutotuneCache:
    """Persistent kernel-choice cache: a flat JSON object of
    key -> record, written atomically (tmp + rename) so concurrent
    processes never observe a torn file. Records keep the predicted and
    measured timings alongside the choice for observability."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._data: Optional[Dict[str, Dict]] = None
        self.hits = 0       # lookups served from the cache
        self.misses = 0     # lookups that forced a tuning sweep

    def _load(self) -> Dict[str, Dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._data = {}
        return self._data

    def get(self, key: str) -> Optional[Dict]:
        with self._lock:
            rec = self._load().get(key)
            if rec is None:
                self.misses += 1
            else:
                self.hits += 1
            return rec

    def size(self) -> int:
        with self._lock:
            return len(self._load())

    def put(self, key: str, record: Dict) -> None:
        with self._lock:
            # merge-on-write: pick up keys other processes stored since
            # our load, so concurrent tuners don't clobber each other
            on_disk: Dict[str, Dict] = {}
            try:
                with open(self.path) as f:
                    on_disk = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
            data = self._load()
            for k, v in on_disk.items():
                data.setdefault(k, v)
            data[key] = record
            try:
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(self.path) or ".",
                    prefix=".autotune.")
                with os.fdopen(fd, "w") as f:
                    json.dump(data, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError as e:       # read-only FS: in-memory only
                log.warning("autotune cache not persisted to %s: %s",
                            self.path, e)

    def clear(self) -> None:
        with self._lock:
            self._data = {}
            try:
                os.unlink(self.path)
            except OSError:
                pass


_caches: Dict[str, AutotuneCache] = {}
_caches_lock = threading.Lock()


def get_cache() -> AutotuneCache:
    path = cache_path()
    with _caches_lock:
        c = _caches.get(path)
        if c is None:
            c = _caches[path] = AutotuneCache(path)
        return c


def _dtype_name(dtype) -> str:
    return (getattr(dtype, "name", None) or str(dtype)).removeprefix(
        "torch.")


def make_key(kernel: str, shape: Sequence[int], dtype, extra: str = "") \
        -> str:
    dt = _dtype_name(dtype)
    key = f"{kernel}|{'x'.join(str(int(d)) for d in shape)}|{dt}|{_backend()}"
    return key + (f"|{extra}" if extra else "")


def divisor_blocks(f: int, multiple: int = 1, cap: int = 1 << 16) \
        -> List[int]:
    """All blocks that tile F exactly: divisors of F that are multiples
    of ``multiple``, capped."""
    out = []
    d = multiple
    while d <= min(f, cap):
        if f % d == 0:
            out.append(d)
        d += multiple
        if multiple == 1 and d > 4096 and f % 4096:
            break               # dense scan is pointless past this
    return out or [fit_block(f, cap, multiple)]


def _measure(fn: Callable[[], object], reps: int = MEASURE_REPS) -> float:
    """Median device seconds of one ``fn()`` (CUDA events around each of
    ``reps`` calls on the current stream) after one untimed warm-up."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def tune(kernel: str, shape: Sequence[int], dtype, *,
         candidates: Sequence,
         predict_us: Callable[..., float],
         measure_s: Optional[Callable[..., float]] = None,
         default, top_k: int = TOP_K, extra_key: str = ""):
    """Generic predict -> rank -> measure-top-K flow.

    ``candidates`` are opaque configs (ints or tuples). ``predict_us``
    maps a candidate to a modelled time (``inf`` = infeasible).
    ``measure_s``, when given, maps a candidate to measured seconds; when
    None the best *predicted* candidate wins. Returns the chosen config;
    ``default`` is returned on empty sweeps and when tuning is disabled.
    A failing ``measure_s`` raises, and nothing is stored."""
    if not enabled() or not candidates:
        return default
    cache = get_cache()
    key = make_key(kernel, shape, dtype, extra_key)
    rec = cache.get(key)
    if rec is not None:
        choice = rec.get("choice", default)
        return tuple(choice) if isinstance(choice, list) else choice

    ranked = sorted(candidates, key=predict_us)
    predicted = {str(c): round(predict_us(c), 3) for c in ranked}
    feasible = [c for c in ranked if predict_us(c) != float("inf")]
    if not feasible:
        feasible, choice = [default], default
    else:
        choice = feasible[0]
    measured: Dict[str, float] = {}
    source = "predicted"
    if measure_s is not None and len(feasible) > 1:
        for c in feasible[:top_k]:
            measured[str(c)] = round(measure_s(c) * 1e6, 3)
        choice = min(feasible[:top_k], key=lambda c: measured[str(c)])
        source = "measured"
    cache.put(key, {"choice": choice, "source": source,
                    "predicted_us": predicted, "measured_us": measured})
    log.info("autotune %s -> %s (%s)", key, choice, source)
    return choice


# ---------------------------------------------------------------------------
# The machine model
# ---------------------------------------------------------------------------


def _resident(threads: int, smem: int, regs: int) -> int:
    """Blocks of ``threads`` threads, ``smem`` bytes of shared memory and
    ``regs`` registers a thread that one SM holds at once (0: none)."""
    if threads > 1024 or smem > SMEM_PER_BLOCK:
        return 0
    n = min(BLOCKS_PER_SM, THREADS_PER_SM // threads,
            REGS_PER_SM // (threads * regs))
    if smem:
        n = min(n, SMEM_PER_SM // (smem + SMEM_RESERVED))
    return n


def _predict_us(nbytes: float, flops: float, peak: float, ctas: int,
                resident: int) -> float:
    """Modelled microseconds of a grid of ``ctas`` blocks, ``resident``
    of them an SM: the larger of its bytes and operations times,
    stretched by the share of the card an underfilled grid leaves idle,
    plus WAVE_US a wave."""
    if resident == 0 or ctas == 0:
        return float("inf")
    slots = SMS * resident
    fill = min(1.0, ctas / slots)
    busy = max(nbytes / HBM_BW, flops / peak if flops else 0.0) / fill
    return busy * 1e6 + math.ceil(ctas / slots) * WAVE_US


def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(torch, _dtype_name(dtype)).itemsize


# ---------------------------------------------------------------------------
# One kernel at one shape: candidates, model and probe
# ---------------------------------------------------------------------------


class Probe:
    """Scratch inputs of one kernel and a launch of it at any candidate
    (``launch(c)`` returns its outputs, counted in ``probe_launches``).
    ``reset`` restores the state a launch updates in place; ``shape`` is
    the shape the scratch holds."""

    def __init__(self, launch: Callable, shape: Dict, reset=None):
        self._launch, self.shape, self._reset = launch, shape, reset

    def launch(self, c):
        global probe_launches
        out = self._launch(c)
        with _lock:
            probe_launches += 1
        return out

    def run(self, c):
        """The outputs of one launch at ``c`` from the scratch inputs as
        made (copies, where the launch updates them in place)."""
        if self._reset is None:
            return self.launch(c)
        self._reset()
        return tuple(t.clone() for t in self.launch(c))

    def matches(self, c, want) -> bool:
        """Whether one launch at ``c`` from the scratch inputs as made
        gives ``want`` (a ``run``'s outputs) bit for bit."""
        if self._reset is not None:
            self._reset()
        return all(torch.equal(a, b) for a, b in zip(self.launch(c), want))

    def seconds(self, c) -> float:
        return _measure(lambda: self.launch(c))


@dataclass
class Plan:
    """What ``tune`` needs for one kernel at one shape;
    ``probe(device, limit)``, which makes its scratch on ``device``
    (``limit`` values an operand at most; None: the whole shape); and
    ``cost``, the (name, shape) of one launch at the whole shape for
    ``analysis.roofline.kernel_cost``."""
    kernel: str
    shape: Tuple[int, ...]
    dtype: object
    extra_key: str
    candidates: List
    default: object
    predict_us: Callable[..., float]
    probe: Callable[..., Probe]
    cost: Tuple[str, Dict]
    top_k: int = TOP_K


def _randn(n, generator, device, scale=1.0):
    return scale * torch.randn(n, generator=generator, device=device)


def ps_plan(nl: int, f: int, dtype="float32", *,
            default_block: int = _agg.DEFAULT_BLOCK) -> Plan:
    """K1 over (nl, f) learner rows (adam, the solver that moves the
    most bytes: nl rows and p/m/v read, p/m/v written)."""
    default = fit_block(f, default_block)
    nbytes = f * (nl + 6) * _dtype_bytes(dtype)
    resident = _resident(256, 0, ELEMENTWISE_REGS)

    def predict_us(block: int) -> float:
        return _predict_us(nbytes, 0, 1, -(-f // block), resident)

    # the kernel's largest block, and no larger than one whose probe (a
    # prefix of PROBE_VALUES) still fills a wave: a probe's time then
    # carries over to the whole F
    cap = min(_agg.MAX_BLOCK,
              max(256, PROBE_VALUES // (SMS * resident) // 256 * 256))
    cands = (divisor_blocks(f, multiple=256, cap=cap) if f % 256 == 0
             else [default])

    def probe(device, limit=PROBE_VALUES) -> Probe:
        n = f if limit is None else min(f, limit)
        g = torch.Generator(device).manual_seed(0)
        rows = _randn((nl, n), g, device)
        init = [_randn(n, g, device), _randn(n, g, device, 0.1),
                _randn(n, g, device, 0.1).abs()]
        work = [t.clone() for t in init]

        def reset():
            for w, i in zip(work, init):
                w.copy_(i)

        def launch(block):
            return _agg.ps_aggregate_cuda(
                rows, *work, 1, solver="adam", lr=1e-3, b1=0.9, b2=0.999,
                eps=1e-8, momentum=0.9, beta=0.9, block=block, probe=True)
        return Probe(launch, {"NL": nl, "F": n, "solver": "adam"}, reset)

    return Plan("ps_aggregate", (nl, f), dtype, "", cands, default,
                predict_us, probe,
                (_agg.NAME, dict(NL=nl, F=f, solver="adam")), len(cands))


def quantize_plan(f: int, qblock: int = _q.QBLOCK, dtype="float32", *,
                  default_block: int = _q.DEFAULT_BLOCK) -> Plan:
    """K2 over a (f,) push whose x is ``dtype``, or K3 where ``dtype``
    is int8 (the reference tunes both under one name, told apart by
    dtype)."""
    if qblock != _q.QBLOCK:
        raise ValueError(f"the kernels' quantization block is {_q.QBLOCK}, "
                         f"got {qblock}")
    default = fit_block(f, default_block, multiple=qblock)
    deq = _dtype_name(dtype) == "int8"
    nbytes = (f * 5 if deq else f * (_dtype_bytes(dtype) + 9)) \
        + 4 * (f // qblock)

    def predict_us(block: int) -> float:
        threads = 32 * (block // qblock)
        return _predict_us(nbytes, 0, 1, -(-f // block),
                           _resident(threads, 0, ELEMENTWISE_REGS))

    def probe(device, limit=PROBE_VALUES) -> Probe:
        n = f if limit is None else min(f, limit)
        g = torch.Generator(device).manual_seed(0)
        if deq:
            q = torch.randint(-127, 128, (n,), generator=g, device=device,
                              dtype=torch.int8)
            scales = torch.rand(n // qblock, generator=g, device=device)

            def launch(block):
                return (_q.dequantize_cuda(q, scales, block=block,
                                           probe=True),)
            return Probe(launch, {"F": n})
        x = _randn(n, g, device).to(getattr(torch, _dtype_name(dtype)))
        err = _randn(n, g, device, 0.01)

        def launch(block):
            return _q.quantize_ef_cuda(x, err, block=block, probe=True)
        return Probe(launch, {"F": n, "x_dtype": _dtype_name(dtype)})

    cost = ((_q.DEQUANTIZE.NAME, dict(F=f)) if deq else
            (_q.QUANTIZE.NAME, dict(F=f, x_dtype=getattr(
                torch, _dtype_name(dtype)))))
    cands = divisor_blocks(f, multiple=qblock, cap=_q.MAX_BLOCK)
    return Plan("quantize_ef", (f,), dtype, f"q{qblock}", cands, default,
                predict_us, probe, cost, len(cands))


def _flash_tiles(sq, sk, rows, bk, causal, q_offset):
    """Key tiles of ``bk`` that blocks of ``rows`` query rows walk, summed
    over the blocks of one (b, h)."""
    total = 0
    for q0 in range(0, sq, rows):
        end = min(sk, min(q0 + rows, sq) + q_offset) if causal else sk
        total += -(-end // bk)
    return total


def flash_probe_rows(b: int, h: int, group: int, sq: int, hd: int,
                     limit=PROBE_VALUES) -> Tuple[int, int]:
    """(batch rows, query heads) of q that a K4 probe holds: the leading
    batch rows, then heads a whole GQA group at a time, of at most
    ``limit`` values (None: all)."""
    if limit is not None:
        b = max(1, min(b, limit // (sq * h * hd)))
        if b * sq * h * hd > limit:
            h = max(group, limit // (sq * hd) // group * group)
    return b, h


def flash_plan(bh: int, sq: int, sk: int, hd: int, dtype="float32", *,
               heads: Optional[Tuple[int, int]] = None, causal: bool = True,
               q_offset: int = 0, lse: bool = False) -> Plan:
    """K4 over ``bh`` = B x H (query heads) rows of (sq, hd) queries
    against sk keys; ``heads`` (H, KV) (default (1, 1): bh batch rows of
    one head)."""
    H, KV = heads or (1, 1)
    dt = dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, _dtype_name(dtype))
    shapes = list(_fa.launch_shapes(dt, hd))
    default = shapes[0] if shapes else _fa.TC_SHAPES[0]
    tc = dt == torch.bfloat16 and hd in _fa.TENSOR_CORE_HEAD_DIMS
    tw = -(-hd // 64) * 64 if tc else (128 if hd > 64 else hd)
    ib = dt.itemsize
    peak = PEAK_FLOPS.get(_dtype_name(dt), PEAK_FLOPS["float32"])
    io = bh * sq * hd * ib * 2 + (bh * sq * 4 if lse else 0)

    def predict_us(c: Tuple[int, int]) -> float:
        bq, bk = c
        if tc:      # flash_attention.cu TcFwd<HD, BQ>
            threads = 2 * bq
            min_blocks = (2 if tw == 64 else 1) * (128 // bq)
            smem = bq * tw * 2 + 4 * bk * tw * 2 + 1024
            regs = min(255, REGS_PER_SM // (threads * min_blocks))
            rows = 64               # each warpgroup skips its own tiles
        else:       # flash_attention.cu Tile<HD>: static k and v tiles
            threads, smem, regs, rows = 128, 2 * bk * tw * 4, 64, bq
        loaded = _flash_tiles(sq, sk, bq, bk, causal, q_offset)
        walked = _flash_tiles(sq, sk, rows, bk, causal, q_offset)
        nbytes = io + bh * loaded * 2 * bk * hd * ib
        flops = bh * walked * 4 * rows * bk * tw
        return _predict_us(nbytes, flops, peak, -(-sq // bq) * bh,
                           _resident(threads, smem, regs))

    def probe(device, limit=PROBE_VALUES) -> Probe:
        group = H // KV
        b, h = flash_probe_rows(bh // H, H, group, sq, hd, limit)
        g = torch.Generator(device).manual_seed(0)
        q = torch.randn(b, sq, h, hd, generator=g, device=device).to(dt)
        k, v = (torch.randn(b, sk, h // group, hd, generator=g,
                            device=device).to(dt) for _ in range(2))

        def launch(c):
            out = _fa.flash_attention_cuda(
                q, k, v, causal=causal, q_offset=q_offset, return_lse=lse,
                block_q=c[0], probe=True)
            return out if lse else (out,)
        return Probe(launch, {"B": b, "Sq": sq, "Sk": sk, "H": h,
                              "KV": h // group, "hd": hd})

    extra = f"h{H}kv{KV}|causal{int(causal)}|off{q_offset}|lse{int(lse)}"
    cost = dict(B=bh // H, Sq=sq, Sk=sk, H=H, KV=KV, hd=hd, dtype=dt,
                causal=causal, q_offset=q_offset, lse=lse)
    return Plan("flash_attention", (bh, sq, sk, hd), dt, extra, shapes,
                default, predict_us, probe, (_fa.NAME, cost))


# ---------------------------------------------------------------------------
# Per-kernel entry points
# ---------------------------------------------------------------------------


def _tuned(plan: Plan, device=None):
    """``tune`` over ``plan``, measuring on ``device`` when it is a CUDA
    device, measurement is allowed and its stream is not capturing. Each
    measured candidate's outputs must equal the default's bit for bit."""
    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    scope = torch.cuda.device(dev) if cuda else contextlib.nullcontext()
    with _lock, scope:
        measure_s = None
        if cuda and measurement_allowed() and \
                not torch.cuda.is_current_stream_capturing():
            made = {}

            def measure_s(c) -> float:
                global tuning_seconds
                t0 = time.perf_counter()
                if not made:
                    made["probe"] = plan.probe(dev)
                    made["want"] = made["probe"].run(plan.default)
                probe = made["probe"]
                if not probe.matches(c, made["want"]):
                    raise RuntimeError(
                        f"{plan.kernel} at {plan.shape}: launch shape {c} "
                        f"gives other bits than the default {plan.default}")
                s = probe.seconds(c)
                tuning_seconds += time.perf_counter() - t0
                return s
        return tune(plan.kernel, plan.shape, plan.dtype,
                    candidates=plan.candidates, predict_us=plan.predict_us,
                    measure_s=measure_s, default=plan.default,
                    top_k=plan.top_k, extra_key=plan.extra_key)


def tuned_ps_block(nl: int, f: int, dtype="float32", *,
                   default_block: int = _agg.DEFAULT_BLOCK,
                   device=None) -> int:
    """Values per CTA for the fused PS aggregation over (nl, f) rows,
    measured on ``device`` (a CUDA device; None: predicted only)."""
    return _tuned(ps_plan(nl, f, dtype, default_block=default_block),
                  device)


def tuned_quantize_block(f: int, qblock: int = _q.QBLOCK, dtype="float32",
                         *, default_block: int = _q.DEFAULT_BLOCK,
                         device=None) -> int:
    """Values per CTA for the int8 quantize (x ``dtype``) or, with dtype
    int8, dequantize pass over (f,)."""
    return _tuned(quantize_plan(f, qblock, dtype,
                                default_block=default_block), device)


def tuned_flash_blocks(bh: int, sq: int, sk: int, hd: int,
                       dtype="float32", *,
                       heads: Optional[Tuple[int, int]] = None,
                       causal: bool = True, q_offset: int = 0,
                       lse: bool = False, device=None) -> Tuple[int, int]:
    """(block_q, block_k) for flash attention over (bh, sq|sk, hd)."""
    plan = flash_plan(bh, sq, sk, hd, dtype, heads=heads, causal=causal,
                      q_offset=q_offset, lse=lse)
    if bh == 0 or sq == 0:
        return plan.default
    return tuple(_tuned(plan, device))
