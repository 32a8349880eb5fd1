"""Roofline of the port's programs on H100 constants: the counterpart of
``repro/analysis/roofline.py``.

The reference lowers a step to XLA HLO and walks it. The port has no HLO:
it runs eager PyTorch with hand-written kernels inside it, so it counts a
program by running it once on the ``meta`` device (shapes and dtypes,
no data, nothing on the card) under a ``TorchDispatchMode``
(``count_program``):

  * FLOPs: every ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution``,
    forward and backward, by ``torch.utils.flop_counter``'s formulas
    (2 x multiply-adds), as the reference counts every ``dot``.
  * HBM bytes: inputs read plus outputs written of every aten op that
    launches a kernel. Eager PyTorch fuses nothing, so that is the port's
    real traffic. Views and metadata ops (``view``, ``t``, ``expand``,
    ``slice``, ``detach``, ...) and allocations count 0. A gather counts
    its indices and twice its output (read the rows, write them), an
    indexed write its indices and twice its values, as the reference
    counts slices and gathers.
  * The hand-written kernels (K1-K5, K4b, K5b) are one step each: their
    wrappers in ``kernels/ops.py`` take a meta branch that adds
    ``kernel_cost`` of their shapes to the active count and returns
    empty outputs. Each reads its inputs once and writes its outputs
    once: the reference's "fused: interior bytes don't count".
  * Collectives: each functional collective (``_c10d_functional``
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
    ``all_to_all_single``: the ops DTensor and the sharded steps issue)
    dispatched while a counter is active adds its wire bytes per device
    by the reference's formula (``wire_bytes``) to
    ``collective_bytes_by_kind`` and ``ici_bytes_per_device``, and
    ``collective_s`` is their time at ``NVLINK_BW``. On meta tensors a
    functional collective moves no data, so the sharded step counted on
    the meta device (``distributed.steps.local_train_step``) counts the
    collectives it would issue. A one-card step has none: 0 and {}. Ops
    on tensor subclasses (DTensor) are not counted: the local ops they
    run are.
  * Memory (``memory_program``, the reference's ``memory_analysis``):
    every storage an op returns that is new adds its bytes while it
    lives (a ``weakref.finalize`` on the storage takes them off again);
    views and in-place ops return no new storage and add nothing. The
    arguments' storages are ``argument_size_in_bytes``; the high-water
    mark of the others, less the outputs', is ``temp_size_in_bytes``.
    Autograd's saved tensors count while they are held, which is what
    ``remat`` changes. On the card the caching allocator rounds each
    block up and libraries may take workspace of their own, which this
    count does not see.

Compute time takes each operation's peak for its own dtype (bf16 on the
tensor cores, f32 outside them: the port leaves TF32 off), memory time
the HBM rate. ``model_flops`` and ``roofline_row`` are the reference's,
on the port's configs.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,   # tensor cores
              "float32": 67e12}                        # outside them
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s/card, one direction of NVLink 4
NET_BW = 50e9                # bytes/s/card across hosts: one 400 Gb/s NIC
                             # per card (modelling assumption, as the
                             # reference's DCN rate)
HBM_BYTES = 80e9             # bytes of device memory: H100 SXM5 80 GB

# ops that launch nothing or only relabel memory: 0 bytes (besides every
# overload whose schema says it returns a view)
_NO_TRAFFIC = {
    "view", "_unsafe_view", "t", "transpose", "permute", "expand",
    "slice", "select", "as_strided", "detach", "alias", "unsqueeze",
    "squeeze", "_reshape_alias", "split", "unbind", "split_with_sizes",
    "narrow", "diagonal", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "resize_", "set_",
    "wait_tensor",
}
# gathers: read the indexed rows (output-sized), write the output
_GATHERS = {"embedding", "index", "index_select", "gather"}
# indexed writes into an existing tensor: read and write the values
_INDEXED_WRITES = {"index_put_", "index_copy_"}
# ops that write their first argument without reading it
_WRITE_ONLY_SELF = {"copy_", "fill_", "zero_"}
# functional collectives, by the reference's HLO kind
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}


def wire_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes one device sends for a collective of ``kind`` over ``n``
    ranks whose operand is ``payload`` bytes (``roofline.py:363-380`` of
    the reference): all-gather (n-1)·payload; reduce-scatter and
    all-to-all payload·(n-1)/n; all-reduce 2·payload·(n-1)/n."""
    if kind == "all-gather":
        return (n - 1) * payload
    if kind in ("reduce-scatter", "all-to-all"):
        return payload * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    return payload


def collective_totals(colls) -> Dict:
    """The collective keys of ``ProgramCounter.totals`` from a list of
    (kind, payload bytes, ranks): ``collective_bytes_by_kind`` (wire
    bytes, kinds with none left out), ``ici_bytes_per_device`` and
    ``collective_s`` at ``NVLINK_BW``."""
    by_kind: Dict[str, float] = {}
    for kind, payload, n in colls:
        w = wire_bytes(kind, payload, n)
        if w:
            by_kind[kind] = by_kind.get(kind, 0.0) + w
    ici = sum(by_kind.values())
    return {"ici_bytes_per_device": ici,
            "collective_bytes_by_kind": by_kind,
            "collective_s": ici / NVLINK_BW}


def peak_flops(dtype) -> float:
    """The card's peak rate for operations on ``dtype`` (a torch dtype
    or its name); f32's for any type without a tensor-core rate here."""
    return PEAK_FLOPS.get(str(dtype).removeprefix("torch."),
                          PEAK_FLOPS["float32"])


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t``: a broadcast (stride 0)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _device_bytes(ts) -> int:
    """Bytes of the tensors that lie on the device (meta here): a host
    tensor copied in is counted where it is written, not read."""
    return sum(_nbytes(t) for t in ts if t.device.type == "meta")


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes of one aten op: inputs read once plus outputs written
    once, 0 for views and allocations."""
    name = func.overloadpacket.__name__
    if name in _NO_TRAFFIC or getattr(func, "is_view", False):
        return 0
    if name in _GATHERS:
        idx = _tensors(args[1:]) + _tensors(list(kwargs.values()))
        return _device_bytes(idx) + 2 * _device_bytes(_tensors(out))
    if name in _INDEXED_WRITES:
        rest = _tensors(args[1:])
        values = rest[-1:] if rest else []
        return _device_bytes(rest) + _device_bytes(values)
    reads = [] if name in _WRITE_ONLY_SELF else _tensors(args[:1])
    reads += _tensors(args[1:])
    reads += [t for k, v in kwargs.items() if k != "out"
              for t in _tensors(v)]
    return _device_bytes(reads) + _device_bytes(_tensors(out))


def op_flops(func, args, kwargs, out) -> float:
    """FLOPs of one aten op (0 outside ``flop_counter``'s products)."""
    formula = flop_registry.get(func.overloadpacket)
    if formula is None:
        return 0.0
    return float(formula(*args, **kwargs, out_val=out))


# ---------------------------------------------------------------------------
# Kernel costs: one formula per hand-written kernel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelCost:
    """The least work of one kernel call: FLOPs, HBM bytes (inputs read
    once, outputs written once) and the type whose peak bounds the
    operations."""
    flops: float
    bytes: float
    dtype: str = "float32"

    @property
    def compute_s(self) -> float:
        return self.flops / peak_flops(self.dtype)

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def bound_s(self) -> float:
        """The least time the card could take for the call."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.memory_s >= self.compute_s else "operations"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _esize(dtype) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[_dtype_name(dtype)]


def causal_pairs(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs attention computes: query i sees keys j <=
    i + q_offset when causal, every key otherwise."""
    if not causal:
        return sq * sk
    t = min(max(sk - 1 - q_offset, 0), sq)    # rows that see < sk keys
    return t * (t + 1) // 2 + t * q_offset + (sq - t) * sk


def keys_read(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """Keys attention reads: causal, the last query sees the first
    sq + q_offset of them; otherwise all sk."""
    return min(sk, sq + q_offset) if causal else sk


def _flash_attention(B, Sq, Sk, H, KV, hd, dtype, causal, q_offset=0,
                     lse=False):
    """q, o (and the f32 row LSE) and the keys and values some query
    sees read or written once; QK^T and PV over the pairs."""
    sk = keys_read(Sq, Sk, causal, q_offset)
    nbytes = (2 * B * Sq * H + 2 * B * sk * KV) * hd * _esize(dtype)
    if lse:
        nbytes += 4 * B * H * Sq
    flops = 4 * B * H * hd * causal_pairs(Sq, Sk, causal, q_offset)
    return KernelCost(flops, nbytes, _dtype_name(dtype))


def _flash_attention_bwd(B, Sq, Sk, H, KV, hd, dtype, causal, q_offset=0):
    """q, o, dO, the LSE and the keys and values some query sees read,
    dq, dk, dv written (dk, dv over all Sk); five products over the pairs
    (S and dP recomputed, dV, dQ, dK)."""
    sk = keys_read(Sq, Sk, causal, q_offset)
    nbytes = ((4 * B * Sq * H + 2 * B * (sk + Sk) * KV) * hd
              * _esize(dtype) + 4 * B * H * Sq)
    flops = 10 * B * H * hd * causal_pairs(Sq, Sk, causal, q_offset)
    return KernelCost(flops, nbytes, _dtype_name(dtype))


def _ssd_scan(B, S, H, P, G, N, chunk, dtype):
    """x, dt, a_log, b, c read once; y and the f32 state written once.
    Per (b, h, chunk of q positions): 2 P q(q+1)/2 for the masked
    quadratic form, 2 q P N for the incoming state's term, 2 q P N for
    the chunk's state; per (b, g, chunk): 2 N q(q+1)/2 for C.B^T."""
    esize = _esize(dtype)
    nbytes = ((2 * B * S * H * P + 2 * B * S * G * N) * esize
              + 4 * B * S * H + 4 * H + 4 * B * H * P * N)
    q = min(chunk, S)
    pairs = sum(n * (n + 1) // 2
                for n in (min(q, S - s0) for s0 in range(0, S, q)))
    flops = B * H * (2 * P * pairs + 4 * S * P * N) + B * G * 2 * N * pairs
    return KernelCost(flops, nbytes, _dtype_name(dtype))


def _ssd_scan_bwd(B, S, H, P, G, N, chunk, dtype, dstate=False):
    """x, dt, a_log, b, c, dy (and the f32 dstate when given) read once;
    dx, ddt, da_log, db, dc written once (the kernel's scratch, such as
    its f32 chunk states, is its own traffic, not the function's). Per
    (b, h, chunk of q positions):
    2 P q(q+1)/2 each for G = dy.xdt^T and dxdt's masked term, 2 N
    q(q+1)/2 each for dC's and dB's masked terms, and 2 q P N each for
    the recomputed chunk state, the chunk's dy.C^T term and the state
    terms of dxdt, dC and dB; per (b, g, chunk): 2 N q(q+1)/2 for
    C.B^T."""
    esize = _esize(dtype)
    q = min(chunk, S)
    nbytes = ((3 * B * S * H * P + 4 * B * S * G * N) * esize
              + 8 * B * S * H + 8 * H)
    if dstate:
        nbytes += 4 * B * H * P * N
    pairs = sum(n * (n + 1) // 2
                for n in (min(q, S - s0) for s0 in range(0, S, q)))
    flops = (B * H * (4 * P * pairs + 4 * N * pairs + 10 * S * P * N)
             + B * G * 2 * N * pairs)
    return KernelCost(flops, nbytes, _dtype_name(dtype))


def _quantize_ef(F, x_dtype):
    """x and err read; q (int8), the new err and one f32 scale per
    256-block written."""
    return KernelCost(0.0, F * (_esize(x_dtype) + 4 + 1 + 4) + 4 * (F // 256))


def _dequantize(F):
    """q (int8) and the scales read, f32 x written."""
    return KernelCost(0.0, F * (1 + 4) + 4 * (F // 256))


# per solver: reads and writes of the (F,) f32 state besides the rows
_SOLVER_STATE = {"sgd": 2, "momentum": 4, "adam": 6, "easgd_center": 2,
                 "average": 1}


def _ps_aggregate(NL, F, solver):
    """The NL f32 rows read; params (and m, v where the solver keeps
    them) read and written, ``average`` writes params only."""
    return KernelCost(0.0, (NL + _SOLVER_STATE[solver]) * 4 * F)


_KERNEL_COSTS: Dict[str, Callable[..., KernelCost]] = {
    "flash_attention": _flash_attention,
    "flash_attention_bwd": _flash_attention_bwd,
    "ssd_scan": _ssd_scan,
    "ssd_scan_bwd": _ssd_scan_bwd,
    "quantize_ef": _quantize_ef,
    "dequantize": _dequantize,
    "ps_aggregate": _ps_aggregate,
}


def kernel_cost(name: str, **shape) -> KernelCost:
    """The least work of hand-written kernel ``name`` at ``shape``:
    ``flash_attention(B, Sq, Sk, H, KV, hd, dtype, causal, q_offset,
    lse)``, ``flash_attention_bwd(B, Sq, Sk, H, KV, hd, dtype, causal,
    q_offset)``, ``ssd_scan(B, S, H, P, G, N, chunk, dtype)``,
    ``ssd_scan_bwd(B, S, H, P, G, N, chunk, dtype, dstate)``,
    ``quantize_ef(F, x_dtype)``, ``dequantize(F)``, ``ps_aggregate(NL, F,
    solver)``."""
    return _KERNEL_COSTS[name](**shape)


# ---------------------------------------------------------------------------
# Counting a program on the meta device
# ---------------------------------------------------------------------------


@dataclass
class _Tally:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    compute_s: float = 0.0


_active = threading.local()


def _storage(t: torch.Tensor):
    """The storage of ``t`` (of a DTensor, its local tensor's)."""
    local = getattr(t, "_local_tensor", None)
    return (t if local is None else local).untyped_storage()


class ProgramCounter(TorchDispatchMode):
    """Counts every aten op dispatched on this thread while it is
    entered, keyed by op name, and the kernels recorded by
    ``record_kernel``, keyed by kernel name; and the bytes of the
    storages its ops make while they live (``hold_arguments``,
    ``memory``)."""

    def __init__(self):
        super().__init__()
        self.by_key: Dict[str, _Tally] = {}
        self.colls: List = []        # (kind, payload bytes, ranks)
        self.args: Dict[int, int] = {}     # argument storage -> bytes
        self.live: Dict[int, int] = {}     # other live storage -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0

    def hold_arguments(self, args) -> None:
        """Take the storages of the tensors in ``args`` (any tree) as the
        program's arguments."""
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                self.args[st._cdata] = st.nbytes()

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = _storage(t)
            key = st._cdata
            if key in self.args or key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def memory(self, result) -> Dict[str, int]:
        """The reference's ``memory_analysis`` sizes of a program that
        returned ``result``: ``argument_size_in_bytes``,
        ``output_size_in_bytes`` (every storage returned, as XLA counts
        every output buffer), ``alias_size_in_bytes`` (the arguments among
        them, updated in place), ``temp_size_in_bytes`` (the high-water
        mark of the other live storages, less the new outputs') and
        ``peak_bytes_per_device`` = arguments - alias + output + temp."""
        out: Dict[int, int] = {}
        for t in tree_leaves(result):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                out[st._cdata] = st.nbytes()
        alias = sum(n for k, n in out.items() if k in self.args)
        output = sum(out.values())
        temp = max(0, self.peak_bytes - (output - alias))
        arg = sum(self.args.values())
        return {"argument_size_in_bytes": arg,
                "output_size_in_bytes": output,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": temp,
                "peak_bytes_per_device": arg - alias + output + temp}

    def add(self, key: str, flops: float, nbytes: float,
            compute_s: float) -> None:
        t = self.by_key.setdefault(key, _Tally())
        t.calls += 1
        t.flops += flops
        t.bytes += nbytes
        t.compute_s += compute_s

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.stack.pop()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               for t in types):
            return out      # a tensor subclass: its local ops are counted
        self._track(out)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional" \
                and name.rstrip("_") in _COLLECTIVES:
            self.colls.append(_collective(name.rstrip("_"), args))
            return out
        flops = op_flops(func, args, kwargs, out)
        nbytes = op_bytes(func, args, kwargs, out)
        if flops or nbytes:
            ts = _tensors(args)
            peak = peak_flops(ts[0].dtype if ts else torch.float32)
            self.add(func.overloadpacket.__name__, flops, nbytes,
                     flops / peak)
        return out

    def totals(self) -> Dict:
        """The reference's ``analyze_hlo_text`` keys. Every collective
        counts at NVLink (one host); ``dcn_bytes_per_device`` is 0."""
        flops = sum(t.flops for t in self.by_key.values())
        nbytes = sum(t.bytes for t in self.by_key.values())
        return {
            "flops_per_device": flops,
            "hbm_bytes_per_device": nbytes,
            "dcn_bytes_per_device": 0.0,
            "compute_s": sum(t.compute_s for t in self.by_key.values()),
            "memory_s": nbytes / HBM_BW,
            **collective_totals(self.colls),
        }


def _collective(name: str, args):
    """(kind, payload bytes, ranks) of a functional collective's call."""
    t = args[0]
    payload = t.numel() * t.element_size()
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        n = int(args[-2])
    else:
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        n = _resolve_process_group(args[-1]).size()
    return (_COLLECTIVES[name], payload, n)


def record_kernel(name: str, cost: KernelCost) -> None:
    """Add one call of kernel ``name`` to the counter active on this
    thread; nothing when none is."""
    stack = getattr(_active, "stack", None)
    if stack:
        stack[-1].add(name, cost.flops, cost.bytes, cost.compute_s)


def _on_meta(x):
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


def _count(fn: Callable, args, kw):
    """(counter, result) of one run of ``fn`` on meta arguments."""
    args, kw = tree_map(_on_meta, (args, kw))
    counter = ProgramCounter()
    counter.hold_arguments((args, kw))
    with counter:
        result = fn(*args, **kw)
    return counter, result


def measure_program(fn: Callable, *args, **kw):
    """(``count_program``'s terms, ``memory_program``'s sizes, the
    per-op rows of ``breakdown`` unsorted) of one run of ``fn`` on the
    meta device: the three from the same pass."""
    counter, result = _count(fn, args, kw)
    mem = counter.memory(result)
    return counter.totals(), mem, _rows(counter)


def memory_program(fn: Callable, *args, **kw) -> Dict[str, int]:
    """The reference's ``memory_analysis`` of ``fn(*args, **kw)`` run
    once on the meta device: ``ProgramCounter.memory``'s sizes. Arguments
    as in ``count_program``; nothing runs on the card."""
    counter, result = _count(fn, args, kw)
    return counter.memory(result)


def count_program(fn: Callable, *args, **kw) -> Dict:
    """Run ``fn(*args, **kw)`` once on the meta device and return its
    roofline terms under the reference's keys: ``flops_per_device``,
    ``hbm_bytes_per_device``, ``ici_bytes_per_device``,
    ``dcn_bytes_per_device`` (0), ``collective_bytes_by_kind``,
    ``compute_s``, ``memory_s``, ``collective_s`` (a one-card program
    issues no collective: 0 and {}). Tensor arguments not
    on meta are replaced by empty meta tensors of their shape, dtype and
    strides; tensors ``fn`` makes must be made on its arguments' device.
    Nothing runs on the card and no device memory is allocated."""
    return _count(fn, args, kw)[0].totals()


def breakdown(fn: Callable, *args, top: int = 15, **kw) -> List[Dict]:
    """Per-op attribution of ``count_program(fn, ...)``, keyed by aten op
    or kernel name, heaviest traffic first: the profile the reference's
    ``breakdown`` gives of an HLO module."""
    rows = _rows(_count(fn, args, kw)[0])
    rows.sort(key=lambda r: -r["GB"])
    return rows[:top]


def _rows(counter: ProgramCounter) -> List[Dict]:
    return [{"op": key, "calls": t.calls, "flops": t.flops,
             "GB": round(t.bytes / 1e9, 6), "compute_s": t.compute_s,
             "memory_s": t.bytes / HBM_BW}
            for key, t in counter.by_key.items()]


# ---------------------------------------------------------------------------
# Analytic model FLOPs (the reference's, on the port's configs)
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step (global, all chips).

    train:   6·N_active·T + 12·L_attn·B·S²·H·hd·(causal 1/2)
    prefill: 2·N_active·T +  4·L_attn·B·S²·H·hd·(1/2)
    decode:  2·N_active·B +  4·L_attn·B·S_cache·H·hd
    (SSM layers contribute their SSD term instead of S².)
    """
    n_act = cfg.n_active_params()
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    # attention layer census
    if cfg.family == "ssm":
        l_attn = 0
    elif cfg.family == "hybrid":
        l_attn = cfg.n_layers // cfg.attn_period
    elif cfg.family == "encdec":
        l_attn = 3 * cfg.n_layers  # enc self + dec self + cross
    else:
        l_attn = cfg.n_layers
    h_hd = (cfg.n_heads * cfg.hd) if cfg.n_heads else 0

    def ssd_flops(tokens):
        if cfg.ssm is None:
            return 0.0
        from repro_torch.models.mamba import mamba_dims
        d_in, nh, gn, _ = mamba_dims(cfg)
        q = cfg.ssm.chunk_size
        n = cfg.ssm.d_state
        p = cfg.ssm.head_dim
        n_ssm = (cfg.n_layers if cfg.family == "ssm"
                 else cfg.n_layers - cfg.n_layers // cfg.attn_period)
        per_tok = 2 * q * gn + 2 * q * nh * p + 4 * nh * p * n
        mult = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]
        return mult * n_ssm * tokens * per_tok

    if kind == "train":
        t = B * S
        return 6.0 * n_act * t + 12.0 * l_attn * B * S * S * h_hd * 0.5 \
            + ssd_flops(t)
    if kind == "prefill":
        t = B * S
        return 2.0 * n_act * t + 4.0 * l_attn * B * S * S * h_hd * 0.5 \
            + ssd_flops(t)
    # decode
    return 2.0 * n_act * B + 4.0 * l_attn * B * S * h_hd + ssd_flops(B)


def roofline_row(rec: Dict, analysis: Dict, cfg, shape,
                 n_chips: int) -> Dict:
    """One row of a roofline table: the three terms, the dominant one,
    model FLOPs against the counted ones, and the share of the roofline
    an ideal step (model FLOPs at the model dtype's peak) would reach."""
    mf = model_flops(cfg, shape)
    fpd = analysis["flops_per_device"]
    terms = {
        "compute_s": analysis["compute_s"],
        "memory_s": analysis["memory_s"],
        "collective_s": analysis["collective_s"],
    }
    dom = max(terms, key=terms.get)
    bound_s = max(terms.values())
    ideal_s = mf / n_chips / peak_flops(cfg.dtype)
    return {
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dom.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_per_device": fpd,
        "useful_ratio": round(mf / n_chips / max(fpd, 1), 4),
        "roofline_frac": round(ideal_s / max(bound_s, 1e-12), 4),
        "ici_GB": round(analysis["ici_bytes_per_device"] / 1e9, 3),
        "dcn_GB": round(analysis["dcn_bytes_per_device"] / 1e9, 3),
        "hbm_GB": round(analysis["hbm_bytes_per_device"] / 1e9, 3),
    }
