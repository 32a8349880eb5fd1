"""Public kernel entry points of the port.

Each op picks its path from where its tensors lie, and from nothing
else: a CPU tensor goes to the plain PyTorch version (``ref.py``), a
CUDA tensor to the hand-written kernel, which either launches or raises.
There is no ``try`` that falls back from the kernel to the plain version.

A meta tensor (``analysis.roofline.count_program`` runs a program on the
meta device to count it) takes a third path that computes nothing: the
op adds its kernel's ``kernel_cost`` at these shapes to the active count
and returns empty meta tensors of the kernel's output shapes and dtypes
(in-place outputs are the tensors given). No launch count moves, and a
meta tensor never reaches a plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.analysis import roofline
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ps_aggregate as _agg
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb

# every kernel: NAME, SOURCE, REPLACES, launches
KERNELS = (_fa, _fab, _agg, _q.QUANTIZE, _q.DEQUANTIZE, _ssd, _ssdb)


def _where(op: str, *ts) -> str:
    """'cpu', 'cuda' or 'meta' when every tensor lies there; raises
    otherwise."""
    devs = {t.device.type for t in ts}
    if len(devs) == 1 and devs <= {"cpu", "cuda", "meta"}:
        return devs.pop()
    raise ValueError(f"{op}: tensors on {sorted(devs)}; want all on the "
                     "CPU (plain version), all on CUDA (kernel) or all on "
                     "meta (counted)")


def _count(name: str, **shape) -> None:
    roofline.record_kernel(name, roofline.kernel_cost(name, **shape))


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    return_lse: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Softmax attention with scale hd^-0.5 and f32 accumulation; GQA heads
    by index (KV head = h // (H // KV)); causal masking lets query i see
    keys j <= i + q_offset. Any Sq/Sk. With ``return_lse``, returns
    (o, lse) with the row log-sum-exp lse (B, H, Sq) f32."""
    where = _where("flash_attention", q, k, v)
    if where == "meta":
        _fa.check_shapes(q, k, v, q_offset)
        B, Sq, H, hd = q.shape
        _count(_fa.NAME, B=B, Sq=Sq, Sk=k.shape[1], H=H, KV=k.shape[2],
               hd=hd, dtype=q.dtype, causal=causal, q_offset=q_offset,
               lse=return_lse)
        o = q.new_empty((B, Sq, H, hd))
        if return_lse:
            return o, q.new_empty((B, H, Sq), dtype=torch.float32)
        return o
    if where == "cpu":
        _fa.check_shapes(q, k, v, q_offset)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset,
                                       return_lse=return_lse)
    return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset,
                                    return_lse=return_lse)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool,
                        q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` from its output ``o``, row
    log-sum-exp ``lse`` and the output gradient ``do``; each in its
    input's dtype, dk/dv summed over each KV head's group."""
    where = _where("flash_attention_bwd", q, k, v, o, lse, do)
    if where == "meta":
        _fab.check_shapes(q, k, v, o, lse, do, q_offset)
        B, Sq, H, hd = q.shape
        _count(_fab.NAME, B=B, Sq=Sq, Sk=k.shape[1], H=H, KV=k.shape[2],
               hd=hd, dtype=q.dtype, causal=causal, q_offset=q_offset)
        return (torch.empty_like(q, memory_format=torch.contiguous_format),
                torch.empty_like(k, memory_format=torch.contiguous_format),
                torch.empty_like(v, memory_format=torch.contiguous_format))
    if where == "cpu":
        _fab.check_shapes(q, k, v, o, lse, do, q_offset)
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, q_offset=q_offset)
    return _fab.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset)


def ssd_scan(x, dt, a_log, b, c, *, chunk: int):
    """Mamba-2 SSD chunked scan in the model layout: x (B, S, H, P), dt
    (B, S, H) after softplus, a_log (H,), b/c (B, S, G, N) with H % G ==
    0 -> (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32). No
    D-skip and no gating (the block adds them)."""
    where = _where("ssd_scan", x, dt, a_log, b, c)
    if where == "meta":
        _ssd.check_shapes(x, dt, a_log, b, c, chunk)
        B, S, H, P = x.shape
        G, N = b.shape[2], b.shape[3]
        _count(_ssd.NAME, B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk,
               dtype=x.dtype)
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                x.new_empty((B, H, P, N), dtype=torch.float32))
    if where == "cpu":
        _ssd.check_shapes(x, dt, a_log, b, c, chunk)
        return ref.ssd_scan_ref(x, dt, a_log, b, c, chunk=chunk)
    return _ssd.ssd_scan_cuda(x, dt, a_log, b, c, chunk=chunk)


def ssd_scan_bwd(x, dt, a_log, b, c, dy, dstate=None, *, chunk: int):
    """Gradients (dx, ddt, da_log, db, dc) of ``ssd_scan`` from the
    output gradient ``dy`` (x's shape and dtype) and ``dstate``, the
    final state's (B, H, P, N) f32 (None: zeros). ddt is f32, every other
    gradient in its input's dtype; db/dc summed over each group's
    heads."""
    ts = (x, dt, a_log, b, c, dy) + ((dstate,) if dstate is not None
                                     else ())
    where = _where("ssd_scan_bwd", *ts)
    if where == "meta":
        _ssdb.check_shapes(x, dt, a_log, b, c, dy, dstate, chunk)
        B, S, H, P = x.shape
        _count(_ssdb.NAME, B=B, S=S, H=H, P=P, G=b.shape[2], N=b.shape[3],
               chunk=chunk, dtype=x.dtype, dstate=dstate is not None)
        return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                     for t in (x, dt, a_log, b, c))
    if where == "cpu":
        _ssdb.check_shapes(x, dt, a_log, b, c, dy, dstate, chunk)
        return ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, dstate,
                                    chunk=chunk)
    return _ssdb.ssd_scan_bwd_cuda(x, dt, a_log, b, c, dy, dstate,
                                   chunk=chunk)


def quantize_ef(x, err, *, out_err=None):
    """x (F,) f32 or bf16, err (F,) f32, F % 256 == 0 -> (q int8 (F,),
    scales f32 (F/256,), new_err f32 (F,)): int8 block quantization of
    ``x + err`` with error feedback. ``out_err`` (may be ``err``) takes
    new_err in place."""
    where = _where("quantize_ef", x, err)
    if where == "meta":
        _q.check_quantize(x, err)
        n = x.numel()
        _count(_q.QUANTIZE.NAME, F=n, x_dtype=x.dtype)
        return (x.new_empty(n, dtype=torch.int8),
                x.new_empty(n // _q.QBLOCK, dtype=torch.float32),
                out_err if out_err is not None else torch.empty_like(err))
    if where == "cpu":
        _q.check_quantize(x, err)
        q, scales, new_err = ref.quantize_ref(x, err)
        if out_err is not None:
            new_err = out_err.copy_(new_err)
        return q, scales, new_err
    return _q.quantize_ef_cuda(x, err, out_err=out_err)


def dequantize(q, scales, *, out=None):
    """q int8 (F,), scales f32 (F/256,) -> q * scale per block, f32
    (F,), written into ``out`` when given."""
    where = _where("dequantize", q, scales)
    if where == "meta":
        _q.check_dequantize(q, scales, out)
        _count(_q.DEQUANTIZE.NAME, F=q.numel())
        return out if out is not None else q.new_empty(
            q.numel(), dtype=torch.float32)
    if where == "cpu":
        _q.check_dequantize(q, scales, out)
        return ref.dequantize_ref(q, scales, out=out)
    return _q.dequantize_cuda(q, scales, out=out)


def ps_aggregate(rows, params, m, v, step, *, solver: str = "adam",
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, momentum: float = 0.9,
                 beta: float = 0.9):
    """rows (NL, F) f32 (any row stride), params/m/v (F,) f32, step the
    1-based solver step: mean over rows + one solver update, in place on
    params/m/v. Returns (params, m, v)."""
    kw = dict(solver=solver, lr=lr, b1=b1, b2=b2, eps=eps,
              momentum=momentum, beta=beta)
    where = _where("ps_aggregate", rows, params, m, v)
    if where == "meta":
        _agg.check_args(rows, params, m, v, solver)
        _count(_agg.NAME, NL=rows.shape[0], F=rows.shape[1], solver=solver)
        return params, m, v
    if where == "cpu":
        _agg.check_args(rows, params, m, v, solver)
        return ref.ps_aggregate_ref(rows, params, m, v, step, **kw)
    return _agg.ps_aggregate_cuda(rows, params, m, v, step, **kw)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {m.NAME: m.launches for m in KERNELS}


def reset_launch_counts() -> None:
    for m in KERNELS:
        m.launches = 0
    for m in (_fa, _fab, _ssd, _ssdb):
        m.launches_tc = 0
