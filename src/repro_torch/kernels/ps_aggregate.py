"""Wrapper of the hand-written CUDA fused PS aggregation kernel
(``csrc/ps_aggregate.cu``), the port of the Pallas TPU kernel
``repro/kernels/ps_aggregate.py:_agg_kernel``.

The wrapper checks what the kernel takes, launches on the current stream
and raises if the launch is refused. The update is in place on the PS's
device-resident params/m/v; the learner rows are read through their row
stride, so a column slice of the PS receive buffer goes in as it lies.
``block`` is the launch shape, the values each thread block of 256
threads handles, 1 to ``MAX_BLOCK`` (``kernels/autotune.py`` chooses it; the default is ``grid.fit_block``'s,
as the reference's ``ps_aggregate(block=1024)``); every block gives the
same bits. ``launches`` counts the launches, except the tuner's probes
(``probe=True``), which ``autotune.probe_launches`` counts. Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid import fit_block

NAME = "ps_aggregate"
SOURCE = "src/repro_torch/kernels/csrc/ps_aggregate.cu"
REPLACES = "src/repro/kernels/ps_aggregate.py:27"
SOLVERS = {"sgd": 0, "momentum": 1, "adam": 2, "easgd_center": 3,
           "average": 4}
DEFAULT_BLOCK = 1024  # requested of fit_block (the reference's default)
MAX_BLOCK = 2048      # 8 values a thread of 256: the kernel's instances

launches = 0          # kernel launches in this process (see ops.py)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load(NAME).ps_aggregate
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int] + \
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int] + \
            [ctypes.c_float] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_args(rows, params, m, v, solver: str):
    """Rules shared by the kernel and its plain version: rows (NL, F)
    f32 contiguous along F; params/m/v contiguous (F,) f32."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of "
                         f"{sorted(SOLVERS)}")
    if rows.dim() != 2 or rows.shape[0] < 1:
        raise ValueError(f"rows must be (NL >= 1, F), got "
                         f"{tuple(rows.shape)}")
    f = rows.shape[1]
    for name, t in (("rows", rows), ("params", params), ("m", m),
                    ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if rows.stride(1) != 1 and f > 1:
        raise ValueError(f"rows must be contiguous along F (strides "
                         f"{rows.stride()})")
    for name, t in (("params", params), ("m", m), ("v", v)):
        if t.dim() != 1 or t.numel() != f or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({f},), got "
                             f"{tuple(t.shape)}")


def ps_aggregate_cuda(rows, params, m, v, step, *, solver: str,
                      lr: float, b1: float, b2: float, eps: float,
                      momentum: float, beta: float, block=None,
                      probe: bool = False):
    """One fused mean + solver pass on CUDA tensors, in place; returns
    (params, m, v). ``block``: values per thread block (None: the
    default); ``probe``: a tuning probe, which ``launches`` leaves out.
    Raises on anything the kernel does not take."""
    global launches
    check_args(rows, params, m, v, solver)
    dev = rows.device
    if dev.type != "cuda" or any(t.device != dev for t in (params, m, v)):
        raise ValueError("ps_aggregate_cuda wants every tensor on one CUDA "
                         "device")
    n_rows, f = rows.shape
    if f == 0:
        return params, m, v
    row_stride = rows.stride(0) if n_rows > 1 else f
    block = fit_block(f, DEFAULT_BLOCK) if block is None else int(block)
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be 1 to {MAX_BLOCK} values, got "
                         f"{block}")
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # (1 - b) in double, then f32: the value JAX's f32 arrays see
        err = fn(rows.data_ptr(), row_stride, n_rows, params.data_ptr(),
                 m.data_ptr(), v.data_ptr(), f, block, SOLVERS[solver], lr,
                 b1, b2, 1.0 - b1, 1.0 - b2, eps, momentum, beta,
                 float(step), stream)
    if err != 0:
        raise RuntimeError(f"ps_aggregate kernel launch failed: "
                           f"cudaError_t {err}")
    if not probe:
        launches += 1
    return params, m, v
