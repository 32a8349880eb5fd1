"""Wrapper of the hand-written CUDA Mamba-2 SSD chunked scan
(``csrc/ssd_scan.cu``), the port of the Pallas TPU kernel
``repro/kernels/ssd_scan.py:_ssd_kernel``.

The wrapper picks the instance from dtype and widths: bf16 at P 64 and
N 64 or 128 (mamba2-1.3b, jamba) runs on the tensor cores (``wgmma``,
the ``ssd_*_tc`` kernels), float32 at any width and bf16 at other widths
on the CUDA cores. It checks what the instance takes (for the
tensor-core one, 16-byte aligned x, b and c), allocates the outputs and
one scratch workspace with ``torch.empty``, launches on the current
stream and raises if a launch is refused. ``launches`` counts the calls
that launched the kernel, ``launches_tc`` those of them that ran the
tensor-core instance. Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_tensor_core_rows

NAME = "ssd_scan"
SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:23"
MAX_CHUNK = 256       # one block scans a chunk's cumulative decay
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 at this head dim and these state widths runs on the tensor cores
TENSOR_CORE_HEAD_DIM = 64
TENSOR_CORE_STATE_DIMS = (64, 128)
CUDA_CORES, TENSOR_CORES = 0, 1      # the C entry point's `instance`

launches = 0          # kernel launches in this process (see ops.py)
launches_tc = 0       # of them, on the tensor-core instance
_fns = None


def _entry():
    """(ssd_scan_fwd, ssd_scan_workspace_bytes) of the built library."""
    global _fns
    if _fns is None:
        lib = build.load(NAME)
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [
            ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 8
        ws.restype = ctypes.c_int64
        _fns = fn, ws
    return _fns


def check_shapes(x, dt, a_log, b, c, chunk: int):
    """Shape rules shared by the kernel and its plain version: x (B, S,
    H, P), dt (B, S, H), a_log (H,), b/c (B, S, G, N) with H % G == 0,
    S >= 1, chunk >= 1."""
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or \
            b.dim() != 4 or c.dim() != 4:
        raise ValueError("ssd_scan wants x (B, S, H, P), dt (B, S, H), "
                         "a_log (H,), b/c (B, S, G, N)")
    B, S, H, _ = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log "
                         f"{tuple(a_log.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (B, S):
        raise ValueError(f"b/c shapes {tuple(b.shape)}/{tuple(c.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if b.shape[2] < 1 or H % b.shape[2]:
        raise ValueError(f"H={H} is not a multiple of G={b.shape[2]}")
    if S < 1 or chunk < 1:
        raise ValueError(f"ssd_scan needs S >= 1 and chunk >= 1, got S={S}"
                         f", chunk={chunk}")


def instance(x, b) -> int:
    """TENSOR_CORES for bf16 x at P 64 with N 64 or 128, else
    CUDA_CORES: a choice by dtype and widths alone."""
    if x.dtype == torch.bfloat16 and x.shape[3] == TENSOR_CORE_HEAD_DIM \
            and b.shape[3] in TENSOR_CORE_STATE_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def ssd_scan_cuda(x, dt, a_log, b, c, *, chunk: int):
    """Launch the kernel on CUDA tensors; returns (y (B, S, H, P) in x's
    dtype, state (B, H, P, N) f32). Raises on anything it does not take
    (no fallback to the plain version or to the other instance)."""
    global launches, launches_tc
    check_shapes(x, dt, a_log, b, c, chunk)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, a_log, b, c)):
        raise ValueError("ssd_scan_cuda wants every tensor on one CUDA "
                         "device")
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x/b/c "
                        f"of one dtype, got {x.dtype}/{b.dtype}/{c.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 dt, got {dt.dtype}")
    if a_log.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 a_log, "
                        f"got {a_log.dtype}")
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel wants contiguous {name} "
                             f"(strides {t.stride()})")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} exceeds the kernel's {MAX_CHUNK}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    inst = instance(x, b)
    if inst == TENSOR_CORES:
        check_tensor_core_rows({"x": x, "b": b, "c": c})
    fn, ws_bytes = _entry()
    nbytes = ws_bytes(inst, B, S, H, P, G, N, Q)
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 b.data_ptr(), c.data_ptr(), y.data_ptr(), state.data_ptr(),
                 ws.data_ptr(), nbytes, DTYPE_CODES[x.dtype],
                 DTYPE_CODES[a_log.dtype], inst, B, S, H, P, G, N, Q,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    launches_tc += inst == TENSOR_CORES
    return y, state
