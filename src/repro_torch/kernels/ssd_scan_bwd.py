"""Wrapper of the hand-written CUDA backward of the Mamba-2 SSD chunked
scan (``csrc/ssd_scan_bwd.cu``, K5b). JAX has no kernel for it: it
differentiates the jnp ``_ssd_inner`` (``repro/models/mamba.py:91``).

The wrapper picks the instance from dtype and widths, as K5's does
(``ssd_scan.instance``): bf16 at P 64 and N 64 or 128 (mamba2-1.3b,
jamba) runs on the tensor cores (``wgmma``, the ``ssd_bwd_*_tc``
kernels), float32 at any width and bf16 at other widths on the CUDA
cores. That is a choice of design, not a fallback: if the named instance
does not build or launch, the call raises. The wrapper checks what the
instance takes (for the tensor-core one, 16-byte aligned x, b, c and
dy), allocates the gradients and one scratch workspace with
``torch.empty``, launches on the current stream and raises if a launch
is refused. ``launches`` counts the calls that launched the kernel,
``launches_tc`` those of them that ran the tensor-core instance. Nothing
is built or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.flash_attention import check_tensor_core_rows

NAME = "ssd_scan_bwd"
SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
REPLACES = "src/repro/models/mamba.py:91"
DTYPE_CODES = _ssd.DTYPE_CODES

launches = 0          # kernel launches in this process (see ops.py)
launches_tc = 0       # of them, on the tensor-core instance
_fns = None


def _entry():
    """(ssd_scan_bwd, ssd_scan_bwd_workspace_bytes) of the built
    library."""
    global _fns
    if _fns is None:
        lib = build.load(NAME)
        fn = lib.ssd_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int64] + [
            ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.ssd_scan_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 8
        ws.restype = ctypes.c_int64
        _fns = fn, ws
    return _fns


def check_shapes(x, dt, a_log, b, c, dy, dstate, chunk: int):
    """K5's shape rules, plus dy of x's shape and dstate None or (B, H,
    P, N)."""
    _ssd.check_shapes(x, dt, a_log, b, c, chunk)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    B, _, H, P = x.shape
    want = (B, H, P, b.shape[3])
    if dstate is not None and tuple(dstate.shape) != want:
        raise ValueError(f"dstate {tuple(dstate.shape)}, want {want}")


def ssd_scan_bwd_cuda(x, dt, a_log, b, c, dy, dstate=None, *, chunk: int):
    """Launch the kernel on CUDA tensors; returns (dx, ddt f32, da_log,
    db, dc), each other gradient in its input's dtype. Raises on anything
    it does not take (no fallback to the plain version or to the other
    instance)."""
    global launches, launches_tc
    check_shapes(x, dt, a_log, b, c, dy, dstate, chunk)
    ts = {"x": x, "dt": dt, "a_log": a_log, "b": b, "c": c, "dy": dy}
    if dstate is not None:
        ts["dstate"] = dstate
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        raise ValueError("ssd_scan_bwd_cuda wants every tensor on one CUDA "
                         "device")
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype
                                         for t in (b, c, dy)):
        raise TypeError(f"ssd_scan_bwd kernel takes float32 or bfloat16 "
                        f"x/b/c/dy of one dtype, got {x.dtype}/{b.dtype}/"
                        f"{c.dtype}/{dy.dtype}")
    if dt.dtype != torch.float32 or (dstate is not None and
                                     dstate.dtype != torch.float32):
        raise TypeError("ssd_scan_bwd kernel takes float32 dt and dstate")
    if a_log.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_scan_bwd kernel takes float32 or bfloat16 "
                        f"a_log, got {a_log.dtype}")
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd kernel wants contiguous {name} "
                             f"(strides {t.stride()})")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, S)
    if Q > _ssd.MAX_CHUNK:
        raise ValueError(f"chunk {Q} exceeds the kernel's {_ssd.MAX_CHUNK}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    inst = _ssd.instance(x, b)
    if inst == _ssd.TENSOR_CORES:
        check_tensor_core_rows({"x": x, "b": b, "c": c, "dy": dy})
    fn, ws_bytes = _entry()
    nbytes = ws_bytes(inst, B, S, H, P, G, N, Q)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    da_log = torch.empty_like(a_log)
    db = torch.empty_like(b)
    dc = torch.empty_like(c)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                 dstate.data_ptr() if dstate is not None else None,
                 dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
                 db.data_ptr(), dc.data_ptr(), ws.data_ptr(), nbytes,
                 DTYPE_CODES[x.dtype], DTYPE_CODES[a_log.dtype], inst, B, S,
                 H, P, G, N, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    launches_tc += inst == _ssd.TENSOR_CORES
    return dx, ddt, da_log, db, dc
