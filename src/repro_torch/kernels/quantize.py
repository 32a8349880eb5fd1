"""Wrappers of the hand-written CUDA int8 wire kernels
(``csrc/quantize.cu``): K2 ``quantize_ef``, the port of the Pallas TPU
kernel ``repro/kernels/quantize.py:_quant_kernel``, and K3
``dequantize``, the port of ``_dequant_kernel``.

Each wrapper checks what its kernel takes, allocates outputs with
``torch.empty`` (or writes into the buffer it is handed), launches on the
current stream and raises if the launch is refused. Both kernels live in
one source, so each has its own record (``QUANTIZE``, ``DEQUANTIZE``)
with the ``NAME``/``SOURCE``/``REPLACES``/``launches`` that ``ops.py``
lists. ``block`` is the launch shape, the values each thread block
handles, a multiple of 256 up to ``MAX_BLOCK`` (``kernels/autotune.py``
chooses it; the default is ``grid.fit_block``'s, as the reference's
``quantize_ef(block=4096)``); every block gives the same bits. The
tuner's probes (``probe=True``) leave ``launches`` as it is. Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid import fit_block

LIB = "quantize"
SOURCE = "src/repro_torch/kernels/csrc/quantize.cu"
QBLOCK = 256
DEFAULT_BLOCK = 4096  # requested of fit_block (the reference's default)
MAX_BLOCK = 8192      # 32 warps of one 256-block each: 1,024 threads
X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _Kernel:
    """One kernel of ``csrc/quantize.cu`` and its launch count."""

    def __init__(self, name: str, replaces: str):
        self.NAME = name
        self.SOURCE = SOURCE
        self.REPLACES = replaces
        self.launches = 0


QUANTIZE = _Kernel("quantize_ef", "src/repro/kernels/quantize.py:22")
DEQUANTIZE = _Kernel("dequantize", "src/repro/kernels/quantize.py:63")
_fns = {}


def _entry(symbol: str, argtypes):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(LIB), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check_flat(name: str, t, dtypes, n=None):
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if n is not None and t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} values, want {n}")


def check_quantize(x, err):
    """Rules shared by K2 and its plain version."""
    _check_flat("x", x, tuple(X_DTYPE_CODES))
    _check_flat("err", err, (torch.float32,), x.numel())
    if x.numel() == 0 or x.numel() % QBLOCK:
        raise ValueError(f"length {x.numel()} is not a positive multiple "
                         f"of {QBLOCK}")


def check_dequantize(q, scales, out=None):
    """Rules shared by K3 and its plain version."""
    _check_flat("q", q, (torch.int8,))
    if q.numel() == 0 or q.numel() % QBLOCK:
        raise ValueError(f"length {q.numel()} is not a positive multiple "
                         f"of {QBLOCK}")
    _check_flat("scales", scales, (torch.float32,), q.numel() // QBLOCK)
    if out is not None:
        _check_flat("out", out, (torch.float32,), q.numel())


def _block(f: int, block) -> int:
    """``block``, or without one ``fit_block(f, 4096, 256)``; raises on a
    block the kernels do not take."""
    block = (fit_block(f, DEFAULT_BLOCK, multiple=QBLOCK) if block is None
             else int(block))
    if block % QBLOCK or not QBLOCK <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of {QBLOCK} in "
                         f"[{QBLOCK}, {MAX_BLOCK}], got {block}")
    return block


def _cuda_device(*ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("the int8 wire kernels want every tensor on one "
                         "CUDA device, got "
                         + "/".join(str(t.device) for t in ts))
    return dev


def quantize_ef_cuda(x, err, out_err=None, *, block=None,
                     probe: bool = False):
    """K2: (q int8 (F,), scales f32 (F/256,), new_err f32 (F,)). new_err
    is written into ``out_err`` when given (``err`` itself for the
    in-place update the PS client uses), else into a new tensor.
    ``block``: values per thread block (None: the default); ``probe``: a
    tuning probe, which ``launches`` leaves out."""
    check_quantize(x, err)
    block = _block(x.numel(), block)
    if out_err is None:
        out_err = torch.empty_like(err)
    else:
        _check_flat("out_err", out_err, (torch.float32,), x.numel())
    dev = _cuda_device(x, err, out_err)
    n = x.numel()
    q = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(n // QBLOCK, dtype=torch.float32, device=dev)
    fn = _entry("quantize_ef", [ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 4
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), X_DTYPE_CODES[x.dtype], err.data_ptr(),
                q.data_ptr(), scales.data_ptr(), out_err.data_ptr(), n,
                block, stream)
    if rc != 0:
        raise RuntimeError(f"quantize_ef kernel launch failed: "
                           f"cudaError_t {rc}")
    if not probe:
        QUANTIZE.launches += 1
    return q, scales, out_err


def dequantize_cuda(q, scales, out=None, *, block=None,
                    probe: bool = False):
    """K3: x = q * scale per 256-block, f32 (F,), written into ``out``
    when given (e.g. a PS receive row), else into a new tensor.
    ``block`` and ``probe`` as K2's."""
    check_dequantize(q, scales, out)
    block = _block(q.numel(), block)
    if out is None:
        out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    dev = _cuda_device(q, scales, out)
    fn = _entry("dequantize", [ctypes.c_void_p] * 3
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.numel(),
                block, stream)
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: "
                           f"cudaError_t {rc}")
    if not probe:
        DEQUANTIZE.launches += 1
    return out
