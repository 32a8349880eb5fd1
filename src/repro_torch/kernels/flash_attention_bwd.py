"""Wrapper of the hand-written CUDA flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``). The JAX package has no Pallas kernel
for it: it replaces the plain-jnp custom VJP ``_flash_vjp_bwd`` of
``repro/models/attention.py:232``.

The C entry point picks the instance as the forward does: bf16 at hd
64, 112 and 128 on the tensor cores (``flash_bwd_dq_tc_kernel``,
``flash_bwd_dkv_tc_kernel``), everything else on the CUDA cores. The
wrapper checks what the kernel takes (for the tensor-core instance,
16-byte aligned rows), allocates dq/dk/dv and the delta scratch with
``torch.empty``, launches on the current stream and raises if the launch
is refused. One call launches the kernel's two
passes (dq, then dk/dv) and counts as one launch in ``launches``
(``launches_tc`` counts those on the tensor-core instance). Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa

NAME = "flash_attention_bwd"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/models/attention.py:232"

# K4b's instances; hd 112 (kimi-k2) runs the hd-128 tiles with columns
# 112..127 zero-filled, as K4's does
HEAD_DIMS = (16, 32, 64, 112, 128)

launches = 0          # kernel launches in this process (see ops.py)
launches_tc = 0       # of them, on the tensor-core instance
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load(NAME).flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_shapes(q, k, v, o, lse, do, q_offset: int):
    """Shape rules shared by the kernel and its plain version: those of
    the forward, o and do shaped as q, lse (B, H, Sq)."""
    _fa.check_shapes(q, k, v, q_offset)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq):
        raise ValueError(f"lse shape {tuple(lse.shape)} != (B, H, Sq) = "
                         f"{(B, H, Sq)}")


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool,
                             q_offset: int = 0):
    """(dq, dk, dv) on CUDA tensors; raises on anything the kernel does
    not take (no fallback to the plain version)."""
    global launches, launches_tc
    check_shapes(q, k, v, o, lse, do, q_offset)
    dev = q.device
    ts = {"q": q, "k": k, "v": v, "o": o, "do": do}
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd_cuda wants every tensor on "
                         "one CUDA device")
    if q.dtype not in _fa.DTYPE_CODES or any(t.dtype != q.dtype
                                             for t in ts.values()):
        raise TypeError("flash_attention_bwd kernel takes float32 or "
                        "bfloat16 q/k/v/o/do of one dtype, got "
                        + "/".join(str(t.dtype) for t in ts.values()))
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32 (B, H, Sq)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"K4b (flash_attention_bwd) has no instance at "
                         f"head_dim {hd}: it takes {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    for name, t in ts.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim "
                             f"(stride {t.stride(3)})")
    tc = _fa.uses_tensor_cores(q)
    if tc:
        _fa.check_tensor_core_rows(ts)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _fa.DTYPE_CODES[q.dtype], B, Sq, Sk, H, KV, hd, strides,
                 int(bool(causal)), int(q_offset), float(hd ** -0.5),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_tc += tc
    return dq, dk, dv
