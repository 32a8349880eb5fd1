"""Wrapper of the hand-written CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py:_flash_kernel``.

The C entry point picks the instance by dtype and head dim: bf16 at hd
64, 112 and 128 runs on the tensor cores (``wgmma``,
``flash_fwd_kernel_tc``), float32 and bf16 at hd 16/32 on the CUDA cores
(``flash_fwd_kernel``). Head dim 112 (kimi-k2) runs the hd-128 tiles of
either instance with columns 112..127 zero-filled as each tile is loaded
and the scale 112^-0.5; the wrapper pads nothing.
The wrapper checks what the kernel takes (for the tensor-core instance,
16-byte aligned rows), allocates the output with ``torch.empty``,
launches on the current stream and raises if the launch is refused.
``launches`` counts the launches, so a run can show that its main path
went through the kernel, and ``launches_tc`` those of them on the
tensor-core instance; the tuner's probes (``probe=True``) move neither.
``block_q`` is the launch shape, the query rows a thread block owns:
64 or 128 (one or two warpgroups) on the tensor-core instance, which
``kernels/autotune.py`` chooses between; the CUDA-core instance has one,
its tile's (``launch_shapes``). Every block_q gives the same bits.
Nothing is built or loaded at import time; the first call builds the
library (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:23"
HEAD_DIMS = (16, 32, 64, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 at these head dims runs on the tensor cores (wgmma), whose 16-byte
# copies need aligned rows; every other case runs on the CUDA cores
TENSOR_CORE_HEAD_DIMS = (64, 112, 128)
# (block_q, block_k) a launch may take: the tensor-core instance one or
# two warpgroups of 64 rows over key tiles of 64, the first its default;
# the CUDA-core instance its tile at each head dim (Tile<HD>: kBq, kBk)
TC_SHAPES = ((128, 64), (64, 64))
CUDA_CORE_SHAPES = {16: (128, 64), 32: (128, 64), 64: (64, 64),
                    112: (32, 32), 128: (32, 32)}

launches = 0          # kernel launches in this process (see ops.py)
launches_tc = 0       # of them, on the tensor-core instance
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load(NAME).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_shapes(q, k, v, q_offset: int):
    """Shape rules shared by the kernel and its plain version:
    q (B, Sq, H, hd), k/v (B, Sk, KV, hd), H % KV == 0, q_offset >= 0."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants 4-D q/k/v (B, S, H, hd)")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[2]}")
    if k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one key")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def uses_tensor_cores(q) -> bool:
    """Whether the C entry point runs the tensor-core instance for ``q``
    (bf16 at a head dim of ``TENSOR_CORE_HEAD_DIMS``)."""
    return q.dtype == torch.bfloat16 and q.shape[3] in TENSOR_CORE_HEAD_DIMS


def launch_shapes(dtype, hd: int):
    """The (block_q, block_k) launches of the instance that runs q of
    ``dtype`` at head dim ``hd``, its default first; () where no
    instance takes them."""
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return TC_SHAPES
    if dtype in DTYPE_CODES and hd in CUDA_CORE_SHAPES:
        return (CUDA_CORE_SHAPES[hd],)
    return ()


def check_tensor_core_rows(named):
    """The tensor-core instance copies 16-byte chunks of each row: every
    tensor's data pointer must be 16-byte aligned and its (B, S, H)
    strides multiples of 8 elements. Raises rather than copying."""
    for name, t in named.items():
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: the bf16 tensor-core kernel needs 16-byte aligned "
                f"rows (data_ptr % 16 == 0, strides multiples of 8), got "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}")


def flash_attention_cuda(q, k, v, *, causal: bool, q_offset: int = 0,
                         return_lse: bool = False, block_q=None,
                         probe: bool = False):
    """Launch the kernel on CUDA tensors; raises on anything it does not
    take (no fallback to the plain version). With ``return_lse`` it
    returns (o, lse) with the row log-sum-exp lse (B, H, Sq) f32.
    ``block_q``: one of ``launch_shapes`` (None: the default);
    ``probe``: a tuning probe, which the launch counts leave out."""
    global launches, launches_tc
    check_shapes(q, k, v, q_offset)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda wants q/k/v on one CUDA "
                         f"device, got {q.device}/{k.device}/{v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim "
                             f"(stride {t.stride(3)})")
    tc = uses_tensor_cores(q)
    if tc:
        check_tensor_core_rows({"q": q, "k": k, "v": v})
    shapes = launch_shapes(q.dtype, hd)
    block_q = shapes[0][0] if block_q is None else int(block_q)
    if block_q not in [bq for bq, _ in shapes]:
        raise ValueError(f"block_q {block_q} is not a launch of the "
                         f"{'tensor' if tc else 'CUDA'}-core instance "
                         f"(one of {shapes})")
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if Sq == 0 or B == 0:
        return (o, lse) if return_lse else o
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 DTYPE_CODES[q.dtype], B, Sq, Sk, H, KV, hd, block_q,
                 strides, int(bool(causal)), int(q_offset),
                 float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    if not probe:
        launches += 1
        launches_tc += tc
    return (o, lse) if return_lse else o
