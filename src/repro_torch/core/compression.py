"""Gradient compression: int8 block quantization with error feedback
(counterpart of ``repro/core/compression.py``).

Used on the parameter-server push path: the pushed vector is quantized
per block of 256 values with an f32 scale (wire format int8 + scales,
~4x fewer bytes than f32); the quantization residual is carried in an
error-feedback buffer so the compression is unbiased over time (Seide et
al. style).

``quantize_int8``, ``dequantize_int8`` and ``compress_with_feedback``
are the plain PyTorch scheme (``kernels/ref.py``, any device).
``make_compressor`` builds the push-path compressor, which goes through
``kernels.ops.quantize_ef``: K2 on CUDA tensors, the plain version on
CPU tensors. ``CompressedPush`` is the wire format the software PS
moves; its ``q`` and ``scales`` are tensors on the learner's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (QBLOCK, dequantize_ref,
                                     quantize_blocks)

BLOCK = QBLOCK


@dataclass(frozen=True)
class CompressedPush:
    """Wire format of a compressed PS push: int8 payload + one f32 scale
    per block, ~4x fewer bytes than the dense f32 vector."""
    q: torch.Tensor         # int8, padded length (multiple of BLOCK)
    scales: torch.Tensor    # f32, len(q) // BLOCK
    dense_nbytes: int       # size of the vector this stands in for

    @property
    def wire_nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scales.numel() * self.scales.element_size())


def pad_to_block(n: int, block: int = BLOCK) -> int:
    return -(-n // block) * block


def quantize_int8(x, block: int = BLOCK):
    """x (N,) with N % block == 0 -> (q int8 (N,), scale f32 (N/block,))."""
    return quantize_blocks(x, block)


def dequantize_int8(q, scale, block: int = BLOCK):
    return dequantize_ref(q, scale, block)


def compress_with_feedback(x, err, block: int = BLOCK):
    """Quantize (x + err); return (q, scale, new_err, wire_view).

    ``wire_view`` is the dequantized value that actually travels; the
    residual goes back into the feedback buffer."""
    y = x.float() + err
    q, scale = quantize_int8(y, block)
    wire = dequantize_int8(q, scale, block)
    return q, scale, y - wire, wire


def wire_bytes(n: int, block: int = BLOCK) -> int:
    """Bytes on the wire for an n-element compressed push."""
    return n + 4 * (n // block)


def make_compressor():
    """The push-path compressor ``fn(x, err, out_err=None) -> (q, scales,
    new_err)``: K2 on CUDA tensors, the plain version on CPU tensors.
    ``x`` (f32 or bf16) must be a multiple of ``BLOCK`` long, which the
    PS shard layout guarantees. ``new_err`` goes into ``out_err`` when
    given (``err`` itself for an in-place update), else into a new
    tensor."""
    def compress(x, err, out_err=None):
        return ops.quantize_ef(x, err, out_err=out_err)
    return compress
