"""Public kernel entry points of the port.

Each op picks its path from where its tensors lie, and from nothing
else: a CPU tensor goes to the plain PyTorch version (``ref.py``), a
CUDA tensor to the hand-written kernel, which either launches or raises.
There is no ``try`` that falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

KERNELS = (_fa,)      # every kernel module: NAME, SOURCE, REPLACES, launches


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Softmax attention with scale hd^-0.5 and f32 accumulation; GQA heads
    by index (KV head = h // (H // KV)); causal masking lets query i see
    keys j <= i + q_offset. Any Sq/Sk."""
    devs = {q.device.type, k.device.type, v.device.type}
    if devs == {"cpu"}:
        _fa.check_shapes(q, k, v, q_offset)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    if devs == {"cuda"}:
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        q_offset=q_offset)
    raise ValueError(f"flash_attention: q/k/v on {sorted(devs)}; want all "
                     "on the CPU (plain version) or all on CUDA (kernel)")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {m.NAME: m.launches for m in KERNELS}


def reset_launch_counts() -> None:
    for m in KERNELS:
        m.launches = 0
