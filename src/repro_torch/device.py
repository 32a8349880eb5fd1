"""Device resolution for the port's entry points.

Entry points run on the card. ``device=None`` means CUDA; a caller that
wants the CPU (the tests) says so with ``device="cpu"``. There is no
fallback: asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when CUDA is asked
    for (explicitly or by default) and ``torch.cuda.is_available()`` is
    false, instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
