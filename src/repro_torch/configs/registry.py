"""Architecture registry — ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs import (
    kimi_k2_1t_a32b, grok_1_314b, stablelm_1_6b, minitron_8b, qwen1_5_110b,
    granite_20b, mamba2_1_3b, whisper_large_v3, jamba_1_5_large_398b,
    qwen2_vl_2b,
)

_MODULES = (
    kimi_k2_1t_a32b, grok_1_314b, stablelm_1_6b, minitron_8b, qwen1_5_110b,
    granite_20b, mamba2_1_3b, whisper_large_v3, jamba_1_5_large_398b,
    qwen2_vl_2b,
)

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(sorted(REGISTRY))


def get_arch(arch_id: str) -> ArchConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}"
        ) from None
