#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the pjit distribution: stablelm-1.6b at
full width and depth through ``PjitBackend``, preempted and resumed from
its checkpoint; the sharded step on a 1-rank NCCL mesh) alone on the
card.

    python3 scripts/pjit_phase.py

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.train_pjit``. Needs a CUDA card and nvcc; exits 2 without a
card. The sharded step across ranks is tested on the CPU with gloo:
``PYTHONPATH=src python -m pytest tests/test_torch_dist_steps.py``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("pjit_phase")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops, ref
    k4, k4b, launches = smoke.train_pjit(torch, ops, ref, kfa, kfab, card)
    print(f"[pjit] {card}: main-path launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
