#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (the hybrid family, Jamba-1.5-Large at
full width) alone on the card.

    python3 scripts/hybrid_phase.py

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.serve_hybrid``: one period of 4 layers served by three
engines, prefill against decode at 2 layers in f32, K4 and K5 at the
serve's prefill shapes against their plain versions, and the jamba
smoke-width learner step on the card against the CPU. Needs a CUDA card
and nvcc; exits 2 without a card. The hybrid cases of the CUDA tests
run apart: ``python -m pytest -q -m cuda -k "hybrid or jamba"
tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("hybrid_phase")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as kssd
    smoke.serve_hybrid(torch, ops, ref, kfa, kssd, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
