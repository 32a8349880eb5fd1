#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone on the card: kimi-k2 at full width
(one of its 61 layers) served with K4 at head dim 112, ``moe_block``
against ``moe_ref`` at k = 8, the expert-parallel prefill and decode
steps on a 1-rank NCCL mesh against the mesh-less steps (kimi-k2's and
grok-1's weights), and K4 at kimi-k2's prefill shapes.

    python3 scripts/ep_phase.py

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.serve_kimi``. Needs a CUDA card and nvcc; exits 2 without a
card. The expert-parallel paths across ranks are tested on the CPU with
gloo: ``PYTHONPATH=src:tests python -m pytest tests/test_torch_moe_ep.py``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("ep_phase")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    _, _, launches, ep, _ = smoke.serve_kimi(torch, ops, ref, kfa, card)
    print(f"[kimi] {card}: phase 21 in {time.perf_counter() - t0:.1f} s; "
          f"the cold serve's launches {launches}; expert-parallel "
          f"differences {ep}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
