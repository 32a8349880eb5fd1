#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone on the card: the paper's fault
tolerance through the port's ``DLaaSCore`` on ``cuda``, stablelm-1.6b at
full width cut to 4 of 24 layers. a. an uninterrupted training; b. a core
process (``chip_smoke.py --drill-child``) SIGKILLed after its first
checkpoint and recovered by a fresh core here (the training's losses and
the endpoint's tokens against a's and the child's); c. CRASH_CORE at
step 6 recovered in this process, the zombie's parameter server freed;
d. the node under two PS learners killed at step 6; e. the node under
a serving endpoint killed with a request queued. Every drill checks its
kernel launches and that device memory returns to the phase's baseline.

    python3 scripts/drills_phase.py

Builds the kernels and prints the card's name and power limit first.
Needs a CUDA card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("drills_phase")
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    launches = smoke.drills_phase(torch, ops, card)
    print(f"[drills] {card}: phase 24 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"drills": {k: v for k, v in launches.items() if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
