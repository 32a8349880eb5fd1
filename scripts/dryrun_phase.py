#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone on the card: the dry-run child
(``run_cell`` of two production cells on a fake 512-rank group, and
phase 19 b's step counted on the meta device at remat none and full,
with no card visible), then that step on the card at both remat values,
its argument bytes held to the count to the byte and its temp bytes
within ``REMAT_TEMP_TOL``.

    python3 scripts/dryrun_phase.py

Builds the kernels, prints the card's name and power limit, starts the
child and runs ``chip_smoke.dryrun_phase``. Needs a CUDA card and nvcc;
exits 2 without a card. The dry-run alone needs no card:
``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --mesh
...``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("dryrun_phase")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    t0 = time.perf_counter()
    child = smoke.start_dryrun_child()
    launches = smoke.dryrun_phase(torch, kfa, kfab, card, child)
    print(f"[dryrun] {card}: phase 23 in {time.perf_counter() - t0:.1f} s "
          f"(the child not overlapped); train-pjit-remat launches "
          f"{launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
