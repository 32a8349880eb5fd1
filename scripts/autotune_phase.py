#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone on the card: the launch-shape
tuner (``src/repro_torch/kernels/autotune.py``) from a fresh cache at the
main paths' K1-K4 shapes, every candidate's outputs against the
default's bit for bit, its time at the full shape beside the default's
and the bound, the second lookups (hits, no probe launch), the
exporter's three ``dlaas_autotune_cache_*`` families and the
small-block counter of a ``DLaaSCore``.

    python3 scripts/autotune_phase.py

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.autotune_phase`` at the shapes ``chip_smoke.autotune_shapes``
names (the PS shard and push lengths and the solvers' F computed from
the configurations). Needs a CUDA card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("autotune_phase")
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    lengths = smoke.autotune_lengths()
    res = smoke.autotune_phase(torch, card, smoke.autotune_shapes(*lengths))
    print(f"[autotune] {card}: phase 22 in {time.perf_counter() - t0:.1f} "
          f"s ({autotune.probe_launches} probe launches, "
          f"{autotune.tuning_seconds:.3f} s measuring)")
    print(json.dumps({k: {f: r[f] for f in ("choice", "default",
                                             "choice_ms", "default_ms",
                                             "bound_ms")}
                      for k, r in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
