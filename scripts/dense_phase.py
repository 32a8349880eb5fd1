#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone on the card: the dense family's
three archs that no other phase runs, at full width in bf16 with random
weights from seed 0. minitron-8b (GQA 4, vocab 256,000) and granite-20b
(48 query heads on one KV head) are served at full depth, qwen1.5-110b
(QKV bias) cut to 8 of its 80 layers. For each arch: K4/K4b at its
shapes against their plain versions, the 8 requests of phase 4 through
``InferenceEngine``, prefill against decode at 2 layers in f32, AdamW
steps through ``steps.build_train_step``, the smoke step on the card
against the CPU (granite and minitron), and device memory back at the
phase's baseline once the arch is freed.

    python3 scripts/dense_phase.py

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
    torch, card = smoke.phase_setup("dense_phase")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    _, _, launches = smoke.dense_archs_phase(torch, ops, ref, kfa, kfab,
                                             card)
    print(f"[dense] {card}: phase 25 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"dense_archs": {k: v for k, v in launches.items()
                                      if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
