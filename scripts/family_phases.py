#!/usr/bin/env python3
"""Phases 17 and 18 of ``chip_smoke.py`` (whisper-large-v3 and
qwen2-vl-2b's ``embeds`` at full width and depth through the model-level
steps) alone on the card.

    python3 scripts/family_phases.py [--only encdec|vlm]

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.train_encdec`` and ``chip_smoke.train_vlm``: four AdamW
steps on one batch, prefill and greedy decode, prefill against decode at
2 layers in f32, K4 and K4b at the family's attention shapes against
their plain versions and SDPA, and the smoke-width step on the card
against the CPU. Needs a CUDA card and nvcc; exits 2 without a card. The
CUDA tests of these families run apart: ``python -m pytest -q -m cuda
-k "whisper or qwen or family or encdec" tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("encdec", "vlm"))
    args = ap.parse_args()
    torch, card = smoke.phase_setup("family_phases")
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops, ref
    if args.only in (None, "encdec"):
        smoke.train_encdec(torch, ops, ref, kfa, kfab, card)
        torch.cuda.empty_cache()
    if args.only in (None, "vlm"):
        smoke.train_vlm(torch, ops, ref, kfa, kfab, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
