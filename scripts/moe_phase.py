#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (the moe family, grok-1 at full width)
alone on the card, then prefill against decode over several prompts.

    python3 scripts/moe_phase.py [--prompts 8] [--skip-phase]
        [--plain-attention]

Builds the kernels, runs ``chip_smoke.serve_moe`` (one layer's
``moe_block`` against ``moe_ref``, the 4-layer serve with three engines,
prefill against decode, K4 at the serve's shapes, the smoke step on the
card against the CPU; ``--skip-phase`` leaves it out), then, at full
width cut to 2 layers in f32 (random weights from seed 0), compares the
last-position logits of prefill(40) with prefill(39) + one decode step
for each of ``--prompts`` prompts ``1000 + 40 i .. 1039 + 40 i``. Prints
the card's name and power limit, then one JSON line per prompt: the
tokens of the dropped pairs by layer for both prefills and the decode,
whether the 40th token kept its pairs in every layer (the condition
under which the two paths compute the same function), and the relative
L2 of the two logits; with ``--plain-attention`` also that relative L2
with the prefills' attention in the plain version on the card in place
of K4 (which part of the two paths' difference is the kernel's). Needs
a CUDA card and nvcc; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--skip-phase", action="store_true")
    ap.add_argument("--plain-attention", action="store_true")
    args = ap.parse_args()
    torch, card = smoke.phase_setup("moe_phase")
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    if not args.skip_phase:
        smoke.serve_moe(torch, ops, ref, kfa, card)
        torch.cuda.empty_cache()
    cut = dataclasses.replace(get_arch(smoke.MOE_ARCH),
                              n_layers=smoke.MOE_CHECK_LAYERS,
                              dtype="float32")
    L = cut.n_layers
    for i in range(args.prompts):
        first = 1000 + 40 * i
        with smoke.counting_drops(moe) as seen:
            rel = smoke.prefill_vs_decode(torch, cut,
                                          list(range(first, first + 40)))
        dropped = [sorted(t.tolist()) for t in seen]
        extra = {}
        if args.plain_attention:
            kernel = ops.flash_attention
            ops.flash_attention = ref.flash_attention_ref
            try:
                extra["rel_l2_plain_attention"] = smoke.prefill_vs_decode(
                    torch, cut, list(range(first, first + 40)))
            finally:
                ops.flash_attention = kernel
        print(json.dumps({
            "card": card, "prompt": [first, first + 39],
            "dropped_tokens": {"prefill40": dropped[:L],
                               "prefill39": dropped[L:2 * L],
                               "decode": dropped[2 * L:]},
            "last_token_kept": dropped[:L] == dropped[L:2 * L],
            "rel_l2": rel, **extra, "limit": smoke.PREFILL_DECODE_RTOL}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
