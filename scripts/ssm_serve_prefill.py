#!/usr/bin/env python3
"""Serve full-width mamba2-1.3b on the card and print its prefill time by
batch, so that two trees can be compared in one command.

    python3 scripts/ssm_serve_prefill.py [--root DIR] [--label NAME]
        [--runs 3]

Loads ``chip_smoke.py`` from ``--root`` (default: this checkout), which
puts that tree's ``src`` first on the path, and runs its ssm serve
(``chip_smoke.serve`` with ``SSM_REQUESTS``: 8 requests, prompts of 2,048
to 2 tokens, 4 slots, random weights from seed 0) ``--runs`` times in one
process, the first cold. Prints the card's name and power limit, then one
JSON line per run: the prefill batches (n, plen) with their host
milliseconds (the engine's prefill span, which ends after the first
tokens reach the host), decode milliseconds per step, output tokens per
second and the launch counts. Needs a CUDA card and nvcc; exits 2
without a card. A parent commit unpacked with ``git archive`` into a
git-ignored directory serves as ``--root`` for the other side.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_serve_prefill: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.root).resolve() / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    card = smoke.card_line()
    print(card)
    cfg = get_arch(smoke.SSM_ARCH)
    for run in range(args.runs):
        tokens, eng, rec, launches, wall, _ = smoke.serve(
            torch, cfg, ops, 0, card, requests=smoke.SSM_REQUESTS,
            max_seq=smoke.SSM_MAX_SEQ)
        st = eng.stats()
        print(json.dumps({
            "label": args.label, "run": run, "card": card,
            "prefill_ms": [[n, plen, 1e3 * s] for (n, plen), s in
                           zip(rec.prefills, rec.prefill_s)],
            "decode_ms_per_step": 1e3 * eng.decode_seconds /
            st["decode_steps"],
            "tokens_per_s": st["tokens_out_total"] / wall,
            "launches": launches}))
        eng.release()
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
