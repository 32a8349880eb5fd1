#!/usr/bin/env python3
"""Serve a family's chip_smoke configuration on the card and print its
prefill and decode times, so that two trees can be compared in one
command.

    python3 scripts/serve_times.py [--root DIR] [--label NAME]
        [--family ssm,dense,moe] [--runs 3]

Loads ``chip_smoke.py`` from ``--root`` (default: this checkout), which
puts that tree's ``src`` first on the path, and for each family of
``--family`` (default ``ssm``) runs its serve ``--runs`` times in one
process, the first cold, through ``chip_smoke.serve`` with that tree's
configuration: ``dense`` full-width StableLM-1.6B with ``SERVE_REQUESTS``
(phase 4); ``ssm`` full-width mamba2-1.3b with ``SSM_REQUESTS`` (phase
5); ``moe`` grok-1 at full width cut to ``MOE_SERVE_LAYERS`` layers
(phase 15). Random weights from seed 0, 4 slots.
Prints the card's name and power limit, then one JSON line per run: the
prefill batches (n, plen) with their host milliseconds (the engine's
prefill span, which ends after the first tokens reach the host),
decode milliseconds per step, output tokens per second and the launch
counts. Needs a CUDA card and nvcc; exits 2 without a card. A parent
commit unpacked with ``git archive`` into a git-ignored directory
serves as ``--root`` for the other side.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path


def configs(smoke, get_arch):
    """family -> (config, requests, max_seq) of ``smoke``'s serves."""
    return {
        "dense": lambda: (get_arch(smoke.SERVE_ARCH), smoke.SERVE_REQUESTS,
                          1024),
        "ssm": lambda: (get_arch(smoke.SSM_ARCH), smoke.SSM_REQUESTS,
                        smoke.SSM_MAX_SEQ),
        "moe": lambda: (dataclasses.replace(get_arch(smoke.MOE_ARCH),
                                            n_layers=smoke.MOE_SERVE_LAYERS),
                        smoke.SERVE_REQUESTS, 1024),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--family", default="ssm")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_times: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.root).resolve() / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke      # its dataclasses look it up
    spec.loader.exec_module(smoke)
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops
    card = smoke.card_line()
    print(card)
    by_family = configs(smoke, get_arch)
    for family in args.family.split(","):
        cfg, requests, max_seq = by_family[family]()
        for run in range(args.runs):
            tokens, eng, rec, launches, wall, _ = smoke.serve(
                torch, cfg, ops, 0, card, requests=requests,
                max_seq=max_seq)
            st = eng.stats()
            print(json.dumps({
                "label": args.label, "family": family, "run": run,
                "card": card,
                "prefill_ms": [[n, plen, 1e3 * s] for (n, plen), s in
                               zip(rec.prefills, rec.prefill_s)],
                "decode_ms_per_step": 1e3 * eng.decode_seconds /
                st["decode_steps"],
                "tokens_per_s": st["tokens_out_total"] / wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": launches}), flush=True)
            eng.release()
            del eng, tokens
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
