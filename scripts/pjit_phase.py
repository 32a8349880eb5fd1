#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the pjit distribution: stablelm-1.6b at
full width and depth through ``PjitBackend``, preempted and resumed from
its checkpoint onto a 1-rank mesh, in a rank process; the sharded step on
a 1-rank NCCL mesh) alone on the card.

    python3 scripts/pjit_phase.py
    python3 scripts/pjit_phase.py --two-ranks-on-one-card

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.train_pjit``. Needs a CUDA card and nvcc; exits 2 without a
card. The sharded step across ranks is tested on the CPU with gloo:
``PYTHONPATH=src python -m pytest tests/test_torch_dist_steps.py``.

``--two-ranks-on-one-card`` instead starts two processes on ``cuda:0``,
joins them in one NCCL group through a ``FileStore`` and all-reduces one
tensor; it prints what each rank saw (its error, or the sum), one JSON
object a rank. This is why the card runs the gang's rank processes at
one rank.
"""
from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def one_of_two_ranks(rank: int, store: str) -> int:
    import torch
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    try:
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(store, 2), rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=60))
        t = torch.ones(1, device="cuda")
        tdist.all_reduce(t)
        torch.cuda.synchronize()
        print(json.dumps({"rank": rank, "sum": float(t)}), flush=True)
    except Exception as e:     # the observation is the error itself
        print(json.dumps({"rank": rank, "error": type(e).__name__,
                          "message": str(e)[:600]}), flush=True)
    return 0


def two_ranks_on_one_card(timeout: float = 120.0) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + f"\nno report in {timeout} s"
            print(f"--- rank {r}, exit {p.returncode}:\n{out.strip()}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return one_of_two_ranks(int(sys.argv[2]), sys.argv[3])
    torch, card = smoke.phase_setup("pjit_phase")
    if sys.argv[1:] == ["--two-ranks-on-one-card"]:
        return two_ranks_on_one_card()
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops, ref
    k4, k4b, launches = smoke.train_pjit(torch, ops, ref, kfa, kfab, card)
    print(f"[pjit] {card}: main-path launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
