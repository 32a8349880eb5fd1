#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` (the paper's PS solvers at full width
with 4 learners on the card, K1-K3 at the solvers' shapes, K4/K4b at the
per-rank shapes of zero3_sp's sequence parallelism, and the zero3_sp
train step of qwen2-vl-2b on a 1-rank NCCL mesh) alone on the card.

    python3 scripts/solvers_phase.py

Builds the kernels, prints the card's name and power limit, then runs
``chip_smoke.train_solvers``, the K1-K3 timings, ``chip_smoke.sp_kernels``
and ``chip_smoke.sp_step`` on freshly drawn qwen2-vl-2b weights (in
``chip_smoke.py`` the step takes phase 18's trained weights). Needs a
CUDA card and nvcc; exits 2 without a card. The solvers and the
sequence-parallel step across ranks are tested on the CPU with gloo:
``PYTHONPATH=src:tests python -m pytest tests/test_torch_solvers.py
tests/test_torch_sp.py``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    torch, card = smoke.phase_setup("solvers_phase")
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import flash_attention_bwd as kfab
    from repro_torch.kernels import ops, ref
    from repro_torch.models import make_model
    t0 = time.perf_counter()
    launches, f = smoke.train_solvers(torch, ops, kfa, kfab, card)
    print(f"[solvers] {card}: main-path launches {launches}")
    k1 = smoke.time_ps_aggregate(torch, ops, ref, smoke.SOLVER_LEARNERS, f)
    print(f"[kernel] {card}: K1 at the solvers' (L, F): {json.dumps(k1)}")
    torch.cuda.empty_cache()
    k2, k3 = smoke.time_quantize(torch, ops, ref, f, torch.float32)
    print(f"[kernel] {card}: K2 at the solvers' push: {json.dumps(k2)}")
    print(f"[kernel] {card}: K3 at the solvers' push: {json.dumps(k3)}")
    torch.cuda.empty_cache()
    smoke.sp_kernels(torch, ops, ref, card)
    model = make_model(get_arch(smoke.VLM_ARCH))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    launches = smoke.sp_step(torch, ops, kfa, kfab, params, card)
    print(f"[train-sp] {card}: main-path launches {launches}")
    print(f"[phase] 20 solvers, zero3_sp: "
          f"{time.perf_counter() - t0:.1f} s wall")
    return 0


if __name__ == "__main__":
    sys.exit(main())
