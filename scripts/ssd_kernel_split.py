#!/usr/bin/env python3
"""Time K5, the port's SSD chunked scan, on the card and split its time by
device kernel.

    python3 scripts/ssd_kernel_split.py [--src DIR] [--label NAME]
        [--shape B S H P G N CHUNK]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so one command can time two trees on one card, e.g. a parent
commit unpacked with ``git archive`` into a git-ignored directory beside
the change. Prints the card's name and power limit, then one JSON line:
the mean device time of one bf16 ``ops.ssd_scan`` call over 50
back-to-back calls (CUDA events), and each device kernel's mean time and
launches per call from ``torch.profiler`` over as many calls, with its
registers, shared memory and spills from nvcc's ptxas report (kept beside
the built library). The inputs follow tests/test_kernels.py:47-51, made
on the card from seed 0. The default shape is the mamba2-1.3b serve's
largest prefill (2, 2048). Needs a CUDA card and nvcc; exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def mangled_as(mangled: str, name: str) -> bool:
    """Whether a mangled kernel name is ``name`` (e.g. ``f<128>``,
    ``f<__nv_bfloat16>``, ``f<float>``) of an anonymous namespace."""
    base, _, targ = name.partition("<")
    targ = targ.rstrip(">")
    code = {"float": "f", "": ""}.get(
        targ, f"Li{targ}E" if targ.isdigit() else f"{len(targ)}{targ}")
    return f"{len(base)}{base}" + (f"I{code}E" if code else "E") in mangled


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--shape", type=int, nargs=7,
                    default=[2, 2048, 64, 64, 1, 128, 256],
                    metavar=("B", "S", "H", "P", "G", "N", "CHUNK"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_kernel_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    B, S, H, P, G, N, chunk = args.shape
    dt_, iters = torch.bfloat16, 50
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (0.5 * torch.randn(B, S, H, P, generator=g, device="cuda")).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device="cuda"))
    a_log = torch.zeros(H, device="cuda")
    b = (0.3 * torch.randn(B, S, G, N, generator=g, device="cuda")).to(dt_)
    c = (0.3 * torch.randn(B, S, G, N, generator=g, device="cuda")).to(dt_)

    def call():
        return ops.ssd_scan(x, dt, a_log, b, c, chunk=chunk)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "ssd_" in e.name:
            name = e.name.replace("(anonymous namespace)::", "") \
                .split("(")[0].removeprefix("void ").strip()
            us, n = kernels.get(name, (0.0, 0))
            kernels[name] = (us + e.time_range.elapsed_us(), n + 1)
    ptxas = build.ptxas_report(build.build_all(["ssd_scan"])["ssd_scan"].log)
    split = []
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        rep = next((r for k, r in ptxas.items() if mangled_as(k, name)), {})
        split.append({"kernel": name, "ms_per_call": us / 1e3 / iters,
                      "launches_per_call": n / iters, **rep})
    print(json.dumps({"label": args.label, "card": card,
                      "shape": dict(zip("B S H P G N chunk".split(),
                                        args.shape)),
                      "dtype": "bfloat16", "ms": ms,
                      "profiled_ms": sum(s["ms_per_call"] for s in split),
                      "split": split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
