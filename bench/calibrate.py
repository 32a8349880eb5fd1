#!/usr/bin/env python3
"""Readings that the correctness limits are set from, on the chip, in one
process:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 10] [--out FILE]

For every seed the cell runs as ``bench/run.py`` runs it (a short window
at the cell's own load), and its numbers compared are printed against
the f32 reference: the program's readings, of which the largest over a
dozen seeds is a limit's lower end. For the control seeds the control's
readings are printed too: the reference computed in fp8 in the
program's place (and, for training, with half of each batch left out),
each against the f32 reference; their smallest is a limit's upper end.
One JSON line a seed.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from bench.common import cache_env, cell, benchmark_spec
    spec = benchmark_spec()
    workload, config, mix = cell(spec, args.workload)
    os.environ.update(cache_env())
    os.environ.update(mix.get("env", {}))
    import importlib
    import torch
    from bench.runners import Ctx
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    runner = importlib.import_module(f"bench.runners.{mix['runner']}")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        ctx = Ctx(seed=seed, seconds=args.seconds, trace=False,
                  workload=workload, config=config, mix=mix,
                  limits={k: float("inf") for k in _limit_names(mix)},
                  device="cuda", control=seed in control)
        run = runner.run(ctx)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v for k, (v, _) in run.checks.items()},
                **run.extra, "end_to_end": run.end_to_end,
                "failed": run.failed, "notes": run.notes,
                "card_window": run.record.get("card"),
                "card": torch.cuda.get_device_name(0),
                "seconds": time.time() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run
        torch.cuda.empty_cache()
    return 0


def _limit_names(mix):
    return (("off_best_pct",) if mix["kind"] == "serve" else
            ("loss_rel_gap", "grad1_norm_gap", "grad1_diff",
             "change_norm_gap"))


if __name__ == "__main__":
    sys.exit(main())
