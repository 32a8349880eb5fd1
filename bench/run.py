#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
correctness limits are found by name (``BENCHMARK.json``,
``bench/configs/``, ``bench/mixes/``, ``bench/limits/``); the mix names
the runner that runs it (``bench/runners/``). The run loads, warms up,
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``bench/metrics/<name>.py``. The numbers
compared, each beside its limit, are the last lines on standard error
and the last key of the JSON line.

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, without the program (``src/repro_torch``), or
when JAX or the JAX package was loaded in this process.
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


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(spec, workload: str, trace: bool):
    """The metrics this cell reports in this kind of run."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def execute(ctx, spec, chips: int):
    """Run the cell's runner; the result line's dict and the checks."""
    import importlib

    from bench.common import BENCH, load_module
    runner = importlib.import_module(f"bench.runners.{ctx.mix['runner']}")
    run = runner.run(ctx)
    values = {}
    rec = dict(run.record)
    for m in metrics_of(spec, ctx.workload["name"], ctx.trace):
        if ctx.trace:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{len(values)}")
            v = reader.read(rec)
        else:
            v = run.end_to_end.get(m["name"])
            if v is None:
                raise RuntimeError(f"the runner gave no {m['name']}")
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": _device_name(ctx.device),
              "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": values, "device": device}
    tr = rec.get("trace")
    if ctx.trace and tr:
        from bench.trace import breakdown
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = breakdown(tr)
    if rec.get("card") is not None:
        out["card"] = rec["card"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out, run


def _device_name(device) -> str:
    import torch
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "cpu"


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir() \
            or not (ROOT / "BENCHMARK.json").is_file():
        print("the program (src/repro_torch) or BENCHMARK.json is missing",
              file=sys.stderr)
        return 2
    from bench.common import cache_env, cell, forbidden_loaded, load_json
    from bench.common import BENCH, benchmark_spec
    spec = benchmark_spec()
    workload, config, mix = cell(spec, args.workload)
    limits = load_json(BENCH / "limits" / f"{args.workload}.json")
    os.environ.update(cache_env())
    os.environ.update(mix.get("env", {}))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < workload["chips"]:
        print(f"needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from bench.runners import Ctx
    ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              workload=workload, config=config, mix=mix, limits=limits,
              device="cuda", t_start=T_START)
    out, run = execute(ctx, spec, workload["chips"])
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for note in run.notes:
        print(note, file=sys.stderr)
    if "card" in out:
        print(f"card {json.dumps(out['card'])}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
