#!/usr/bin/env python3
"""The knee of a serving cell: the highest arrival rate the engine
sustains without a growing backlog, found once by a sweep on the chip.

    python3 bench/sweep.py --workload <name> --rates 2,3,4,5 \
        [--seconds 30] [--seed 1] [--measure-tuning]

For each rate the cell runs as ``bench/run.py`` runs it, at that rate.
A backlog grows when the engine's queue, sampled every half second,
is longer in the window's last third than in its first (mean over
each third: more than 2 and more than 1.5 times), or when a request
does not come back; the knee is the highest rate without either. The
median latency of the last third's requests over the first third's is
printed beside it. ``--measure-tuning`` runs the first rate once more with the
tuner measuring its candidates (``DLAAS_AUTOTUNE_MEASURE=1``) on an empty
cache and no tuning in set-up, and reports how many tunings its window
ran. One JSON line a
rate, then the knee.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--measure-tuning", action="store_true")
    args = ap.parse_args(argv)
    from bench.common import CACHE_DIR, benchmark_spec, cache_env, cell
    spec = benchmark_spec()
    workload, config, mix = cell(spec, args.workload)
    os.environ.update(cache_env())
    os.environ.update(mix.get("env", {}))
    import torch
    from bench.runners import Ctx
    from bench.runners import engine_serve
    rates = [float(r) for r in args.rates.split(",")]
    runs = [(r, {}) for r in rates]
    if args.measure_tuning:
        runs.append((rates[0], {
            "DLAAS_AUTOTUNE_MEASURE": "1",
            "DLAAS_AUTOTUNE_CACHE": str(CACHE_DIR / "sweep-measured.json")}))
        try:
            os.unlink(runs[-1][1]["DLAAS_AUTOTUNE_CACHE"])
        except OSError:
            pass
    knee = None
    for rate, env in runs:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        m = copy.deepcopy(mix)
        m["rate_per_s"] = rate
        if env:
            m["tune_in_setup"] = False
        ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=False,
                  workload=workload, config=config, mix=m,
                  limits={"off_best_pct": float("inf")}, device="cuda")
        t = time.time()
        run = engine_serve.run(ctx)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rec = run.record
        lat, dues = rec["latencies_s"], rec["dues_s"]
        third = args.seconds / 3
        first = [l for l, d in zip(lat, dues) if d < third]
        last = [l for l, d in zip(lat, dues) if d >= 2 * third]
        growth = statistics.median(last) / statistics.median(first)
        q = rec["queue_depth"]
        q1 = statistics.mean(d for t, d in q if t < third)
        q3 = statistics.mean(d for t, d in q if t >= 2 * third)
        ok = run.failed == 0 and not (q3 > 2 and q3 > 1.5 * q1)
        line = {"rate_per_s": rate, "env": env, "ok": ok,
                "queue_first_third": q1, "queue_last_third": q3,
                "latency_growth": growth, "failed": run.failed,
                "attempted": run.attempted, **run.end_to_end,
                "decode_step_ms": 1e3 * rec["decode_seconds"]
                / max(1, rec["decode_steps"]),
                "occupancy": rec["occupied_slot_steps"]
                / max(1, rec["decode_steps"] * rec["capacity"]),
                "tunings_in_window": rec["tunings_in_window"],
                "notes": run.notes, "seconds": time.time() - t,
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if not env and ok:
            knee = rate if knee is None else max(knee, rate)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
