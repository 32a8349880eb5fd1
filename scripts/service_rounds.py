#!/usr/bin/env python3
"""What the service's control path costs a training round, on one card.

    python3 scripts/service_rounds.py

Runs ``chip_smoke.py``'s phase 9 (``platform``: the manifest planned by
the software-ps backend and ticked by a loop on the main thread) and its
phase 10 (``service``: the same manifest through the port's REST server,
whose ``DLaaSCore`` ticks on its own thread every 20 ms and runs the
health controller), and phase 10 with the health controller unhooked
from the scheduler (``service-nohealth``), in turns:

    platform, service, service-nohealth, service-nohealth, service,
    platform

each at phase 8's 2 x 512 traffic on StableLM-1.6B at full width cut to
12 layers. Prints the card's name and power limit, then one JSON line
per turn: the median round (ms, between the ends of consecutive PS
rounds), every round, and launch (platform) or submit (service) ->
COMPLETED seconds. Needs one CUDA card; builds the kernels first.

    python3 scripts/service_rounds.py --pairs 10

instead trains only (no endpoint), 12 steps with one checkpoint at the
end, in N pairs of ``service`` and ``service-nohealth`` in ABBA order,
and ends with a summary line: each side's median of the turns' median
rounds, their quartiles, and how many pairs each side won.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

TURNS = ("platform", "service", "service-nohealth", "service-nohealth",
         "service", "platform")


def run_turn(torch, ops, cfg, label, card):
    from repro_torch.service import rest
    workdir = Path(tempfile.mkdtemp(prefix=f"service-rounds-{label}-",
                                    dir=ROOT / "build"))
    server = rest.DLaaSServer
    try:
        if label == "platform":
            out, _ = cs.platform_train(torch, ops, cfg, workdir, card)
            return {"turn": label, "round_ms": out["round_ms"],
                    "to_completed_s": out["wall_s"]}

        class Server(server):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                if label == "service-nohealth":
                    self.core.scheduler.health_controller = None
        rest.DLaaSServer = Server
        out, _ = cs.service_run(torch, cfg, workdir)
        return {"turn": label, "round_ms": out["round_ms"],
                "to_completed_s": out["train_s"]}
    finally:
        rest.DLaaSServer = server
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()


def train_only(torch, cfg, label):
    """One ``--pairs`` turn: the phase 10 manifest at 12 steps with one
    checkpoint, trained through a fresh REST server to COMPLETED."""
    from repro_torch.platform.cluster import Cluster, Node, Resources
    from repro_torch.service.rest import DLaaSServer
    m = dict(cs.PLATFORM_MANIFEST, steps=12, checkpoint_every=12)
    workdir = Path(tempfile.mkdtemp(prefix=f"service-rounds-{label}-",
                                    dir=ROOT / "build"))
    cluster = Cluster([Node("node-0", Resources(
        cpus=32.0, gpus=cs.PLATFORM_GPUS, memory_mb=96 * 1024))])
    try:
        with DLaaSServer(str(workdir), device="cuda",
                         arch_cfgs={cs.SERVE_ARCH: cfg},
                         cluster=cluster) as srv:
            if label == "service-nohealth":
                srv.core.scheduler.health_controller = None
            stamps = cs.stamp_rounds(srv.core.metrics)
            mid = cs.http(f"{srv.url}/v1/models", "POST",
                          {"manifest": cs.manifest_yaml(m)})["model_id"]
            t0 = time.perf_counter()
            tid = cs.http(f"{srv.url}/v1/trainings", "POST",
                          {"model_id": mid})["training_id"]
            t_launched = time.perf_counter()
            st = cs.poll(lambda: cs.http(f"{srv.url}/v1/trainings/{tid}"),
                         lambda s: s["status"] in ("COMPLETED", "FAILED",
                                                   "KILLED"), 900, tid)
            if st["status"] != "COMPLETED":
                raise AssertionError(f"{tid}: {st}")
            return {"turn": label, "round_ms": [
                1e3 * (b - a) for a, b in
                zip([t_launched] + stamps[:-1], stamps)],
                "to_completed_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()


def quartiles(xs):
    xs = sorted(xs)
    return [xs[len(xs) // 4], xs[len(xs) // 2], xs[(3 * len(xs)) // 4]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("service_rounds: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build, ops
    card = cs.card_line()
    print(card)
    (ROOT / "build").mkdir(exist_ok=True)
    build.build_all()
    cfg = dataclasses.replace(get_arch(cs.SERVE_ARCH),
                              n_layers=cs.TRAIN_ARCH_LAYERS)
    if not args.pairs:
        for label in TURNS:
            res = run_turn(torch, ops, cfg, label, card)
            rounds = sorted(res["round_ms"])
            res["median_round_ms"] = rounds[len(rounds) // 2]
            res["card"] = card
            print(json.dumps(res), flush=True)
        return 0
    sides = ("service", "service-nohealth")
    medians = {side: [] for side in sides}
    wins = dict.fromkeys(sides, 0)
    for i in range(args.pairs):
        order = sides if i % 2 == 0 else sides[::-1]
        pair = {}
        for label in order:
            res = train_only(torch, cfg, label)
            rounds = sorted(res["round_ms"][1:])    # not the first
            res["median_round_ms"] = rounds[len(rounds) // 2]
            res["pair"], res["card"] = i, card
            print(json.dumps(res), flush=True)
            pair[label] = res["median_round_ms"]
            medians[label].append(res["median_round_ms"])
        if pair[sides[0]] != pair[sides[1]]:
            wins[min(pair, key=pair.get)] += 1
    print(json.dumps({"summary": {
        side: {"median_of_medians_ms": quartiles(medians[side])[1],
               "quartiles_ms": quartiles(medians[side]),
               "pairs_won": wins[side]} for side in sides},
        "pairs": args.pairs, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
