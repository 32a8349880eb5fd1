"""The control: the plain reference computed in fp8 (the precision below
the configurations' bf16) put in the program's place. At the cells' own
size on the card it has to come out as not correct against each cell's
limits (``bench/calibrate.py`` reads it on three seeds or more); on the
CPU at tiny width it has to read well above the program."""
import json
import math
import subprocess
import sys

import pytest
import torch

from bench.common import BENCH, ROOT, benchmark_spec, load_json
from bench.runners import Ctx, engine_serve, ps_train
from bench.tests import tiny

SEED = 2 ** 31 + 11


def _ctx(workload, config, mix, limits):
    w = next(w for w in benchmark_spec()["workloads"] if w["name"] ==
             workload)
    return Ctx(seed=SEED, seconds=1.0, trace=False, workload=w,
               config=config, mix=mix, limits=limits, device="cpu",
               control=True)


def test_train_control_reads_above_the_program():
    run = ps_train.run(_ctx(
        "train-stablelm-ps-4k", tiny.config("stablelm-2-1.6b-L12"),
        tiny.train_mix(), dict.fromkeys(
            ("loss_rel_gap", "grad1_norm_gap", "grad1_diff",
             "change_norm_gap"), math.inf)))
    prog = {k: v for k, (v, _) in run.checks.items()}
    ctrl = run.extra["control_fp8"]
    assert any(ctrl[k] > 3 * prog[k] for k in prog), (prog, ctrl)
    half = run.extra["fault_half_batch"]
    assert half["grad1_norm_gap"] > 10 * prog["grad1_norm_gap"], half


def test_serve_control_reads_above_the_program():
    mix = tiny.serve_mix()
    mix["check_requests"] = 1000        # every finished request
    run = engine_serve.run(_ctx(
        "serve-grok-chat", tiny.config("grok-1-L4"), mix,
        {"off_best_pct": math.inf}))
    ctrl = run.extra["control_fp8"]["off_best_pct"]
    prog = run.checks["off_best_pct"][0]
    assert ctrl > max(3 * prog, 0.01), run.notes


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      benchmark_spec()["workloads"]])
def test_control_is_not_correct_at_the_cells_size(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cells run at full width")
    out = tmp_path / "calib.jsonl"
    res = subprocess.run(
        [sys.executable, "bench/calibrate.py", "--workload", workload,
         "--seeds", str(SEED), "--control-seeds", str(SEED),
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(out.read_text().splitlines()[-1])
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    assert all(v <= limits[k] for k, v in line["program"].items()
               if k in limits), line
    assert any(v > limits[k] for k, v in line["control_fp8"].items()), line
