"""scripts/verify.sh's crash-recovery drill against the port on the CPU: a
core subprocess (``repro_torch.service.core.DLaaSCore``, ``device="cpu"``)
serves an endpoint and trains a ``repro-lm`` smoke manifest, is paused
after its first checkpoint and killed with SIGKILL (no shutdown hook
runs); a fresh core over the same workdir replays the journal and
recovers. The recovered training's final loss equals an uninterrupted
run's at rel 1e-6 (the reference drill's tolerance), the endpoint gives
the tokens it gave before the kill, a replayed Idempotency-Key returns
the original training, and the recovered timeline holds a ``recovery``
event under the persisted trace id."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.service.core import DLaaSCore
from util_poll import wait_until

SRC = Path(__file__).resolve().parents[1] / "src"
MANIFEST = {
    "name": "sigkill-lm", "learners": 1, "steps": 24, "checkpoint_every": 4,
    "lr": 2e-3, "optimizer": "sgd", "seed": 3, "batch_docs": 2,
    "ps_shards": 2, "data": {"n_docs": 128, "seq_len": 32},
    "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
PROMPT = [1, 2, 3]

CHILD = r'''
import json, pathlib, sys, time
from repro_torch.service.core import DLaaSCore

workdir, manifest = sys.argv[1], sys.argv[2]
core = DLaaSCore(workdir, tick_interval=0.005, device="cpu")
eid = core.deploy_endpoint(arch="stablelm-1.6b", max_new=2,
                           idempotency_key="drill-ep")["endpoint_id"]
t0 = time.time()
while core.endpoint_status(eid)["state"] != "READY":
    if time.time() - t0 > 120:
        raise SystemExit("child: endpoint never READY")
    time.sleep(0.02)
pre = core.predict(eid, [1, 2, 3], max_new=2)["tokens"]
mid = core.deploy_model(manifest)["model_id"]
tid = core.create_training(mid, user="alice",
                           idempotency_key="drill-sub")["training_id"]
t0 = time.time()
while not core.metrics.checkpoints(tid):
    if time.time() - t0 > 120:
        raise SystemExit("child: no checkpoint landed")
    time.sleep(0.01)
core.pause_training(tid)     # hold mid-flight so the kill is mid-job
ckpts = pathlib.Path(workdir, "ckpt", tid)
while not any(not p.name.endswith(".tmp") for p in ckpts.glob("step_*")):
    time.sleep(0.01)         # published: the kill cuts no write of it
tmp = pathlib.Path(workdir, "marker.tmp")   # the parent reads it whole
tmp.write_text(json.dumps(
    {"tid": tid, "eid": eid, "mid": mid, "pre_tokens": pre}))
tmp.rename(pathlib.Path(workdir, "marker.json"))
time.sleep(600)              # the parent SIGKILLs us here
'''


def _final_loss(core, tid):
    assert core.wait_for(tid, timeout=240) == "COMPLETED"
    return core.training_status(tid)["last_loss"]


def test_sigkilled_core_recovers_on_its_workdir(tmp_path):
    base = DLaaSCore(str(tmp_path / "base"), device="cpu")
    try:
        mid = base.deploy_model(json.dumps(MANIFEST))["model_id"]
        base_loss = _final_loss(
            base, base.create_training(mid)["training_id"])
    finally:
        base.close()

    workdir = tmp_path / "crash"
    workdir.mkdir()
    marker = workdir / "marker.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with open(tmp_path / "child.log", "wb") as out:
        child = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(workdir),
             json.dumps(MANIFEST)], env=env, stdout=out,
            stderr=subprocess.STDOUT)
    try:
        assert wait_until(lambda: marker.exists() or
                          child.poll() is not None, timeout=180), \
            "the child wrote no marker"
        assert marker.exists(), (tmp_path / "child.log").read_text()[-3000:]
        ids = json.loads(marker.read_text())
        os.kill(child.pid, signal.SIGKILL)       # no shutdown hook runs
        assert child.wait(60) == -signal.SIGKILL
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)

    core = DLaaSCore(str(workdir), tick_interval=0.005, device="cpu")
    try:
        rep = core.recovery_report()
        tid, eid = ids["tid"], ids["eid"]
        assert rep["recovered"]
        assert tid in rep["trainings"]["resumed"] + \
            rep["trainings"]["requeued"]
        assert eid in rep["endpoints"]["redeployed"]
        assert core.create_training(ids["mid"], user="alice",
                                    idempotency_key="drill-sub")[
            "training_id"] == tid
        assert core.deploy_endpoint(arch="stablelm-1.6b",
                                    idempotency_key="drill-ep")[
            "endpoint_id"] == eid
        assert _final_loss(core, tid) == pytest.approx(base_loss, rel=1e-6)
        assert tid in rep["trainings"]["resumed"]
        assert any(line.startswith("resumed from checkpoint step=")
                   for line in core.training_logs(tid))
        assert wait_until(
            lambda: core.endpoint_status(eid)["state"] == "READY",
            timeout=120)
        assert core.predict(eid, PROMPT, max_new=2)["tokens"] == \
            ids["pre_tokens"]
        tl = core.training_timeline(tid)
        assert "recovery" in [s["name"] for s in tl["spans"]]
        rec = core._zget(f"/dlaas/jobs/{tid}/record")
        assert tl["trace_id"] == rec["trace_id"]
    finally:
        core.close()
