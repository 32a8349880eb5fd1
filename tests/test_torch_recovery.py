"""The port's durable control plane: the crash drill, idempotent
submission, REST recovery with the ``Idempotency-Key`` header, pending
keys settled and an endpoint re-deployed after a crash, the counterparts
of tests/test_recovery.py's end-to-end cases run through the port's
``DLaaSCore`` (``repro_torch.service.core``) on the CPU."""
import json
import urllib.request

import pytest

from repro_torch.platform.faults import FaultEvent
from repro_torch.platform.zookeeper import NoNodeError
from repro_torch.service.core import DLaaSCore
from repro_torch.service.rest import DLaaSServer
from util_poll import wait_until

MANIFEST = """
name: parity
learners: 1
gpus: 1
memory: 512MiB
steps: 300
lr: 0.2
checkpoint_every: 50
framework:
  name: repro-mlp
  d_in: 16
  n_classes: 4
"""


def _core(workdir):
    return DLaaSCore(workdir=str(workdir), device="cpu")


def _wait_terminal(core, tid, timeout=90):
    assert wait_until(
        lambda: core.lcm.job_state(tid) in ("COMPLETED", "FAILED"),
        timeout=timeout), f"job stuck in {core.lcm.job_state(tid)}"
    return core.lcm.job_state(tid)


def test_crash_recovery_drill_with_loss_parity(tmp_path):
    """SIGKILL-equivalent core teardown mid-training; a fresh core on the
    same workdir replays the journal, the job completes via
    checkpoint-resume with the final loss of an uninterrupted same-seed
    run (rel 1e-6, as the reference's drill), billing carries over, and
    replayed Idempotency-Keys return the original ids."""
    base = _core(tmp_path / "base")
    mid = base.deploy_model(MANIFEST)["model_id"]
    tid = base.create_training(mid, user="alice")["training_id"]
    assert _wait_terminal(base, tid) == "COMPLETED"
    base_loss = base.training_status(tid)["last_loss"]
    base.close()

    wd = tmp_path / "crash"
    c1 = _core(wd)
    mid1 = c1.deploy_model(MANIFEST, idempotency_key="dep-1")["model_id"]
    tid1 = c1.create_training(mid1, user="alice",
                              idempotency_key="sub-1")["training_id"]
    c1.inject_faults(events=[FaultEvent("crash_core", "",
                                        at_step=120, job_id=tid1)])
    assert wait_until(lambda: c1.crashed, timeout=60), "crash never fired"
    pre_usage = dict(c1.usage)
    pre_gpu_s = c1.scheduler.tenant_snapshots().get(
        "alice", {}).get("gpu_seconds", 0.0)

    c2 = _core(wd)
    rep = c2.recovery_report()
    assert rep["recovered"]
    assert tid1 in (rep["trainings"]["resumed"]
                    + rep["trainings"]["requeued"])
    assert rep["trainings"]["abandoned"] == []
    assert c2.usage == pre_usage
    post_gpu_s = c2.scheduler.tenant_snapshots().get(
        "alice", {}).get("gpu_seconds", 0.0)
    assert post_gpu_s >= pre_gpu_s - 1e-6
    assert c2.deploy_model(MANIFEST,
                           idempotency_key="dep-1")["model_id"] == mid1
    assert c2.create_training(mid1, user="alice",
                              idempotency_key="sub-1")[
        "training_id"] == tid1
    assert c2.usage == pre_usage
    assert len(c2.list_trainings()) == 1

    assert _wait_terminal(c2, tid1) == "COMPLETED"
    loss = c2.training_status(tid1)["last_loss"]
    assert loss == pytest.approx(base_loss, rel=1e-6), (loss, base_loss)
    # the relaunch planned through _ctx: on the core's device, and its
    # parameter server was freed at COMPLETED like a first launch's
    plan = c2.trainings[tid1]["plan"]
    assert wait_until(lambda: plan.meta["ps"] is None, timeout=10)
    assert c2.training_status(tid1)["data_plane"]["agg_rounds"] > 0
    counters = c2.metrics.counters("platform")
    assert counters["recoveries_total"] >= 1
    assert counters["recovery_journal_records"] > 0
    c2.close()


def test_endpoint_redeploys_after_crash(tmp_path):
    """A READY endpoint returns to READY on the recovered core and
    answers a predict with the same tokens."""
    wd = tmp_path / "w"
    c1 = _core(wd)
    eid = c1.deploy_endpoint(arch="stablelm-1.6b", user="bob",
                             idempotency_key="ep-1")["endpoint_id"]
    assert wait_until(
        lambda: c1.endpoint_status(eid)["state"] == "READY", timeout=60)
    out1 = c1.predict(eid, [1, 2, 3], max_new=4)
    c1.crash()

    c2 = _core(wd)
    assert eid in c2.recovery_report()["endpoints"]["redeployed"]
    assert wait_until(
        lambda: c2.endpoint_status(eid)["state"] == "READY", timeout=60)
    out2 = c2.predict(eid, [1, 2, 3], max_new=4)
    assert out2["tokens"]
    assert out2["tokens"] == out1["tokens"]
    assert c2.endpoints[eid].engine.device.type == "cpu"
    assert c2.deploy_endpoint(arch="stablelm-1.6b", user="bob",
                              idempotency_key="ep-1")[
        "endpoint_id"] == eid
    assert len(c2.endpoints) == 1
    c2.close()


def test_idempotent_submission_no_duplicates(tmp_path):
    """Same key == same job, exactly one submission, exactly one bill —
    and a NEW key still creates a new job."""
    core = _core(tmp_path / "w")
    mid = core.deploy_model(MANIFEST)["model_id"]
    r1 = core.create_training(mid, user="alice", idempotency_key="k")
    usage_after_first = core.usage["alice"]
    r2 = core.create_training(mid, user="alice", idempotency_key="k")
    assert r2["training_id"] == r1["training_id"]
    assert core.usage["alice"] == usage_after_first
    assert len(core.list_trainings()) == 1
    r3 = core.create_training(mid, user="alice", idempotency_key="k2")
    assert r3["training_id"] != r1["training_id"]
    assert core.metrics.counters("platform")[
        "idempotent_replays_total"] >= 1
    for tid in (r1["training_id"], r3["training_id"]):
        _wait_terminal(core, tid)
    core.close()


def test_rest_api_recovery_and_idempotency_header(tmp_path):
    """Idempotency-Key rides the HTTP header; GET /v1/recovery reports."""

    def req(url, method="GET", body=None, key=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(url, data=data, method=method)
        r.add_header("Authorization", "Bearer alice")
        if key:
            r.add_header("Idempotency-Key", key)
        if data:
            r.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(r) as resp:
            return json.loads(resp.read())

    with DLaaSServer(str(tmp_path / "w"), device="cpu") as srv:
        out = req(f"{srv.url}/v1/models", "POST",
                  {"manifest": MANIFEST}, key="m-1")
        out2 = req(f"{srv.url}/v1/models", "POST",
                   {"manifest": MANIFEST}, key="m-1")
        assert out2["model_id"] == out["model_id"]
        t1 = req(f"{srv.url}/v1/trainings", "POST",
                 {"model_id": out["model_id"]}, key="t-1")
        t2 = req(f"{srv.url}/v1/trainings", "POST",
                 {"model_id": out["model_id"]}, key="t-1")
        assert t2["training_id"] == t1["training_id"]
        rec = req(f"{srv.url}/v1/recovery")
        assert rec == {"recovered": False}
        _wait_terminal(srv.core, t1["training_id"])


def test_recovery_settles_pending_idempotency_keys(tmp_path):
    """A key left 'pending' by a crash completes on recovery when its
    job record landed, and is dropped when it did not."""
    wd = tmp_path / "w"
    c1 = _core(wd)
    mid = c1.deploy_model(MANIFEST)["model_id"]
    tid = c1.create_training(mid, user="alice",
                             idempotency_key="settled")["training_id"]
    c1.zk.set(c1._idem_path("settled"), json.dumps(
        {"key": "settled", "kind": "training", "id": tid,
         "status": "pending"}).encode())
    c1.zk.create(c1._idem_path("orphan"), json.dumps(
        {"key": "orphan", "kind": "training", "id": "training-99999",
         "status": "pending"}).encode(), makepath=True)
    c1.crash()

    c2 = _core(wd)
    idem = c2.recovery_report()["idempotency"]
    assert idem["completed"] == 1 and idem["dropped"] == 1
    assert c2.create_training(mid, user="alice",
                              idempotency_key="settled")[
        "training_id"] == tid
    with pytest.raises(NoNodeError):
        c2.zk.get(c2._idem_path("orphan"))
    _wait_terminal(c2, tid)
    c2.close()
