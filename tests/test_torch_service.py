"""The port's service entry point: ``DLaaSCore``, the REST server and the
CLI of ``repro_torch.service``, against the reference's.

The REST cases of tests/test_service.py run against the port's server;
one ``repro-lm`` and one ``repro-mlp`` manifest train through both
packages' cores from one initial vector to the same ``last_loss`` and
``trained_model.npy`` (1e-4, the tolerance of
``test_training_through_the_backend_matches_jax``); a finished training
frees its parameter server; the two packages' log hubs each see only
their own job lines; a missed deadline is HTTP 504; endpoints deploy by
arch and refuse an ``repro-mlp`` training; and the core wants CUDA
unless it is given ``device="cpu"``.

All on the CPU (``device="cpu"``) at the reference's smoke sizes, each
server and core in its own ``tmp_path``."""
import io
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.runtime import learner as jax_learner
from repro.service.core import DLaaSCore as JaxCore
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.core.software_ps import SoftwareParameterServer
from repro_torch.observability.export import parse_prometheus_text
from repro_torch.platform.faults import FaultSchedule
from repro_torch.service import cli
from repro_torch.service.core import DLaaSCore
from repro_torch.service.rest import DLaaSServer
from repro_torch.serving.engine import InferenceEngine
from util_parity import use_jax_vector
from util_poll import wait_until

PARITY_TOL = dict(atol=1e-4, rtol=1e-4)

MANIFEST = """
name: my-mnist-model
version: "1.0"
description: tiny training job
learners: 2
gpus: 1
memory: 1024MiB
steps: 25
lr: 0.2
data_stores:
  - id: objectstore
    type: softlayer_objectstore
    training_data:
      container: my_training_data
    connection:
      auth_url: https://example/auth/v1.0
      user_name: u
      password: p
framework:
  name: repro-mlp
  d_in: 16
  n_classes: 4
"""

LM_MANIFEST = {
    "name": "parity-lm", "learners": 1, "steps": 6, "checkpoint_every": 3,
    "lr": 2e-3, "optimizer": "sgd", "seed": 3, "batch_docs": 2,
    "ps_shards": 2, "data": {"n_docs": 128, "seq_len": 32},
    "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
MLP_MANIFEST = {
    "name": "parity-mlp", "learners": 1, "steps": 10,
    "checkpoint_every": 5, "lr": 0.1, "optimizer": "sgd", "seed": 1,
    "batch_docs": 8, "ps_shards": 2,
    "framework": {"name": "repro-mlp", "d_in": 16, "n_classes": 4}}


@pytest.fixture(autouse=True)
def _quiet_jax_core(monkeypatch):
    # the reference's switches: no JobPerf thread, no XLA cache directory
    monkeypatch.setenv("DLAAS_PERF", "0")
    monkeypatch.setenv("DLAAS_JAX_CACHE", "0")


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method)
    r.add_header("Authorization", "Bearer tester")
    if data:
        r.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(r) as resp:
        raw = resp.read()
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def _terminal(core, tid, timeout=120):
    assert wait_until(
        lambda: core.lcm.job_state(tid) in ("COMPLETED", "FAILED",
                                            "KILLED"),
        timeout=timeout), f"job stuck in {core.lcm.job_state(tid)}"
    return core.lcm.job_state(tid)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("dlaas-torch"))
    with DLaaSServer(wd, device="cpu") as srv:
        yield srv


# ------------------------------------------ the reference's REST cases
def test_rest_four_step_flow(server):
    # (2) upload the model
    out = _req(f"{server.url}/v1/models", "POST", {"manifest": MANIFEST})
    mid = out["model_id"]
    got = _req(f"{server.url}/v1/models/{mid}")
    assert got["manifest"]["name"] == "my-mnist-model"
    # (3) create + monitor training
    out = _req(f"{server.url}/v1/trainings", "POST", {"model_id": mid})
    tid = out["training_id"]
    assert out["backend"] == "software-ps"
    assert server.core.wait_for(tid, timeout=90) == "COMPLETED"
    status = _req(f"{server.url}/v1/trainings/{tid}")
    assert status["steps_done"] >= 25
    assert status["data_plane"]["push_count"] == 2 * 25
    logs = _req(f"{server.url}/v1/trainings/{tid}/logs")["logs"]
    assert any("loss=" in line for line in logs)
    metrics = json.loads(urllib.request.urlopen(
        f"{server.url}/v1/trainings/{tid}/metrics").read())
    assert any(r["metric"] == "loss" for r in metrics)
    # (4) download the trained model
    blob = urllib.request.urlopen(
        f"{server.url}/v1/trainings/{tid}/model").read()
    arr = np.load(io.BytesIO(blob))
    assert arr.size > 0 and np.isfinite(arr).all()
    # metering counted our calls
    usage = _req(f"{server.url}/v1/usage")
    assert usage.get("tester", 0) > 0


def test_rest_rejects_bad_manifest(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{server.url}/v1/models", "POST",
             {"manifest": "framework:\n  version: 1\n"})
    assert ei.value.code == 400


def test_rest_overrides(server):
    out = _req(f"{server.url}/v1/models", "POST", {"manifest": MANIFEST})
    out = _req(f"{server.url}/v1/trainings", "POST",
               {"model_id": out["model_id"],
                "overrides": {"learners": 1, "steps": 5}})
    tid = out["training_id"]
    assert server.core.wait_for(tid, timeout=60) == "COMPLETED"
    assert server.core.training_status(tid)["steps_done"] >= 5


def test_rest_pjit_is_a_user_error(server):
    """``distribution: pjit`` resolves but is not ported: HTTP 400."""
    out = _req(f"{server.url}/v1/models", "POST", {"manifest": MANIFEST})
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{server.url}/v1/trainings", "POST",
             {"model_id": out["model_id"],
              "overrides": {"distribution": "pjit"}})
    assert ei.value.code == 400


def test_metrics_content_type_is_prometheus_004(server):
    with urllib.request.urlopen(f"{server.url}/metrics") as r:
        ctype = r.headers.get("Content-Type")
        body = r.read().decode()
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    fams = parse_prometheus_text(body)["families"]
    for name in ("dlaas_slo_burn_rate", "dlaas_slo_objective",
                 "dlaas_alerts_active", "dlaas_alerts_fired_total",
                 "dlaas_alerts_remediations_total", "dlaas_queue_depth",
                 "dlaas_journal_seq"):
        assert name in fams, name
    assert not any(n.startswith("dlaas_autotune") for n in fams)


def test_follow_streams_exit_early_on_terminal_job(server):
    out = _req(f"{server.url}/v1/models", "POST", {"manifest": MANIFEST})
    out = _req(f"{server.url}/v1/trainings", "POST",
               {"model_id": out["model_id"],
                "overrides": {"learners": 1, "steps": 5}})
    tid = out["training_id"]
    assert server.core.wait_for(tid, timeout=60) == "COMPLETED"
    for what, check in (("logs", lambda r: "line" in r or "seq" in r),
                        ("metrics", lambda r: "type" in r)):
        t0 = time.time()
        with urllib.request.urlopen(
                f"{server.url}/v1/trainings/{tid}/{what}"
                "?follow=1&max_s=30") as r:
            lines = [line for line in r.read().splitlines()
                     if line.strip()]
        elapsed = time.time() - t0
        assert elapsed < 10.0, \
            f"{what}?follow=1 on a terminal job took {elapsed:.1f}s"
        assert lines, f"{what} follow stream replayed nothing"
        for raw in lines:
            rec = json.loads(raw)
            assert isinstance(rec, dict) and check(rec)


def test_alerts_and_slo_endpoints(server):
    rep = _req(f"{server.url}/v1/alerts")
    assert set(rep) == {"active", "history", "remediations"}
    assert isinstance(rep["active"], list)
    slo = _req(f"{server.url}/v1/slo")
    assert isinstance(slo, list)
    for ev in slo:
        assert {"name", "kind", "scope", "firing",
                "burn", "windows"} <= set(ev)
    with urllib.request.urlopen(
            f"{server.url}/v1/alerts?follow=1&max_s=0.3") as r:
        lines = [json.loads(line) for line in r.read().splitlines()
                 if line.strip()]
    assert lines and lines[0]["type"] == "snapshot"
    assert "active" in lines[0]
    assert server.core.health.alerts._streams == []


def test_cli_against_live_server(server, tmp_path):
    mf = tmp_path / "m.yml"
    mf.write_text(MANIFEST)

    def run(*args):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["--url", server.url, *args])
        return buf.getvalue()

    mid = json.loads(run("model", "deploy", "--manifest", str(mf)))[
        "model_id"]
    tid = json.loads(run("train", "start", "--model", mid,
                         "--learners", "1", "--steps", "5"))["training_id"]
    assert server.core.wait_for(tid, timeout=60) == "COMPLETED"
    status = json.loads(run("train", "status", "--id", tid))
    assert status["status"] == "COMPLETED"
    assert "loss=" in run("train", "logs", "--id", tid)
    rep = json.loads(run("alerts"))
    assert set(rep) == {"active", "history", "remediations"}
    assert isinstance(json.loads(run("slo")), list)
    assert run("alerts", "--follow", "--max-s", "0.3").startswith(
        "[snapshot]")


def test_predict_missing_its_deadline_is_http_504(server):
    eid = _req(f"{server.url}/v1/models", "POST",
               {"arch": "stablelm-1.6b", "capacity": 1,
                "max_new": 8})["endpoint_id"]
    assert wait_until(lambda: server.core.endpoint_status(eid)["state"]
                      == "READY", timeout=60)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{server.url}/v1/models/{eid}/predict", "POST",
             {"tokens": [1, 2, 3], "max_new": 48, "deadline_s": 1e-3})
    assert ei.value.code == 504
    out = _req(f"{server.url}/v1/models/{eid}/predict", "POST",
               {"tokens": [1, 2, 3], "max_new": 4})
    assert len(out["tokens"]) == 4
    _req(f"{server.url}/v1/models/{eid}", "DELETE")
    assert wait_until(lambda: server.core.endpoint_status(eid)["state"]
                      == "STOPPED", timeout=60)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{server.url}/v1/models/{eid}/predict", "POST",
             {"tokens": [1, 2, 3]})
    assert ei.value.code == 409


# -------------------------------------------------- parity with JAX's
@pytest.fixture(scope="module")
def jax_lm():
    """One JAX LM plugin for the module (its jits compile once)."""
    return jax_learner.LMPlugin({"arch": "stablelm-1.6b"})


def _train_through(core, manifest):
    mid = core.deploy_model(json.dumps(manifest))["model_id"]
    tid = core.create_training(mid)["training_id"]
    assert _terminal(core, tid, timeout=240) == "COMPLETED"
    st = core.training_status(tid)
    model = np.load(io.BytesIO(core.download_model(tid)))
    return st, model


@pytest.mark.parametrize("manifest", [LM_MANIFEST, MLP_MANIFEST],
                         ids=["repro-lm", "repro-mlp"])
def test_core_trains_like_the_jax_core(tmp_path, monkeypatch, jax_lm,
                                       manifest):
    flat = use_jax_vector(monkeypatch, manifest, jax_lm)
    jc = JaxCore(str(tmp_path / "jax"))
    pc = DLaaSCore(str(tmp_path / "port"), device="cpu")
    try:
        jst, jmodel = _train_through(jc, manifest)
        pst, pmodel = _train_through(pc, manifest)
    finally:
        jc.close()
        pc.close()
    assert pst["steps_done"] == jst["steps_done"] == manifest["steps"]
    assert pst["backend"] == jst["backend"] == "software-ps"
    np.testing.assert_allclose(pst["last_loss"], jst["last_loss"],
                               **PARITY_TOL)
    assert pmodel.shape == jmodel.shape == flat.shape
    np.testing.assert_allclose(pmodel, jmodel, **PARITY_TOL)
    for key in ("push_count", "agg_rounds", "compression", "ps_shards"):
        assert pst["data_plane"][key] == jst["data_plane"][key], key


# ---------------------------------------------------- the PS is freed
def test_finished_training_releases_its_parameter_server(tmp_path):
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        mid = core.deploy_model(MANIFEST)["model_id"]
        tid = core.create_training(
            mid, overrides={"steps": 8, "compression": "int8"})[
            "training_id"]
        plan = core.trainings[tid]["plan"]
        ps = plan.meta["ps"]
        assert _terminal(core, tid) == "COMPLETED"
        # the tick loop releases it once the learner tasks returned: it
        # drops the PS from the plan, then calls release() outside the
        # core's lock, which marks the PS released and frees its tensors
        # under every shard lock; wait until that section has run
        assert wait_until(lambda: plan.meta["ps"] is None, timeout=10)
        assert wait_until(lambda: ps.released, timeout=10)
        for lock in ps._shard_locks:
            with lock:
                pass
        assert ps.released and ps._params is None and ps._recv is None
        assert ps._pull_bufs == {}
        st = core.training_status(tid)
        assert st["data_plane"] == plan.meta["data_plane_final"]
        assert st["data_plane"]["push_count"] == 2 * 8
        assert st["data_plane"]["compression"] == "int8"
        assert ps.stats() == st["data_plane"]
        with pytest.raises(RuntimeError, match="released"):
            ps.pull(0)
        with pytest.raises(RuntimeError, match="released"):
            ps.load_flat(np.zeros(ps.size, np.float32))
        # the trained model is in the results store all the same
        assert np.load(io.BytesIO(core.download_model(tid))).size == \
            ps.size
    finally:
        core.close()


def test_release_frees_the_server_and_its_clients():
    ps = SoftwareParameterServer(np.arange(600, dtype=np.float32),
                                 n_shards=2, n_learners=2, lr=0.5,
                                 compression="int8", device="cpu")
    clients = [ps.make_client(i) for i in range(2)]
    for i in range(2):
        ps.join(i)
    grads = [np.full(600, 0.1 * (i + 1), np.float32) for i in range(2)]
    done = [threading.Thread(target=c.push, args=(g,))
            for c, g in zip(clients, grads)]
    for th in done:
        th.start()
    for th in done:
        th.join(30)
        assert not th.is_alive()
    live = ps.stats()
    assert live["agg_rounds"] == 1 and live["push_count"] == 2
    assert clients[0]._err is not None and clients[0]._stage is not None
    ps.release()
    ps.release()                                  # idempotent
    assert ps.released and ps.stats() == live
    assert ps._params is ps._m is ps._v is ps._recv is None
    assert all(c._err is None and c._stage is None for c in clients)
    for call in (lambda: ps.pull(0), lambda: clients[1].push(grads[1]),
                 lambda: ps.push(0, grads[0]),
                 lambda: ps.load_flat(grads[0])):
        with pytest.raises(RuntimeError, match="released"):
            call()
    assert ps.stats() == live


def test_killed_training_releases_after_its_learners_return(tmp_path):
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        mid = core.deploy_model(MANIFEST)["model_id"]
        tid = core.create_training(mid, overrides={"steps": 100000})[
            "training_id"]
        plan = core.trainings[tid]["plan"]
        ps = plan.meta["ps"]
        assert wait_until(lambda: core.training_status(tid)["steps_done"]
                          > 2, timeout=60)
        core.terminate_training(tid)
        assert core.lcm.job_state(tid) == "KILLED"
        assert wait_until(lambda: plan.meta["ps"] is None, timeout=30)
        assert ps.released and core._tasks_returned(tid)
        assert core.training_status(tid)["data_plane"]["push_count"] > 0
    finally:
        core.close()


# -------------------------------------------------- one logger per tree
def test_each_cores_hub_gets_only_its_own_job_lines(tmp_path):
    """Both packages' cores in one process: the port's hub gets the
    port's job lines (a resume included) and the JAX hub none of them,
    and the other way round, though the two jobs have one id."""
    jc = JaxCore(str(tmp_path / "jax"))
    pc = DLaaSCore(str(tmp_path / "port"), device="cpu")
    try:
        manifest = dict(MLP_MANIFEST, steps=12, checkpoint_every=4,
                        fail_at_step={"0": 6})
        pid = pc.create_training(pc.deploy_model(json.dumps(manifest))[
            "model_id"])["training_id"]
        jid = jc.create_training(jc.deploy_model(json.dumps(
            MLP_MANIFEST))["model_id"])["training_id"]
        assert pid == jid
        assert _terminal(pc, pid) == "COMPLETED"
        assert _terminal(jc, jid) == "COMPLETED"
        ptrace, jtrace = pc.tracer.trace_of(pid), jc.tracer.trace_of(jid)
        assert ptrace != jtrace
        plines = pc.loghub.tail(pid)
        jlines = jc.loghub.tail(jid)
        assert {r["trace_id"] for r in plines} == {ptrace}
        assert {r["trace_id"] for r in jlines} == {jtrace}
        assert any("resumed from checkpoint step=" in r["line"]
                   for r in plines)
        assert any("resumed from checkpoint step=" in line
                   for line in pc.training_logs(pid))
        assert not any("resumed" in r["line"] for r in jlines)
        assert sum("loss=" in r["line"] for r in jlines) == 10
    finally:
        jc.close()
        pc.close()


# ------------------------------------------------ the health controller
PS_DRILL_MANIFEST = """
name: health-drill
learners: 2
gpus: 1
steps: 40
checkpoint_every: 5
lr: 0.3
framework:
  name: repro-mlp
  d_in: 16
  n_classes: 4
  distribution: software-ps
"""


def test_straggler_alert_drives_learner_restart(tmp_path):
    """tests/test_health.py's straggler drill through the port's core: a
    slowed PS learner fires a straggler alert, is preempted, and the job
    still completes, with the story in /v1/alerts and the timeline."""
    core = DLaaSCore(str(tmp_path), durable=False, device="cpu")
    try:
        core.health.cooldown_s = 1.0
        mid = core.deploy_model(PS_DRILL_MANIFEST)["model_id"]
        tid = core.create_training(mid)["training_id"]
        sched = FaultSchedule.seeded_straggler(11, tid, 2, at_step=3,
                                               seconds=0.08)
        victim = sched.events[0].member
        core.inject_faults(events=sched.events)
        scope = f"{tid}/learner-{victim}"
        assert wait_until(
            lambda: any(r["action"] == "restart_learner"
                        and r["scope"] == scope
                        for r in core.health.alerts.remediations()),
            timeout=90), "straggler remediation never ran"
        assert core.wait_for(tid, timeout=120) == "COMPLETED"
        report = core.alerts()
        assert any(a["name"] == "straggler" and a["scope"] == scope
                   for a in report["history"] + report["active"])
        rem = [r for r in report["remediations"]
               if r["action"] == "restart_learner"]
        assert rem and rem[0]["task"] == f"{tid}-learners.{victim}"
        app = core.scheduler.apps[f"{tid}-learners"]
        assert core.scheduler.queue.tenant(app.tenant).preemptions >= 1
        names = [s["name"] for s in core.training_timeline(tid)["spans"]]
        assert "alert" in names and "remediation" in names
        assert max(core.metrics.series(tid, "loss").steps) >= 39
    finally:
        core.close()


# ------------------------------------------------------------ endpoints
def test_endpoint_by_arch_serves_the_engines_tokens(tmp_path):
    """Fresh weights from the arch's seed: the endpoint's tokens are a
    bare engine's with the same seed."""
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        out = core.deploy_endpoint(arch="stablelm-1.6b", capacity=2,
                                   max_new=6, seed=5)
        eid = out["endpoint_id"]
        assert out["state"] == "DEPLOYING" and out["arch"] == "stablelm-1.6b"
        assert wait_until(lambda: core.endpoint_status(eid)["state"]
                          == "READY", timeout=60)
        got = core.predict(eid, [5, 9, 2, 7], max_new=6)
        eng = InferenceEngine(reduce_for_smoke(get_arch("stablelm-1.6b")),
                              capacity=2, max_seq=64, seed=5,
                              device="cpu")
        eng.start()
        req = eng.submit(np.array([5, 9, 2, 7], np.int32), max_new=6)
        _serve_alone(eng, req)
        assert got["tokens"] == req.tokens and len(req.tokens) == 6
        assert core.stop_endpoint(eid)["state"] in ("DRAINING", "STOPPED")
        assert wait_until(lambda: core.endpoint_status(eid)["state"]
                          == "STOPPED", timeout=60)
        assert core.endpoints[eid].engine.released
    finally:
        core.close()


def _serve_alone(eng, req):
    """Serve ``req`` on ``eng`` from a thread, then drain it."""
    th = threading.Thread(target=eng.run, daemon=True)
    th.start()
    assert req.wait(60) and req.status == "DONE"
    eng.drain()
    th.join(60)
    assert not th.is_alive()


def test_endpoint_from_an_mlp_training_is_refused(tmp_path):
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        mid = core.deploy_model(json.dumps(MLP_MANIFEST))["model_id"]
        tid = core.create_training(mid)["training_id"]
        assert _terminal(core, tid) == "COMPLETED"
        with pytest.raises(ValueError, match="only model-zoo"):
            core.deploy_endpoint(from_training=tid)
        with pytest.raises(ValueError):
            core.deploy_endpoint(arch="no-such-arch")
    finally:
        core.close()


# ----------------------------------------------------------- the device
def test_core_wants_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLaaSCore(str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLaaSServer(str(tmp_path / "w2"))
    # nothing was started or written before the refusal
    assert not (tmp_path / "w" / "journal").exists()
