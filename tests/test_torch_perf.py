"""``status.perf`` of the port (``repro_torch.analysis.perf``) against the
reference's (``repro.analysis.perf``), and its wiring.

``JobPerf.snapshot`` builds the reference's payload from one analysis;
``DLAAS_PERF=0`` disables both; a failed count is logged, never raised;
a ``repro-lm`` training (dense and ssm) through the port's ``DLaaSCore``
reaches ``perf.state == "ready"`` with the reference core's keys in
``status.perf``, ``GET /v1/trainings/<id>/perf`` and ``train perf``; an
endpoint's ``status()["perf"]`` is the decode step's; and the health
controller registers the throughput tracker on the live payload.

All on the CPU (``device="cpu"``) at the reference's smoke sizes."""
import io
import json
import logging
import urllib.request
from contextlib import redirect_stdout

import pytest

from repro.analysis import perf as jax_perf
from repro.service.core import DLaaSCore as JaxCore
from repro_torch.analysis import perf
from repro_torch.platform.metrics import MetricsService
from repro_torch.service import cli
from repro_torch.service.core import DLaaSCore
from repro_torch.service.rest import DLaaSServer
from util_poll import wait_until

LM_MANIFEST = {
    "name": "perf-lm", "learners": 1, "steps": 6, "checkpoint_every": 100,
    "lr": 2e-3, "optimizer": "sgd", "seed": 3, "batch_docs": 2,
    "ps_shards": 2, "data": {"n_docs": 64, "seq_len": 32},
    "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
# the ssm family: two chunks of 32 a step, K5 and K5b counted by formula
SSM_MANIFEST = dict(LM_MANIFEST, name="perf-ssm",
                    data={"n_docs": 64, "seq_len": 64},
                    framework={"name": "repro-lm", "arch": "mamba2-1.3b"})
# long enough to be PROCESSING while the health controller evaluates it
MLP_FOREVER = {
    "name": "perf-mlp", "learners": 1, "steps": 100000,
    "checkpoint_every": 100000, "lr": 0.1, "batch_docs": 8,
    "framework": {"name": "repro-mlp", "d_in": 16, "n_classes": 4}}


@pytest.fixture(autouse=True)
def _perf_on(monkeypatch):
    monkeypatch.delenv("DLAAS_PERF", raising=False)
    monkeypatch.setenv("DLAAS_JAX_CACHE", "0")


def _analysis(dominant):
    terms = {"compute": (3e-3, 1e-3, 0.0), "memory": (1e-3, 4e-3, 2e-4),
             "collective": (1e-3, 2e-3, 5e-3)}[dominant]
    return {"flops_per_device": 6.5e12, "hbm_bytes_per_device": 1.234e10,
            "ici_bytes_per_device": 0.0, "dcn_bytes_per_device": 0.0,
            "collective_bytes_by_kind": {}, "compute_s": terms[0],
            "memory_s": terms[1], "collective_s": terms[2]}


def _ready_with(job_perf, analysis):
    job_perf.analysis = analysis
    job_perf.state = "ready"
    return job_perf


@pytest.mark.parametrize("measured", [None, 3.7], ids=["alone", "measured"])
@pytest.mark.parametrize("dominant", ["compute", "memory", "collective"])
@pytest.mark.parametrize("unit", ["step", "decode_step"])
def test_snapshot_equals_the_reference(dominant, measured, unit):
    """One analysis, one measured rate: equal payloads, key for key."""
    a = _analysis(dominant)
    got = _ready_with(perf.JobPerf("j", unit=unit), a).snapshot(measured)
    want = _ready_with(jax_perf.JobPerf("j", unit=unit), a).snapshot(
        measured)
    assert got == want
    assert got["bound"] == f"{dominant}-bound"
    assert ("pct_of_attainable" in got) == (measured is not None)


def test_disabled_under_dlaas_perf_0(monkeypatch):
    monkeypatch.setenv("DLAAS_PERF", "0")
    called = []
    for mod in (perf, jax_perf):
        p = mod.JobPerf("j", unit="decode_step")
        p.start_async(lambda: called.append(1))
        assert p.snapshot(2.0) == {"state": "disabled",
                                   "unit": "decode_step"}
    assert called == []


def test_estimate_is_counted_once_and_fed_to_metrics():
    metrics = MetricsService()
    p = perf.JobPerf("job-m", metrics)
    calls = []

    def cost():
        calls.append(1)
        return _analysis("memory")
    p.start_async(cost)
    p.start_async(cost)            # a re-incarnated body: no second count
    assert wait_until(lambda: p.state == "ready", timeout=10)
    assert wait_until(lambda: metrics.series(
        "job-m", "perf_attainable_per_s").values, timeout=10)
    assert calls == [1]
    assert metrics.series("job-m", "perf_attainable_per_s").values == [
        round(1 / 4e-3, 3)]
    assert p.snapshot()["attainable_steps_per_s"] == 250.0


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_failed_estimate_is_logged_never_raised():
    # a handler on the module's own logger: the port's log setup may
    # stop its tree from propagating to the root
    records = _Records()
    logger = logging.getLogger("repro_torch.perf")
    logger.addHandler(records)
    p = perf.JobPerf("job-e")

    def boom():
        raise RuntimeError("no meta kernel")
    try:
        p.start_async(boom)
        assert wait_until(lambda: records.messages, timeout=10)
    finally:
        logger.removeHandler(records)
    assert p.snapshot() == {"state": "error", "unit": "step",
                            "error": "RuntimeError: no meta kernel"}
    assert records.messages == [
        "perf estimate failed for job-e: RuntimeError: no meta kernel"]


def _train(core, manifest, timeout=240):
    mid = core.deploy_model(json.dumps(manifest))["model_id"]
    tid = core.create_training(mid)["training_id"]
    assert core.wait_for(tid, timeout=timeout) == "COMPLETED"
    assert wait_until(lambda: core.training_perf(tid)["perf"]["state"]
                      in ("ready", "error"), timeout=120)
    return tid


def _req(url):
    r = urllib.request.Request(url)
    r.add_header("Authorization", "Bearer tester")
    with urllib.request.urlopen(r) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("manifest", [LM_MANIFEST, SSM_MANIFEST],
                         ids=["dense", "ssm"])
def test_training_perf_through_the_port_core_has_the_reference_keys(
        tmp_path, manifest):
    """status.perf, ``GET /v1/trainings/<id>/perf`` and ``dlaas train
    perf`` of a ``repro-lm`` training (dense; ssm, whose step counts K5
    and K5b): ready, with the reference core's payload keys, the learner
    step's count on the meta device and a measured rate."""
    from repro_torch.runtime.learner import LMPlugin
    jc = JaxCore(str(tmp_path / "jax"))
    try:
        jtid = _train(jc, manifest)
        want = jc.training_perf(jtid)
    finally:
        jc.close()
    step = LMPlugin(manifest["framework"], device="cpu").program_cost(
        manifest["batch_docs"], manifest["data"])
    with DLaaSServer(str(tmp_path / "port"), device="cpu") as srv:
        tid = _train(srv.core, manifest)
        status = _req(f"{srv.url}/v1/trainings/{tid}")
        got = _req(f"{srv.url}/v1/trainings/{tid}/perf")
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["--url", srv.url, "train", "perf", "--id", tid])
        via_cli = json.loads(buf.getvalue())
    assert want["perf"]["state"] == got["perf"]["state"] == "ready"
    assert sorted(got) == sorted(want) == ["perf", "training_id"]
    assert sorted(got["perf"]) == sorted(want["perf"])
    assert sorted(status["perf"]) == sorted(want["perf"])
    assert via_cli["perf"]["flops_per_step_per_device"] == \
        got["perf"]["flops_per_step_per_device"] == \
        status["perf"]["flops_per_step_per_device"] == \
        step["flops_per_device"]
    assert 0 < got["perf"]["pct_of_attainable"]
    assert got["perf"]["measured_steps_per_s"] > 0


def test_endpoint_status_perf_is_the_decode_step(tmp_path):
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        eid = core.deploy_endpoint(arch="stablelm-1.6b", capacity=2,
                                   max_new=4)["endpoint_id"]
        assert wait_until(lambda: core.endpoint_status(eid)["state"]
                          == "READY", timeout=120)
        assert wait_until(lambda: core.endpoint_status(eid)["perf"][
            "state"] == "ready", timeout=120)
        p = core.endpoint_status(eid)["perf"]
        core.stop_endpoint(eid)
    finally:
        core.close()
    assert p["unit"] == "decode_step"
    assert p["flops_per_step_per_device"] > 0
    assert p["attainable_decode_steps_per_s"] > 0


def test_health_controller_registers_the_throughput_tracker(tmp_path):
    """While a training runs with a ready estimate and a measured rate,
    the health pass tracks its steps/s against the roofline's floor."""
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        mid = core.deploy_model(json.dumps(MLP_FOREVER))["model_id"]
        tid = core.create_training(mid)["training_id"]

        def tracked():
            return [s for s in core.slo_status()
                    if s["kind"] == "throughput" and s["scope"] == tid]
        assert wait_until(lambda: tracked(), timeout=120), \
            core.training_status(tid).get("perf")
        (slo,) = tracked()
        core.terminate_training(tid)
        assert core.wait_for(tid, timeout=60) == "KILLED"
    finally:
        core.close()
    assert slo["name"] == "slo_throughput"
    assert 0 < slo["objective"] < 1
