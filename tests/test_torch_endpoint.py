"""The port's managed endpoints (``repro_torch.serving.endpoint``) against
the JAX package's, through each package's own backend, Lifecycle Manager
and scheduler: the lifecycle from a training (DEPLOYING → READY →
DRAINING → STOPPED, the engine released, the metrics dropped), equal
greedy tokens from one JAX-written ``trained_model.npy`` and from one
port-trained ssm model's, the checkpoint fallback (a JAX-written
checkpoint included), the weights file carried across the package
boundary both ways, deploy-from-arch, pause and resume at a batch-step
boundary, the endpoint as a metered job, and ``status()`` with the
reference's keys (tests/test_serving.py:204-290).

All on the CPU (``device="cpu"``) at the reference's smoke size (f32)."""
import io
import os

import numpy as np
import pytest

from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.serving import endpoint as jax_endpoint
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.platform.queue import QuotaExceeded
from repro_torch.platform.storage import StorageError
from repro_torch.serving import endpoint as port_endpoint
from repro_torch.serving.engine import EndpointClosed, InferenceEngine
from util_platform import Platform
from util_poll import assert_holds_for

ARCH = "stablelm-1.6b"
SSM_ARCH = "mamba2-1.3b"
TRAIN_MANIFEST = {"name": "serve-src", "learners": 1, "steps": 3,
                  "batch_docs": 2, "checkpoint_every": 100, "lr": 2e-3,
                  "data": {"n_docs": 32, "seq_len": 16},
                  "framework": {"name": "repro-lm", "arch": ARCH}}
SERVING = dict(capacity=2, max_new=4, max_seq=32)
PROMPTS = [np.random.RandomState(i).randint(0, 256, size=n)
           for i, n in enumerate((8, 8, 5, 11))]


@pytest.fixture(autouse=True)
def _no_jax_roofline(monkeypatch):
    # the reference's own switch: keeps JobPerf's thread out of the run
    monkeypatch.setenv("DLAAS_PERF", "0")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's platform with one COMPLETED repro-lm training, job-1."""
    p = Platform("repro_torch", tmp_path_factory.mktemp("port"),
                 device="cpu")
    handle = p.launch("job-1", TRAIN_MANIFEST)
    assert p.drive("job-1") == "COMPLETED"
    p.trained = handle.plan.results["params"]
    return p


def predict(ep, prompt, max_new=4):
    req = ep.engine.submit(prompt, max_new=max_new)
    assert req.wait(120), f"request stuck: {req.status}"
    assert req.status == "DONE", req.error
    return req.tokens


def stop(p, ep):
    ep.drain()
    return p.drive_endpoint(ep, "STOPPED")


def bare_engine_tokens(flat, prompts, max_new=4, arch=ARCH):
    """The same prompts, one at a time, through an engine started on
    ``flat`` (None: fresh init from seed 0) outside the platform."""
    import threading
    eng = InferenceEngine(reduce_for_smoke(get_arch(arch)), capacity=2,
                          max_seq=32, device="cpu", endpoint_id="bare")
    eng.start(flat)
    t = threading.Thread(target=eng.run, daemon=True)
    t.start()
    out = []
    for pr in prompts:
        req = eng.submit(pr, max_new=max_new)
        assert req.wait(120)
        out.append(req.tokens)
    eng.drain()
    t.join(20)
    assert not t.is_alive()
    eng.release()
    return out


def test_endpoint_lifecycle_from_training(port):
    """deploy-from-training serves the trained weights; DRAINING →
    STOPPED releases the engine and unregisters the metrics."""
    ep = port.deploy("ep-life", source_training="job-1", **SERVING)
    assert ep.state() == "DEPLOYING"
    port.drive_endpoint(ep, "READY")
    assert port.lcm.job_state("ep-life") == "PROCESSING"
    res = [predict(ep, pr) for pr in PROMPTS[:3]]
    assert all(len(r) == 4 for r in res)
    again = predict(ep, np.arange(5) + 1, max_new=3)
    assert predict(ep, np.arange(5) + 1, max_new=3) == again
    # the trained weights: the tokens of a bare engine on the PS params
    assert res == bare_engine_tokens(port.trained, PROMPTS[:3])
    st = ep.status()
    assert st["state"] == "READY" and st["source_training"] == "job-1"
    stats = st["stats"]
    assert stats["completed_total"] == 5
    assert stats["rejected_total"] == 0
    assert stats["p50_latency_s"] is not None
    assert stats["mean_batch_occupancy"] > 0
    ep.drain()
    assert ep.state() in ("DRAINING", "STOPPED")
    assert port.drive_endpoint(ep, "STOPPED") == "STOPPED"
    st = ep.status()
    assert st["stats"]["completed_total"] == 5
    assert ep.engine.released and ep.engine._cache is None
    assert port.metrics.metrics("ep-life") == []
    with pytest.raises(EndpointClosed):
        ep.engine.submit([1, 2], max_new=2)


def test_tokens_equal_jax_from_one_jax_trained_model(tmp_path):
    """A JAX training uploads trained_model.npy; a JAX endpoint and the
    port's endpoint, each through its own platform, deploy it and give
    the same greedy tokens. status() has the reference's keys and its
    disabled perf payload."""
    jp = Platform("repro", tmp_path)
    jp.launch("job-1", TRAIN_MANIFEST)
    assert jp.drive("job-1", timeout=240) == "COMPLETED"
    # the port's platform over the same workdir reads the same stores
    pp = Platform("repro_torch", tmp_path, device="cpu")
    eps = {"jax": jp.deploy("ep-j", source_training="job-1", **SERVING),
           "port": pp.deploy("ep-p", source_training="job-1", **SERVING)}
    plat = {"jax": jp, "port": pp}
    tokens, status = {}, {}
    for k, ep in eps.items():
        plat[k].drive_endpoint(ep, "READY", timeout=240)
        tokens[k] = [predict(ep, pr) for pr in PROMPTS]
        status[k] = ep.status()
    assert tokens["port"] == tokens["jax"]
    assert sorted(status["port"]) == sorted(status["jax"])
    assert sorted(status["port"]["stats"]) == sorted(status["jax"]["stats"])
    assert status["port"]["perf"] == status["jax"]["perf"] == {
        "state": "disabled", "unit": "decode_step"}
    for k, ep in eps.items():
        stop(plat[k], ep)
        assert ep.engine._cache is None


def test_ssm_trained_in_the_port_serves_the_jax_endpoints_tokens(tmp_path):
    """mamba2-1.3b trained in the port (two chunks of 32 a step, the
    ssm backward on the CPU), its trained_model.npy deployed by the
    port's endpoint and by the JAX endpoint, each through its own
    platform: the same greedy tokens, and those of a bare engine on the
    PS params."""
    pp = Platform("repro_torch", tmp_path, device="cpu")
    m = dict(TRAIN_MANIFEST, data={"n_docs": 32, "seq_len": 64},
             framework={"name": "repro-lm", "arch": SSM_ARCH})
    handle = pp.launch("job-ssm", m)
    assert pp.drive("job-ssm", timeout=240) == "COMPLETED"
    trained = handle.plan.results["params"]
    jp = Platform("repro", tmp_path)
    eps = {"port": pp.deploy("ep-p", source_training="job-ssm",
                             arch=SSM_ARCH, **SERVING),
           "jax": jp.deploy("ep-j", source_training="job-ssm",
                            arch=SSM_ARCH, **SERVING)}
    plat = {"port": pp, "jax": jp}
    tokens = {}
    for k, ep in eps.items():
        plat[k].drive_endpoint(ep, "READY", timeout=240)
        tokens[k] = [predict(ep, pr) for pr in PROMPTS]
    assert tokens["port"] == tokens["jax"]
    assert tokens["port"] == bare_engine_tokens(trained, PROMPTS,
                                                arch=SSM_ARCH)
    for k, ep in eps.items():
        stop(plat[k], ep)
        assert ep.engine._cache is None


def test_port_upload_loads_in_jax_and_jax_checkpoint_in_port(port,
                                                             tmp_path):
    """The flat vector crosses the package boundary at the file level in
    both directions: the port's trained_model.npy through the JAX
    loader, a JAX checkpoint through the port's fallback."""
    jax_storage = Platform("repro", port.workdir).storage
    got = jax_endpoint.load_flat_weights(jax_storage, "job-1")
    np.testing.assert_array_equal(got, port.trained)
    vec = np.random.RandomState(5).standard_normal(300).astype(np.float32)
    ck = JaxCkpt(str(tmp_path / "ckpt" / "job-j"))
    ck.save(4, {"flat": vec}, extra={"step": 4, "epoch": 0, "offset": 8})
    ck.wait()
    storage = Platform("repro_torch", tmp_path, device="cpu").storage
    got = port_endpoint.load_flat_weights(
        storage, "job-j", ckpt_dir=str(tmp_path / "ckpt" / "job-j"),
        expect_size=300)
    np.testing.assert_array_equal(got, vec)
    with pytest.raises(StorageError):
        port_endpoint.load_flat_weights(storage, "job-none",
                                        ckpt_dir=str(tmp_path / "none"),
                                        expect_size=300)


def test_checkpoint_fallback_serves_the_newest_checkpoint(tmp_path):
    """No trained_model.npy: the endpoint deploys from the job's newest
    valid checkpoint, a port-written one and a JAX-written one."""
    p = Platform("repro_torch", tmp_path, device="cpu")
    p.launch("job-1", dict(TRAIN_MANIFEST, steps=4, checkpoint_every=2))
    assert p.drive("job-1") == "COMPLETED"
    final = p.storage.download("results", "job-1", "trained_model.npy")
    final = np.load(io.BytesIO(final))
    os.remove(tmp_path / "results" / "job-1" / "trained_model.npy")
    assert CheckpointManager(str(tmp_path / "ckpt" / "job-1")).steps() \
        == [2, 4]
    flat = port_endpoint.load_flat_weights(
        p.storage, "job-1", ckpt_dir=str(tmp_path / "ckpt" / "job-1"),
        expect_size=final.size)
    assert flat.tobytes() == final.tobytes()
    # a JAX-written checkpoint of other weights, served by an endpoint
    vec = np.random.RandomState(7).standard_normal(final.size).astype(
        np.float32) * 0.02
    ck = JaxCkpt(str(tmp_path / "ckpt" / "job-j"))
    ck.save(3, {"flat": vec}, extra={"step": 3, "epoch": 0, "offset": 6})
    ck.wait()
    ep = p.deploy("ep-ck", source_training="job-j", **SERVING)
    p.drive_endpoint(ep, "READY")
    assert [predict(ep, pr) for pr in PROMPTS[:2]] == \
        bare_engine_tokens(vec, PROMPTS[:2])
    stop(p, ep)


def test_deploy_from_arch_serves_fresh_weights(port):
    ep = port.deploy("ep-arch", seed=0, **SERVING)
    port.drive_endpoint(ep, "READY")
    assert ep.status()["source_training"] is None
    assert [predict(ep, pr) for pr in PROMPTS[:2]] == \
        bare_engine_tokens(None, PROMPTS[:2])
    stop(port, ep)


def test_endpoint_pause_resume(port):
    """Endpoints share the training lifecycle hooks: pause gates the
    serve loop at a batch-step boundary, resume reopens it."""
    be = port.backends.get_backend("serving")
    ep = port.deploy("ep-pause", capacity=1, max_new=2, max_seq=32)
    port.drive_endpoint(ep, "READY")
    predict(ep, [1, 2, 3], max_new=2)
    be.pause(ep.handle)
    req = ep.engine.submit([4, 5, 6], max_new=2)
    assert_holds_for(lambda: not req.done.is_set(),
                     desc="paused endpoint must hold the request")
    be.resume(ep.handle)
    assert req.wait(60) and req.status == "DONE"
    stop(port, ep)


def test_endpoint_is_a_metered_job(port):
    """Endpoints flow through the same scheduler/queue as trainings:
    they run as jobs of a tenant, admission rejects what the quota can
    never fit, and one that fits but must wait sits QUEUED until it is
    stopped."""
    port.scheduler.configure_tenant("svc-team", quota_gpus=1)
    ep = port.deploy("ep-m1", tenant="svc-team", gpus=1, capacity=1,
                     max_new=2, max_seq=32)
    assert port.lcm.job_spec("ep-m1").get("tenant") == "svc-team"
    with pytest.raises(QuotaExceeded):
        port.deploy("ep-m2", tenant="svc-team", gpus=2, max_seq=32)
    port.drive_endpoint(ep, "READY")
    held = port.deploy("ep-m3", tenant="svc-team", gpus=1, capacity=1,
                       max_new=2, max_seq=32)
    port.scheduler.tick()
    assert port.lcm.monitor("ep-m3") == "QUEUED"
    assert held.state() == "DEPLOYING"
    # stopping an endpoint that never started kills it outright (as
    # DLaaSCore.stop_endpoint does), freeing its queue entry
    held.drain()
    port.lcm.kill("ep-m3")
    held.finalize(port.metrics)
    assert held.state() == "STOPPED"
    assert stop(port, ep) == "STOPPED"
