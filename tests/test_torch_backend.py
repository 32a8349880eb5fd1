"""The port's execution backends against the JAX package's: the same
registry names, the same plan layout, and one manifest planned and
launched through each package's own backend, Lifecycle Manager and
scheduler (dense and ssm LMs, the MLP) trains to the same losses (atol =
rtol = 1e-4) and the same PS params (``PARAM_TOL``, as in
tests/test_torch_learner.py) from one initial vector; then the lifecycle
hooks, a user error that fails the job without a restart, a crash that
restarts and resumes, and no CPU fallback.

All on the CPU (``device="cpu"``) at the reference's smoke sizes. Torch
cannot reproduce ``jax.random``, so the port's plan is given JAX's
initial vector through a test-side plugin (``util_parity``)."""
import time

import numpy as np
import pytest
import torch

from repro.platform.cluster import UserError as JaxUserError
from repro.runtime import backend as jax_backend
from repro.runtime import learner as jax_learner
from repro.serving import endpoint as jax_endpoint  # noqa: F401 (registers)
from repro_torch.errors import UserError
from repro_torch.platform.cluster import FAILED as TASK_FAILED
from repro_torch.platform.watchdog import JOB_FAILED
from repro_torch.runtime import backend as port_backend
from repro_torch.runtime import learner as port_learner
from repro_torch.serving import endpoint as port_endpoint  # noqa: F401
from util_parity import use_jax_vector
from util_platform import Platform

PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)


def lm_manifest(**kw):
    m = {"name": "parity-lm", "learners": 2, "steps": 6,
         "checkpoint_every": 3, "lr": 2e-3, "optimizer": "sgd", "seed": 3,
         "batch_docs": 2, "ps_shards": 2,
         "data": {"n_docs": 128, "seq_len": 32},
         "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
    m.update(kw)
    return m


def mlp_manifest(**kw):
    m = {"name": "parity-mlp", "learners": 2, "steps": 10,
         "checkpoint_every": 5, "lr": 0.1, "optimizer": "sgd", "seed": 1,
         "batch_docs": 8, "ps_shards": 2,
         "framework": {"name": "repro-mlp", "d_in": 16, "n_classes": 4}}
    m.update(kw)
    return m


@pytest.fixture(autouse=True)
def _no_jax_roofline(monkeypatch):
    # the reference's own switch: keeps JobPerf's thread out of the run
    monkeypatch.setenv("DLAAS_PERF", "0")


@pytest.fixture(scope="module")
def jax_lm():
    """One JAX LM plugin for the module (its jits compile once)."""
    return jax_learner.LMPlugin({"arch": "stablelm-1.6b"})


@pytest.fixture(scope="module")
def jax_ssm():
    """The same for the ssm family (mamba2-1.3b's smoke reduction)."""
    return jax_learner.LMPlugin({"arch": "mamba2-1.3b"})


def _train(pkg, workdir, manifest, job="job-1"):
    p = Platform(pkg, workdir, **({"device": "cpu"}
                                  if pkg == "repro_torch" else {}))
    handle = p.launch(job, manifest)
    state = p.drive(job, timeout=240)
    series = p.metrics.series(job, "loss")
    losses = {}
    for s, v in zip(series.steps, series.values):
        losses.setdefault(s, []).append(v)
    final = handle.plan.meta["ps"].pull(0)
    final = final.numpy() if isinstance(final, torch.Tensor) \
        else np.array(final)
    return state, {s: sorted(v) for s, v in losses.items()}, final, \
        handle, p


def test_registry_has_the_reference_names():
    assert set(port_backend.BACKENDS) == set(jax_backend.BACKENDS) == {
        "software-ps", "pjit", "serving"}
    with pytest.raises(UserError):
        port_backend.get_backend("horovod")
    with pytest.raises(JaxUserError):
        jax_backend.get_backend("horovod")


def test_pjit_is_not_yet_ported(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    with pytest.raises(UserError, match="'pjit' is not yet ported"):
        p.plan("job-1", lm_manifest(distribution="pjit"))


@pytest.mark.parametrize("framework", ["repro-lm", "repro-mlp"])
@pytest.mark.parametrize("learners", [1, 2])
def test_plan_layout_matches_jax(tmp_path, monkeypatch, jax_lm, framework,
                                 learners):
    """Group roles, counts, resources and order, and the meta keys."""
    make = lm_manifest if framework == "repro-lm" else mlp_manifest
    manifest = make(learners=learners, tenant="t")
    use_jax_vector(monkeypatch, manifest, jax_lm)
    plans = []
    for pkg in ("repro", "repro_torch"):
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        _, plan = Platform(pkg, tmp_path / pkg, **kw).plan(
            "job-1", manifest, gpus=2, tenant="t", priority=3)
        plans.append(plan)
    jax_plan, port_plan = plans

    def layout(plan):
        return [(g.role, g.count, g.resources.cpus, g.resources.gpus,
                 g.resources.memory_mb, g.body is None) for g in plan.groups]
    assert layout(port_plan) == layout(jax_plan)
    assert [g.role for g in port_plan.groups] == (
        ["ps", "learner"] if learners > 1 else ["learner"])
    assert sorted(port_plan.meta) == sorted(jax_plan.meta) == [
        "compression", "framework", "perf", "ps", "ps_shards", "steps"]
    for key in ("compression", "framework", "ps_shards", "steps"):
        assert port_plan.meta[key] == jax_plan.meta[key]
    assert (port_plan.backend, port_plan.tenant, port_plan.priority,
            port_plan.min_alive_fraction) == (
        jax_plan.backend, jax_plan.tenant, jax_plan.priority,
        jax_plan.min_alive_fraction)
    assert port_plan.meta["perf"].snapshot() == \
        jax_plan.meta["perf"].snapshot() == {"state": "disabled",
                                             "unit": "step"}


# Learning rates of tests/test_torch_learner.py: at SGD lr 0.1 the
# random smoke LM is chaotic and the packages' rounding drifts apart.
# With int8 and two learners, which learner claims which batch follows
# the threads' order at the cursor, so each learner's error-feedback
# residual, and with it which values round to the next int8 level,
# differs between any two runs, of one package too. One level moves a
# param by lr x block scale / 2 learners: ~1e-4 at lr 2e-3 on this
# model (block scales up to ~0.1), ~5e-5 at lr 1e-3, inside PARAM_TOL.
# the ssm family (mamba2-1.3b) at 64 positions crosses its chunk of 32
SSM_LM = {"name": "repro-lm", "arch": "mamba2-1.3b"}


@pytest.mark.parametrize("manifest", [
    lm_manifest(optimizer="sgd", lr=2e-3),
    lm_manifest(optimizer="adam", lr=3e-4),
    lm_manifest(optimizer="sgd", lr=1e-3, compression="int8"),
    lm_manifest(optimizer="adam", lr=3e-4, framework=SSM_LM,
                data={"n_docs": 128, "seq_len": 64}),
    mlp_manifest(),
], ids=["lm-sgd", "lm-adam", "lm-int8", "ssm-adam", "mlp-sgd"])
def test_training_through_the_backend_matches_jax(tmp_path, monkeypatch,
                                                  jax_lm, jax_ssm, manifest):
    ssm = manifest["framework"].get("arch") == SSM_LM["arch"]
    flat = use_jax_vector(monkeypatch, manifest, jax_ssm if ssm else jax_lm)
    jstate, jlosses, want, _, _ = _train("repro", tmp_path / "jax",
                                          manifest)
    state, losses, got, handle, p = _train("repro_torch",
                                           tmp_path / "port", manifest)
    assert state == jstate == "COMPLETED"
    steps = manifest["steps"]
    assert sorted(losses) == sorted(jlosses) == list(range(steps))
    for s in range(steps):
        assert len(losses[s]) == manifest["learners"]
        np.testing.assert_allclose(losses[s], jlosses[s], **LOSS_TOL)
    assert np.abs(got - flat).max() > 10 * PARAM_TOL["atol"]   # it moved
    np.testing.assert_allclose(got, want, **PARAM_TOL)
    np.testing.assert_array_equal(handle.plan.results["params"], got)
    st = handle.plan.meta["ps"].stats()
    assert (st["push_count"], st["agg_rounds"]) == (
        manifest["learners"] * steps, steps)
    assert st["compression"] == manifest.get("compression", "none")
    if manifest["framework"]["name"] == "repro-mlp":
        acc = p.metrics.series("job-1", "accuracy").values
        assert len(acc) == manifest["learners"] * steps
    # the PS app went first, then the learners
    assert list(p.scheduler.apps) == ["job-1-ps", "job-1-learners"]


def test_lifecycle_hooks(tmp_path):
    """checkpoint/pause/resume flow from the backend protocol to the
    running job, observed at step boundaries (tests/test_backends.py:104)."""
    p = Platform("repro_torch", tmp_path, device="cpu")
    manifest = mlp_manifest(learners=1, steps=400,
                            checkpoint_every=100000)
    handle = p.launch("job-1", manifest)
    be = port_backend.get_backend("software-ps")

    def steps_done():
        return len(p.metrics.series("job-1", "loss").values)
    p.drive("job-1", until=("PROCESSING",))
    assert _wait(lambda: steps_done() >= 5)
    be.checkpoint(handle)
    assert _wait(lambda: p.metrics.events("job-1", "checkpoint")), \
        "on-demand checkpoint was never taken"
    be.pause(handle)
    time.sleep(0.2)                            # drain the in-flight step
    s1 = steps_done()
    time.sleep(0.3)
    assert steps_done() <= s1 + 1, "paused job kept stepping"
    be.resume(handle)
    assert p.drive("job-1", timeout=120) == "COMPLETED"
    assert steps_done() == 400


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_user_error_fails_the_job_without_a_restart(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    p.launch("job-1", mlp_manifest(learners=1, user_error_at=2))
    assert p.drive("job-1") == "FAILED"
    assert p.lcm._get("job-1", "state")["reason"] == "user error"
    task = p.learner_task("job-1")
    assert task.restarts == 0 and task.state == TASK_FAILED
    status = p.zk.get("/dlaas/jobs/job-1/members/learner-0/status")[0]
    assert JOB_FAILED in status.decode()
    assert sorted(set(p.metrics.series("job-1", "loss").steps)) == [0, 1]


def test_crash_restarts_and_resumes_from_the_checkpoint(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    h = p.launch("job-1", mlp_manifest(learners=1, steps=6,
                                       checkpoint_every=2,
                                       fail_at_step={0: 3}))
    assert p.drive("job-1") == "COMPLETED"
    assert p.learner_task("job-1").restarts == 1
    logs = p.log_lines("job-1")
    assert "injected crash at step 3" in logs
    assert "resumed from checkpoint step=2" in logs
    # steps 2 and 3 ran twice: before the crash and after the resume
    assert p.metrics.series("job-1", "loss").steps == [0, 1, 2, 2, 3, 4, 5]
    assert h.plan.meta["ps"].stats()["agg_rounds"] == 7


def test_context_without_a_device_wants_cuda(tmp_path):
    """``BackendContext`` with no ``device`` resolves to CUDA: without a
    card it raises instead of running on the CPU."""
    kw = dict(zk=None, storage=None, metrics=None, workdir=str(tmp_path))
    if torch.cuda.is_available():
        assert port_backend.BackendContext(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_backend.BackendContext(**kw)


def test_plan_refuses_a_config_of_another_arch(tmp_path):
    from repro_torch.configs.registry import get_arch
    p = Platform("repro_torch", tmp_path, device="cpu",
                 cfg=get_arch("mamba2-1.3b"))
    with pytest.raises(UserError, match="mamba2-1.3b"):
        p.plan("job-1", lm_manifest())
    with pytest.raises(UserError, match="repro-mlp"):
        p.plan("job-2", mlp_manifest())


def test_mlp_plugin_flat_layout_matches_jax():
    """``MLPPlugin``'s flat vector has the reference's size and
    ``ravel_pytree`` layout (b1, b2, w1, w2): zero biases where JAX's are,
    weights N(0, 1/fan_in), the same vector for the same seed."""
    fw = {"d_in": 16, "d_hidden": 32, "n_classes": 4}
    jflat = np.asarray(jax_learner.MLPPlugin(fw).flat_state(0))
    tp = port_learner.MLPPlugin(fw, device="cpu")
    flat = tp.flat_state(0).numpy()
    assert tp.flat_size == flat.size == jflat.size
    assert np.array_equal(flat == 0, jflat == 0)          # b1, b2 first
    w1 = flat[32 + 4: 32 + 4 + 16 * 32]
    w2 = flat[32 + 4 + 16 * 32:]
    assert abs(w1.std() * np.sqrt(16) - 1) < 0.15
    assert abs(w2.std() * np.sqrt(32) - 1) < 0.3
    np.testing.assert_array_equal(tp.flat_state(0).numpy(), flat)
    assert not np.array_equal(tp.flat_state(1).numpy(), flat)
