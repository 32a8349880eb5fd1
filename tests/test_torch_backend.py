"""The port's execution backends against the JAX package's: the same
registry names, the same plan layout, and one manifest planned and
launched through each package's own backend, Lifecycle Manager and
scheduler (dense and ssm LMs, the MLP) trains to the same losses (atol =
rtol = 1e-4) and the same PS params (``PARAM_TOL``, as in
tests/test_torch_learner.py) from one initial vector; then the lifecycle
hooks, a user error that fails the job without a restart, a crash that
restarts and resumes, and no CPU fallback.

``pjit`` (``PjitBackend``, the gang around ``runtime/trainer.py``): one
manifest through the port's ``software-ps`` and ``pjit`` reaches final
losses within the reference's 0.2 (tests/test_backends.py:54) and leaves
a checkpoint a fresh mesh-less ``Trainer`` restores; the port's and the
reference's ``pjit`` through each package's ``DLaaSCore`` from one
initial param tree lose alike per step (``LOSS_TOL``) and upload the same
``trained_model.npy`` (``PARAM_TOL``); a non-zoo framework is refused; a
user error fails the gang, and a crash restarts it from its checkpoint.

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
    """Launch ``manifest`` through ``pkg``'s platform and tick it to a
    terminal state. The reference's learner pulls as soon as it has
    joined its PS, and its BSP barrier counts only the members joined so
    far, so a learner thread that starts late would take its step 0 on
    weights a round finished without it. The reference's PS therefore
    has every slot joined (its own ``join``) before the ticks start the
    learners, as ``tests/test_torch_learner.py::_train`` does; the
    port's learners wait at their PS's start barrier instead."""
    p = Platform(pkg, workdir, **({"device": "cpu"}
                                  if pkg == "repro_torch" else {}))
    handle = p.launch(job, manifest)
    if pkg == "repro":
        ps = handle.plan.meta["ps"]
        for i in range(ps.n_learners):
            ps.join(i)
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


def test_pjit_rejects_non_zoo_framework(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    with pytest.raises(UserError, match="model-zoo framework"):
        p.plan("job-1", mlp_manifest(distribution="pjit"))


# the reference's parity manifest (tests/test_backends.py:20-36) at lr
# 2e-3: at its 0.1 SGD on the random smoke model is chaotic, so two
# backends that agree to rounding for 6 steps part after that and their
# step-25 losses differ by chance (0.14 in the reference, 0.23 in the
# port, both deterministic)
PJIT_PARITY = {"name": "parity-lm", "learners": 1, "gpus": 1, "steps": 25,
               "checkpoint_every": 10, "lr": 2e-3, "optimizer": "sgd",
               "seed": 3, "batch_docs": 4,
               "data": {"n_docs": 128, "seq_len": 16},
               "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}


def test_pjit_and_software_ps_reach_comparable_loss(tmp_path):
    """The same manifest and seed on both of the port's backends: final
    losses within 0.2, and the pjit checkpoint restores into a fresh
    mesh-less ``Trainer`` at its step."""
    import json as _json

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import Dist
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.service.core import DLaaSCore
    finals, losses = {}, {}
    for backend in ("software-ps", "pjit"):
        core = DLaaSCore(str(tmp_path / backend), device="cpu")
        try:
            mid = core.deploy_model(_json.dumps(PJIT_PARITY))["model_id"]
            out = core.create_training(
                mid, overrides={"distribution": backend})
            assert out["backend"] == backend
            tid = out["training_id"]
            assert core.wait_for(tid, timeout=240) == "COMPLETED"
            status = core.training_status(tid)
            assert status["backend"] == backend
            assert status["steps_done"] >= 25
            finals[backend] = core.trainings[tid]["results"]["final_loss"]
            losses[backend] = core.metrics.series(tid, "loss").values
            ckpt = CheckpointManager(f"{core.workdir}/ckpt/{tid}")
            last = ckpt.latest_valid()
            assert last is not None
            if backend == "pjit":
                tc = TrainerConfig(batch=4, seq=16,
                                   ckpt_dir=f"{core.workdir}/ckpt/{tid}",
                                   job_id="probe")
                tr = Trainer(reduce_for_smoke(get_arch("stablelm-1.6b")),
                             Dist(), OptConfig(name="sgd", lr=2e-3), tc,
                             device="cpu").init(0)
                tr._restore_latest()
                assert tr.step == last == 20
                params = core.trainings[tid]["results"]["params"]
                assert params.shape == (flat_size_smoke(),)
        finally:
            core.close()
    assert abs(finals["software-ps"] - finals["pjit"]) < 0.2, finals
    # the same weights, data and update: the same losses step by step
    np.testing.assert_allclose(losses["pjit"], losses["software-ps"],
                               **LOSS_TOL)


def flat_size_smoke():
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_arch
    from repro_torch.weights import flat_size
    return flat_size(reduce_for_smoke(get_arch("stablelm-1.6b")))


def test_pjit_matches_the_jax_pjit(tmp_path, monkeypatch):
    """One manifest through each package's ``DLaaSCore`` with
    ``distribution: pjit``, the port's ``Model.init`` patched to the
    reference's ``model.init(PRNGKey(seed))``: per-step losses within
    ``LOSS_TOL``, the uploaded ``trained_model.npy`` (the flat f32
    vector in the reference's leaf order) within ``PARAM_TOL``."""
    import io
    import json as _json

    import jax

    from repro.configs.base import reduce_for_smoke as jax_reduce
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models.model import make_model as jax_make_model
    from repro.service.core import DLaaSCore as JaxCore
    from repro_torch.models import model as port_model
    from repro_torch.service.core import DLaaSCore
    from repro_torch.weights import params_from_jax

    manifest = dict(lm_manifest(learners=1, steps=6, checkpoint_every=3,
                                optimizer="adamw", lr=1e-3),
                    distribution="pjit")
    jm = jax_make_model(jax_reduce(jax_get_arch("stablelm-1.6b")))
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(
        manifest["seed"])))
    monkeypatch.setattr(port_model.Model, "init",
                        lambda self, gen: params_from_jax(init, gen.device))
    out = {}
    for name, core in (("jax", JaxCore(str(tmp_path / "jax"))),
                       ("port", DLaaSCore(str(tmp_path / "port"),
                                          device="cpu"))):
        try:
            mid = core.deploy_model(_json.dumps(manifest))["model_id"]
            tid = core.create_training(mid)["training_id"]
            assert core.wait_for(tid, timeout=240) == "COMPLETED"
            st = core.training_status(tid)
            assert st["backend"] == "pjit" and st["steps_done"] == 6
            series = core.metrics.series(tid, "loss")
            model = np.load(io.BytesIO(core.download_model(tid)))
            out[name] = (series.steps, series.values, model)
        finally:
            core.close()
    (jsteps, jl, jmodel), (psteps, pl, pmodel) = out["jax"], out["port"]
    assert psteps == jsteps == list(range(6))
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    assert pmodel.shape == jmodel.shape
    np.testing.assert_allclose(pmodel, jmodel, **PARAM_TOL)


def test_pjit_user_error_fails_the_gang(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    p.launch("job-1", lm_manifest(learners=2, distribution="pjit",
                                  user_error_at=2))
    assert p.drive("job-1") == "FAILED"
    assert p.lcm._get("job-1", "state")["reason"] == "user error"
    assert sorted(set(p.metrics.series("job-1", "loss").steps)) == [0, 1]


def test_pjit_crash_restarts_and_resumes_from_the_checkpoint(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    h = p.launch("job-1", lm_manifest(learners=2, steps=6,
                                      checkpoint_every=2,
                                      distribution="pjit",
                                      fail_at_step={0: 3}))
    assert h.plan.min_alive_fraction == 1.0
    assert [g.role for g in h.plan.groups] == ["worker"]
    assert p.drive("job-1") == "COMPLETED"
    assert p.learner_task("job-1", role="worker").restarts == 1
    logs = p.log_lines("job-1", "worker-0")
    assert "injected crash at step 3" in logs
    assert "resumed from checkpoint step=2" in logs
    assert p.metrics.series("job-1", "loss").steps == [0, 1, 2, 2, 3, 4, 5]
    assert h.plan.results["params"].shape == (flat_size_smoke(),)
    assert np.isfinite(h.plan.results["final_loss"])


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


def _hold_back_learner_1(monkeypatch, learner_mod, wait_s=3.0):
    """Start learner 1 of ``learner_mod``'s bodies only once its PS has
    taken a push (learner 0's step 0), or after ``wait_s``."""
    make = learner_mod.make_learner_body

    def held(cfg, ps, *args, **kw):
        body = make(cfg, ps, *args, **kw)

        def run(wd, idx):
            if idx == 1:
                _wait(lambda: ps.stats()["push_count"] >= 1, wait_s)
            return body(wd, idx)
        return run
    monkeypatch.setattr(learner_mod, "make_learner_body", held)


@pytest.mark.parametrize("manifest", [
    lm_manifest(optimizer="adam", lr=3e-4, steps=2),
    mlp_manifest(steps=2),
], ids=["lm-adam", "mlp-sgd"])
def test_late_learner_takes_step_0_on_the_initial_weights(
        tmp_path, monkeypatch, jax_lm, manifest):
    """Learner 1 starts only once learner 0 has pushed step 0, in both
    packages. Its step-0 loss is still that of the initial weights: the
    reference's round 0 cannot finish without it because ``_train``
    joins every slot of its PS first, and the port's learner 0 waits at
    its PS's start barrier (so learner 1 starts after ``wait_s``)."""
    use_jax_vector(monkeypatch, manifest, jax_lm)
    _hold_back_learner_1(monkeypatch, jax_learner)
    _hold_back_learner_1(monkeypatch, port_learner)
    _, jlosses, want, _, _ = _train("repro", tmp_path / "jax", manifest)
    _, losses, got, _, _ = _train("repro_torch", tmp_path / "port",
                                  manifest)
    for s in range(manifest["steps"]):
        np.testing.assert_allclose(losses[s], jlosses[s], **LOSS_TOL)
    np.testing.assert_allclose(got, want, **PARAM_TOL)


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


def test_crash_waits_for_its_checkpoint_still_being_written(tmp_path,
                                                           monkeypatch):
    """The step-2 checkpoint is still being written (a slow disk: 0.5 s)
    when the learner crashes at step 3: the crashing learner lets the
    write finish before its task fails, so the restart resumes from
    step 2 and not from scratch."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    write = CheckpointManager._write

    def slow(self, *a):
        time.sleep(0.5)
        write(self, *a)
    monkeypatch.setattr(CheckpointManager, "_write", slow)
    p = Platform("repro_torch", tmp_path, device="cpu")
    p.launch("job-1", mlp_manifest(learners=1, steps=6, checkpoint_every=2,
                                   fail_at_step={0: 3}))
    assert p.drive("job-1") == "COMPLETED"
    assert p.learner_task("job-1").restarts == 1
    assert "resumed from checkpoint step=2" in p.log_lines("job-1")
    assert p.metrics.series("job-1", "loss").steps == [0, 1, 2, 2, 3, 4, 5]


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
