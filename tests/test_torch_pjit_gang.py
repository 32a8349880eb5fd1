"""``PjitBackend``'s gang on SPMD ranks, on the CPU: a ``Dist`` whose
mesh names only axis sizes (``launch.mesh.MeshShape``) runs each
incarnation in rank processes (``runtime/spmd.py``, gloo through a
``FileStore`` under the job's work directory, one OpenMP thread a rank),
fed by worker 0 from the job's cursor.

  * A ``distribution: pjit`` manifest of 4 workers (stablelm smoke, a
    checkpoint every step) runs mesh-less, is paused at a step boundary,
    moved with ``resume(new_dist=)`` onto a 2 x 2 mesh (4 rank
    processes) and requeued, paused again and moved onto 2 x 1 (two
    ranks left out), and runs to COMPLETED: each incarnation restores
    the step it was paused at, ``trained_model.npy`` equals a fresh
    mesh-less ``Trainer``'s restore of the newest checkpoint bit for bit,
    every step's loss is within ``FWD_TOL`` of an uninterrupted mesh-less
    run of the same manifest, and every checkpoint the ranks wrote is
    mirrored to the object store. (A step redone after a restore takes
    the next documents: the cursor never moves back, as in the
    reference; so the moves land on checkpoints.)
  * ``fail_at_step: {1: s}`` on a 2 x 2 gang kills rank 1's process: its
    member fails and the whole gang restarts from the latest checkpoint
    (``resumed from checkpoint step=N``) and completes.
  * A 2 x 2 gang preempted while rank 1 ignores ``stop`` (its process
    stopped), so the gang's ``stop`` kills it after its grace: no member
    of the next incarnation fails on that old rank; the gang comes back
    once and completes.
  * A mesh of more ranks than the gang has members raises ``UserError``
    and leaves ``next_dist`` unset.
  * Through ``DLaaSCore``: ``resume_training(job, new_dist=<2 x 1>)``
    and ``rescale_training(job)`` restore the job on a 2-rank gang, and
    it completes.

No rank process outlives its test. SGD: at this size AdamW amplifies a
rounding difference about tenfold a step (tests/test_torch_elastic.py),
which an uninterrupted comparison over a whole job cannot hold."""
import io
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import Dist
from repro_torch.errors import UserError
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_attention_bwd as kfab
from repro_torch.launch.mesh import MeshShape
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.backend import JobHandle
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.weights import flat_from_params
from util_platform import Platform

FWD_TOL = dict(atol=2e-5, rtol=2e-5)     # tests/test_torch_trainer.py
ARCH = "stablelm-1.6b"
MANIFEST = {"name": "gang-lm", "learners": 4, "steps": 12,
            "checkpoint_every": 1, "lr": 2e-3, "optimizer": "sgd",
            "seed": 3, "batch_docs": 4, "distribution": "pjit",
            "data": {"n_docs": 64, "seq_len": 32},
            "framework": {"name": "repro-lm", "arch": ARCH}}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DLAAS_PERF", "0")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def tick_until(p, job, cond, what, timeout=240.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        p.scheduler.tick()
        p.lcm.monitor(job)
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"{what} not reached: "
                         f"{p.lcm.member_statuses(job)}")


def steps_done(p, job):
    return len(p.metrics.series(job, "loss").values)


def parked(h):
    """An event set when worker 0 waits out a pause at a step boundary."""
    ev = threading.Event()
    ctl = h.plan.control
    real = ctl.wait_while_paused

    def wait(should_abort=None):
        if ctl.paused and should_abort.__self__.member == "worker-0":
            ev.set()
        return real(should_abort=should_abort)
    ctl.wait_while_paused = wait
    return ev


def move(p, be, h, job, dist, ev):
    """Pause worker 0 at a step boundary; once the checkpoint of that
    step is written, requeue the gang (the ``train rescale`` path) and,
    once worker 0 has yielded (no tick meanwhile, so nothing is placed
    again), resume it onto ``dist``."""
    ev.clear()
    be.pause(h)
    ckpt = CheckpointManager(f"{p.workdir}/ckpt/{job}")
    tick_until(p, job, lambda: ev.is_set()
               and ckpt.latest_valid() == steps_done(p, job), "the pause")
    yielded = len(preemptions(p, job))
    for app_id in p.lcm._app_ids(job):
        p.scheduler.preempt_app(app_id)
    deadline = time.time() + 60
    while len(preemptions(p, job)) == yielded:
        assert time.time() < deadline, "worker 0 never yielded"
        time.sleep(0.01)
    be.resume(h, new_dist=dist)


def preemptions(p, job):
    return [line for line in p.log_lines(job, "worker-0")
            if line.startswith("preempted")]


def assert_no_rank_left(results):
    for inc in results.get("spmd", []):
        for pid in inc["pids"]:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


def losses_by_step(p, job):
    s = p.metrics.series(job, "loss")
    return list(zip(s.steps, s.values))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The manifest mesh-less, uninterrupted: loss by step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLAAS_PERF", "0")
        p = Platform("repro_torch", tmp_path_factory.mktemp("flat"),
                     device="cpu")
        p.launch("job", MANIFEST)
        assert p.drive("job", timeout=240) == "COMPLETED"
    return dict(losses_by_step(p, "job"))


def test_a_job_moves_onto_meshes_and_back_to_fewer_ranks(tmp_path,
                                                         uninterrupted):
    p = Platform("repro_torch", tmp_path, device="cpu")
    h = p.launch("job", MANIFEST)
    ev = parked(h)
    be = p.backends.get_backend("pjit")
    ckdir = tmp_path / "ckpt" / "job"
    tick_until(p, "job", lambda: steps_done(p, "job") >= 3,
               "mesh-less steps")
    move(p, be, h, "job", Dist(mesh=MeshShape(data=2, model=2)), ev)
    first = steps_done(p, "job")
    tick_until(p, "job", lambda: any(
        inc["ranks"] == 4 and len(inc["step_s"]) >= 3
        for inc in h.plan.results.get("spmd", [])), "steps on 2 x 2")
    move(p, be, h, "job", Dist(mesh=MeshShape(data=2, model=1)), ev)
    second = steps_done(p, "job")
    assert p.drive("job", timeout=240) == "COMPLETED"
    res = h.plan.results
    assert [inc["ranks"] for inc in res["spmd"]] == [4, 2]
    assert [inc["axes"] for inc in res["spmd"]] == [
        {"data": 2, "model": 2}, {"data": 2, "model": 1}]
    assert [line for line in p.log_lines("job", "worker-0")
            if "resumed from checkpoint" in line] == [
        f"resumed from checkpoint step={first}",
        f"resumed from checkpoint step={second}"]
    cfg = reduce_for_smoke(get_arch(ARCH))
    for inc in res["spmd"]:
        # the ranks report their launch counts; on the CPU the wrappers
        # run the plain versions and count nothing (the card: phase 19 a)
        assert len(inc["step_s"]) >= 1
        assert inc["launches"][kfa.NAME] == inc["launches"][kfab.NAME] == 0
    got = losses_by_step(p, "job")
    assert [s for s, _ in got] == list(range(MANIFEST["steps"]))
    for s, loss in got:
        np.testing.assert_allclose(loss, uninterrupted[s], **FWD_TOL,
                                   err_msg=f"step {s}")
    uploaded = np.load(io.BytesIO(p.storage.download(
        "results", "job", "trained_model.npy")))
    tr = Trainer(cfg, Dist(), OptConfig(name="sgd", lr=MANIFEST["lr"]),
                 TrainerConfig(batch=4, seq=32, ckpt_dir=str(ckdir)),
                 device="cpu")
    assert tr._restore_latest() == MANIFEST["steps"]
    assert flat_from_params(tr.params).tobytes() == uploaded.tobytes()
    ckpt = CheckpointManager(str(ckdir))
    for s in ckpt.steps():
        name = f"ckpt/job/step_{s:010d}"
        assert json.loads(p.storage.download("objectstore", name,
                                             "manifest.json"))["step"] == s
    assert_no_rank_left(res)


def test_a_killed_rank_restarts_the_whole_gang(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    m = dict(MANIFEST, steps=8, checkpoint_every=2, fail_at_step={1: 5})
    be, plan = p.plan("job", m)
    plan.meta["dist"] = Dist(mesh=MeshShape(data=2, model=2))
    p.scheduler.check_admission(plan.tenant, plan.total_resources())
    h = be.launch(plan, p.lcm)
    assert p.drive("job", timeout=300) == "COMPLETED"
    logs = p.log_lines("job", "worker-0")
    assert "injected crash of rank 1 at step 5" in logs
    assert "resumed from checkpoint step=4" in logs
    assert "rank 1 exited with code -9" in p.log_lines("job", "worker-1")
    for idx in range(4):
        assert p.learner_task("job", idx, role="worker").restarts == 1, idx
    assert [inc["ranks"] for inc in h.plan.results["spmd"]] == [4, 4]
    assert p.metrics.series("job", "loss").steps == [0, 1, 2, 3, 4, 4, 5,
                                                     6, 7]
    assert np.isfinite(h.plan.results["final_loss"])
    assert_no_rank_left(h.plan.results)


def test_a_rank_killed_at_a_preemption_fails_no_later_member(tmp_path,
                                                            monkeypatch):
    from repro_torch.runtime import spmd
    real = spmd.RankGang.stop
    killed = []

    def stop(gang, grace=60.0):
        # rank 1 ignores the stop command: its process is stopped
        os.kill(gang.procs[1].pid, signal.SIGSTOP)
        out = real(gang, grace=5.0)
        killed.append(gang.returncode(1))
        return out
    monkeypatch.setattr(spmd.RankGang, "stop", stop)
    p = Platform("repro_torch", tmp_path, device="cpu")
    be, plan = p.plan("job", dict(MANIFEST, steps=6))
    two_by_two = Dist(mesh=MeshShape(data=2, model=2))
    plan.meta["dist"] = two_by_two
    p.scheduler.check_admission(plan.tenant, plan.total_resources())
    h = be.launch(plan, p.lcm)
    ev = parked(h)
    tick_until(p, "job", lambda: steps_done(p, "job") >= 2,
               "steps on 2 x 2")
    move(p, be, h, "job", two_by_two, ev)
    at = steps_done(p, "job")
    assert p.drive("job", timeout=240) == "COMPLETED"
    assert killed == [-signal.SIGKILL]
    assert [inc["ranks"] for inc in h.plan.results["spmd"]] == [4, 4]
    for idx in range(4):
        assert p.learner_task("job", idx, role="worker").restarts == 0, idx
        assert not [line for line in p.log_lines("job", f"worker-{idx}")
                    if "exited with code" in line], idx
    assert [line for line in p.log_lines("job", "worker-0")
            if "resumed from checkpoint" in line] == [
        f"resumed from checkpoint step={at}"]
    assert_no_rank_left(h.plan.results)


def test_a_mesh_larger_than_the_gang_is_refused(tmp_path):
    p = Platform("repro_torch", tmp_path, device="cpu")
    be, plan = p.plan("job", dict(MANIFEST, learners=2))
    h = JobHandle("job", "pjit", plan, p.lcm)
    with pytest.raises(UserError, match="at least 4 members.*has 2"):
        be.resume(h, new_dist=Dist(mesh=MeshShape(data=2, model=2)))
    assert "next_dist" not in plan.meta
    two = Dist(mesh=MeshShape(data=2, model=1))
    be.resume(h, new_dist=two)
    assert plan.meta["next_dist"] is two


def test_the_service_rescales_a_job_onto_a_gang(tmp_path):
    from repro_torch.service.core import DLaaSCore
    core = DLaaSCore(str(tmp_path), device="cpu")
    try:
        mid = core.deploy_model(json.dumps(dict(
            MANIFEST, learners=2, steps=8, checkpoint_every=2)))["model_id"]
        tid = core.create_training(mid)["training_id"]
        ckdir = tmp_path / "ckpt" / tid
        deadline = time.time() + 240
        while not (ckdir / f"step_{2:010d}").exists():
            assert time.time() < deadline, core.training_status(tid)
            time.sleep(0.05)
        core.resume_training(tid, new_dist=Dist(mesh=MeshShape(data=2,
                                                               model=1)))
        core.rescale_training(tid)
        assert core.wait_for(tid, timeout=240) == "COMPLETED"
        res = core.trainings[tid]["results"]
        assert [inc["ranks"] for inc in res["spmd"]] == [2]
        assert any(line.startswith("resumed from checkpoint step=")
                   for line in core.training_logs(tid))
        assert core.training_status(tid)["steps_done"] >= 8
        assert_no_rank_left(res)
    finally:
        core.close()
