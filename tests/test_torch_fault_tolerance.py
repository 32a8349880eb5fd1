"""The paper's fault tolerance through the port (``repro_torch``) on the
CPU: the counterparts of tests/test_fault_tolerance.py's five end-to-end
drills (a learner crash restarted from its checkpoint, a user error
failing without a restart, a node killed under the PS learners, a node
drained under a pjit gang, a serving node killed mid-request), the
seeded chaos replay of scripts/verify.sh against the reference's
transition log, the crash drill with a ``repro-lm`` manifest through
both packages' ``DLaaSCore`` from one initial vector, and what a crashed
core must do with its jobs: free their device state once their task
bodies return, and write nothing durable after the crash.

Each drill runs at the reference's smoke sizes with ``device="cpu"``,
every core and store in its own ``tmp_path``."""
import io
import json
import os
import threading
import time

import numpy as np
import pytest

from repro.platform import cluster as jax_cluster
from repro.platform import faults as jax_faults
from repro.platform import watchdog as jax_watchdog
from repro.runtime import learner as jax_learner
from repro.service.core import DLaaSCore as JaxCore
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.cursor import GlobalCursor
from repro_torch.core.software_ps import SoftwareParameterServer
from repro_torch.platform import watchdog as port_watchdog
from repro_torch.platform.cluster import (Cluster, Node, Resources, RUNNING,
                                          Scheduler)
from repro_torch.platform.faults import (DRAIN, FaultEvent, FaultInjector,
                                         FaultSchedule, KILL)
from repro_torch.platform.lcm import JobSpec, LifecycleManager
from repro_torch.platform.metrics import MetricsService
from repro_torch.platform.storage import LocalFSStore, StorageManager
from repro_torch.platform.zookeeper import ZooKeeper
from repro_torch.runtime.learner import (PLUGINS, LearnerJobConfig,
                                         make_learner_body)
from repro_torch.service.core import DLaaSCore
from util_parity import use_jax_vector
from util_poll import wait_until

PARITY_TOL = dict(atol=1e-4, rtol=1e-4)


def _stack(tmp_path):
    zk = ZooKeeper()
    cluster = Cluster([Node(f"n{i}", Resources(cpus=8, gpus=4,
                                               memory_mb=32000))
                       for i in range(3)])
    sched = Scheduler(cluster)
    lcm = LifecycleManager(zk, sched)
    storage = StorageManager()
    storage.register("results", LocalFSStore(str(tmp_path / "results")))
    metrics = MetricsService()
    return zk, sched, lcm, storage, metrics


def _drive(sched, lcm, job_id, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        sched.tick()
        st = lcm.monitor(job_id)
        if st in ("COMPLETED", "FAILED", "KILLED"):
            return st
        time.sleep(0.02)
    return lcm.job_state(job_id)


def _mlp_ps(cfg, n_shards, lr, **kw):
    """The job's plugin (on the CPU) and a PS on its seed-0 vector."""
    plugin = PLUGINS["repro-mlp"](cfg.framework_cfg, device="cpu")
    ps = SoftwareParameterServer(plugin.flat_state(0), n_shards=n_shards,
                                 n_learners=cfg.n_learners,
                                 optimizer="sgd", lr=lr, device="cpu",
                                 **kw)
    return plugin, ps


# ---------------------------------------------- tests/test_fault_tolerance.py
def test_crash_restart_resumes_from_checkpoint(tmp_path):
    zk, sched, lcm, storage, metrics = _stack(tmp_path)
    cfg = LearnerJobConfig(
        job_id="ft1", framework="repro-mlp",
        framework_cfg={"d_in": 16, "n_classes": 4},
        n_learners=2, steps=40, lr=0.3, checkpoint_every=10,
        checkpoint_dir=str(tmp_path / "ckpt"),
        fail_at_step={0: 17})           # learner 0 crashes at step 17
    plugin, ps = _mlp_ps(cfg, 4, 0.3)
    cursor = GlobalCursor(zk, "/jobs/ft1/cursor", dataset_size=512)
    body = make_learner_body(cfg, ps, cursor, storage, metrics, {},
                             plugin=plugin)
    lcm.submit(JobSpec(job_id="ft1", learners=2, learner_body=body,
                       ps_body=lambda wd: None))

    assert _drive(sched, lcm, "ft1", timeout=90) == "COMPLETED"
    app = sched.apps["ft1-learners"]
    assert any(t.restarts > 0 for t in app.tasks.values()), \
        "the injected crash must have caused a restart"
    assert max(metrics.series("ft1", "loss").steps) >= 39
    assert metrics.events("ft1", "checkpoint"), "checkpoints were persisted"
    assert len(storage.download("results", "ft1", "trained_model.npy")) > 0


def test_user_error_fails_job_without_restart(tmp_path):
    zk, sched, lcm, storage, metrics = _stack(tmp_path)
    cfg = LearnerJobConfig(
        job_id="ft2", framework="repro-mlp",
        framework_cfg={"d_in": 8, "n_classes": 2},
        n_learners=1, steps=20, user_error_at=3, checkpoint_dir=None)
    plugin, ps = _mlp_ps(cfg, 2, 0.1)
    cursor = GlobalCursor(zk, "/jobs/ft2/cursor", dataset_size=128)
    body = make_learner_body(cfg, ps, cursor, storage, metrics,
                             plugin=plugin)
    lcm.submit(JobSpec(job_id="ft2", learners=1, learner_body=body))
    assert _drive(sched, lcm, "ft2", timeout=30) == "FAILED"
    app = sched.apps["ft2-learners"]
    assert all(t.restarts == 0 for t in app.tasks.values())


class _Throttled:
    """Watchdog proxy that slows the learner to one step per ``delay``
    seconds, so a step-triggered fault lands on a RUNNING job."""

    def __init__(self, wd, delay):
        self._wd = wd
        self._delay = delay

    def heartbeat(self, *a, **kw):
        time.sleep(self._delay)
        return self._wd.heartbeat(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._wd, name)


def test_chaos_kill_node_under_ps_learners_mid_round(tmp_path):
    """Kill the node hosting the PS learners mid-BSP-round: they are
    requeued, resume from the last checkpoint on another node and the job
    completes with the model uploaded."""
    zk, sched, lcm, storage, metrics = _stack(tmp_path)
    cfg = LearnerJobConfig(
        job_id="chaos1", framework="repro-mlp",
        framework_cfg={"d_in": 16, "n_classes": 4},
        n_learners=2, steps=40, lr=0.3, checkpoint_every=5,
        checkpoint_dir=str(tmp_path / "ckpt"))
    plugin, ps = _mlp_ps(cfg, 4, 0.3)
    cursor = GlobalCursor(zk, "/jobs/chaos1/cursor", dataset_size=512)
    inner = make_learner_body(cfg, ps, cursor, storage, metrics,
                              plugin=plugin)
    body = lambda wd, idx: inner(_Throttled(wd, 0.01), idx)
    sched.faults = FaultInjector(FaultSchedule([
        FaultEvent(KILL, "n0", at_step=15, job_id="chaos1")]),
        lcm=lcm, metrics=metrics)
    lcm.submit(JobSpec(job_id="chaos1", learners=2, learner_body=body,
                       ps_body=lambda wd: None))
    assert _drive(sched, lcm, "chaos1", timeout=120) == "COMPLETED"
    assert sched.faults.done() and sched.faults.fired[0]["applied"]
    assert not sched.cluster.nodes["n0"].alive
    app = sched.apps["chaos1-learners"]
    assert any(t.restarts > 0 for t in app.tasks.values()), \
        "the node kill must have restarted the learners"
    assert max(metrics.series("chaos1", "loss").steps) >= cfg.steps - 1
    assert metrics.events("chaos1", "checkpoint")
    assert len(storage.download("results", "chaos1",
                                "trained_model.npy")) > 0
    assert metrics.counters("cluster").get("faults_kill") == 1


CHAOS_PJIT_MANIFEST = """
name: chaos-pjit
learners: 1
gpus: 2
steps: 60
checkpoint_every: 10
lr: 0.1
optimizer: sgd
seed: 0
batch_docs: 4
data:
  n_docs: 128
  seq_len: 16
framework:
  name: repro-lm
  arch: stablelm-1.6b
  distribution: pjit
"""


def test_chaos_drain_node_under_pjit_gang(tmp_path):
    """Drain the node under a running pjit gang: the gang is requeued,
    re-places on the other node, restores its checkpoint and completes."""
    cluster = Cluster([Node(f"g{i}", Resources(cpus=16, gpus=2,
                                               memory_mb=64000))
                       for i in range(2)])
    core = DLaaSCore(str(tmp_path), cluster=cluster, device="cpu")
    try:
        mid = core.deploy_model(CHAOS_PJIT_MANIFEST)["model_id"]
        tid = core.create_training(mid)["training_id"]
        assert wait_until(
            lambda: core.metrics.checkpoints(tid)
            and core.training_status(tid)["steps_done"] >= 20,
            timeout=120), "no mid-training checkpoint in time"
        core.pause_training(tid)
        app = core.scheduler.apps[f"{tid}-workers"]
        victim = next(t.node for t in app.tasks.values()
                      if t.state == RUNNING)
        core.drain_node(victim)
        assert wait_until(
            lambda: any("resumed from checkpoint" in line
                        for line in core.training_logs(tid)),
            timeout=120), "drained pjit gang did not resume"
        assert all(t.node != victim for t in app.tasks.values())
        core.resume_training(tid)
        assert core.wait_for(tid, timeout=240) == "COMPLETED"
        assert core.training_status(tid)["steps_done"] >= 60
        n = core.cluster.nodes[victim]
        assert n.draining and n.free.gpus == n.capacity.gpus
        assert len(core.download_model(tid)) > 0
    finally:
        core.close()


def test_chaos_kill_serving_node_mid_request(tmp_path):
    """Kill the node under a serving endpoint while a request waits: the
    endpoint re-places on the surviving node and the request completes
    with the tokens of an undisturbed endpoint. The new incarnation's
    engine starts only after the killed one's serve loop has exited (the
    scheduler places no task whose previous incarnation still runs)."""
    cluster = Cluster([Node(f"s{i}", Resources(cpus=16, gpus=1,
                                               memory_mb=64000))
                       for i in range(2)])
    core = DLaaSCore(str(tmp_path), cluster=cluster, device="cpu")
    try:
        eid = core.deploy_endpoint(arch="stablelm-1.6b")["endpoint_id"]
        assert wait_until(
            lambda: core.endpoint_status(eid)["state"] == "READY",
            timeout=120), "endpoint never became READY"
        want = core.predict(eid, [4, 5, 6], max_new=2)["tokens"]
        eng = core.endpoints[eid].engine
        app = core.scheduler.apps[f"{eid}-servers"]
        (task_id,) = app.tasks
        killed = core.scheduler._threads[task_id]
        old_run_alive = []
        start = eng.start

        def logged_start(*a, **kw):
            old_run_alive.append(killed.is_alive())
            return start(*a, **kw)
        eng.start = logged_start
        core.pause_training(eid)       # hold serving at a batch boundary
        req = eng.submit([4, 5, 6], max_new=2)
        victim = next(t.node for t in app.tasks.values()
                      if t.state == RUNNING)
        core.inject_faults(events=[
            FaultEvent(KILL, victim, at_tick=core.cluster.clock + 1)])
        assert wait_until(
            lambda: any(t.state == RUNNING and t.node != victim
                        for t in app.tasks.values()),
            timeout=60), "endpoint was not re-placed after the kill"
        core.resume_training(eid)
        assert req.wait(120) and req.status == "DONE", req.status
        assert req.tokens == want
        assert core.scheduler.faults.done()
        assert core.endpoint_status(eid)["state"] == "READY"
        assert old_run_alive == [False]
        core.stop_endpoint(eid)
    finally:
        core.close()


# ------------------------------------------------ scripts/verify.sh replay
def _transitions(pkg, seed):
    """verify.sh's seeded drill: 2 nodes, 4 KILL/DRAIN events over 10
    ticks, 12 ticks; the cluster's transition log."""
    cl, fl = pkg
    c = cl.Cluster([cl.Node(f"n{i}", cl.Resources(cpus=8, gpus=2,
                                                  memory_mb=16000))
                    for i in range(2)])
    s = cl.Scheduler(c)
    s.faults = fl.FaultInjector(fl.FaultSchedule.seeded(
        seed, sorted(c.nodes), n_events=4, horizon=10,
        kinds=(fl.KILL, fl.DRAIN)))
    for _ in range(12):
        s.tick()
    assert s.faults.done()
    return list(c.transitions)


@pytest.mark.parametrize("seed", [29, 7, 11])
def test_seeded_drill_replays_the_reference_transitions(seed):
    from repro_torch.platform import cluster as port_cluster
    from repro_torch.platform import faults as port_faults
    port = _transitions((port_cluster, port_faults), seed)
    assert port, "the seeded drill made no transition"
    assert port == _transitions((port_cluster, port_faults), seed)
    assert port == _transitions((jax_cluster, jax_faults), seed)
    assert KILL == jax_faults.KILL and DRAIN == jax_faults.DRAIN


# --------------------------------------------- the crash drill against JAX
LM_MANIFEST = {
    "name": "crash-lm", "learners": 1, "steps": 6, "checkpoint_every": 3,
    "lr": 2e-3, "optimizer": "sgd", "seed": 3, "batch_docs": 2,
    "ps_shards": 2, "data": {"n_docs": 128, "seq_len": 32},
    "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
CRASH_AT = 3                    # CRASH_CORE once step 3 of 6 is done


@pytest.fixture(scope="module")
def jax_lm():
    """One JAX LM plugin for the module (its jits compile once)."""
    return jax_learner.LMPlugin({"arch": "stablelm-1.6b"})


def _slow_heartbeats(monkeypatch, seconds):
    """Each heartbeat, once written, holds its learner ``seconds``: the
    crash (fired by the tick after it) lands before the next step's
    boundary in both packages, so both resume from the same checkpoint."""
    for mod in (port_watchdog, jax_watchdog):
        beat = mod.Watchdog.heartbeat

        def slow(self, *a, _beat=beat, **kw):
            out = _beat(self, *a, **kw)
            time.sleep(seconds)
            return out
        monkeypatch.setattr(mod.Watchdog, "heartbeat", slow)


def _crash_drill(make_core, workdir, fault):
    c1 = make_core(workdir)
    mid = c1.deploy_model(json.dumps(LM_MANIFEST))["model_id"]
    tid = c1.create_training(mid, idempotency_key="sub-1")["training_id"]
    c1.inject_faults(events=[fault("crash_core", "", at_step=CRASH_AT,
                                   job_id=tid)])
    assert wait_until(lambda: c1.crashed, timeout=120), "crash never fired"
    c2 = make_core(workdir)
    try:
        rep = c2.recovery_report()
        assert c2.create_training(mid, idempotency_key="sub-1")[
            "training_id"] == tid
        assert wait_until(
            lambda: c2.lcm.job_state(tid) in ("COMPLETED", "FAILED"),
            timeout=240), c2.lcm.job_state(tid)
        st = c2.training_status(tid)
        resumed = [line for line in c2.training_logs(tid)
                   if "resumed from checkpoint" in line]
        model = np.load(io.BytesIO(c2.download_model(tid)))
    finally:
        c2.close()
        c1.close()
    return tid, rep, st, resumed, model


def test_crash_drill_matches_the_jax_core(tmp_path, monkeypatch, jax_lm):
    """CRASH_CORE at step 3 of 6 through both packages' cores from JAX's
    initial vector: the same resumed step, the same recovery lists, and
    the final loss and trained model within PARITY_TOL."""
    monkeypatch.setenv("DLAAS_PERF", "0")
    monkeypatch.setenv("DLAAS_JAX_CACHE", "0")
    use_jax_vector(monkeypatch, LM_MANIFEST, jax_lm)
    _slow_heartbeats(monkeypatch, 0.5)
    jtid, jrep, jst, jres, jmodel = _crash_drill(
        lambda wd: JaxCore(str(wd)), tmp_path / "jax",
        jax_faults.FaultEvent)
    ptid, prep, pst, pres, pmodel = _crash_drill(
        lambda wd: DLaaSCore(str(wd), device="cpu"), tmp_path / "port",
        FaultEvent)
    assert ptid == jtid
    assert pst["status"] == jst["status"] == "COMPLETED"
    assert pres == jres == [f"resumed from checkpoint step={CRASH_AT}"]
    for key in ("trainings", "endpoints"):
        assert prep[key] == jrep[key], key
    assert prep["trainings"]["resumed"] == [ptid]
    np.testing.assert_allclose(pst["last_loss"], jst["last_loss"],
                               **PARITY_TOL)
    assert pmodel.shape == jmodel.shape
    np.testing.assert_allclose(pmodel, jmodel, **PARITY_TOL)


# --------------------------------------------------- what crash() leaves
MLP_LONG = """
name: long-mlp
learners: 2
gpus: 1
steps: 100000
checkpoint_every: 1000
compression: int8
framework:
  name: repro-mlp
  d_in: 16
  n_classes: 4
"""


def test_crash_frees_the_zombies_servers_and_engines(tmp_path):
    """A crashed core frees each training's parameter server and each
    endpoint's engine once their task bodies have returned, as a killed
    process's device memory goes with it (its ticker, which does this
    for a live core, has stopped)."""
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    mid = core.deploy_model(MLP_LONG)["model_id"]
    tid = core.create_training(mid)["training_id"]
    eid = core.deploy_endpoint(arch="stablelm-1.6b")["endpoint_id"]
    assert wait_until(
        lambda: core.endpoint_status(eid)["state"] == "READY"
        and core.training_status(tid)["steps_done"] >= 5, timeout=120)
    ps = core.trainings[tid]["plan"].meta["ps"]
    eng = core.endpoints[eid].engine
    core.crash()
    assert wait_until(lambda: core._tasks_returned(tid)
                      and core._tasks_returned(eid), timeout=60)
    assert wait_until(lambda: ps.released and eng.released, timeout=10)
    assert ps._params is None and eng.params is None
    assert core.trainings[tid]["plan"].meta["ps"] is None
    assert core.training_status(tid)["data_plane"]["push_count"] > 0
    core.close()


def test_crashed_core_writes_no_checkpoint(tmp_path, monkeypatch):
    """A learner mid-step when its core crashes does not publish the
    checkpoint that ends the step: a killed process could not, and a
    recovering core would adopt it."""
    _slow_heartbeats(monkeypatch, 1.0)
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    mid = core.deploy_model(
        "name: fenced\nlearners: 1\ngpus: 1\nsteps: 50\n"
        "checkpoint_every: 5\nframework:\n  name: repro-mlp\n"
        "  d_in: 16\n  n_classes: 4\n")["model_id"]
    tid = core.create_training(mid)["training_id"]
    # fires during step 4's heartbeat: step 4 ends on checkpoint 5
    core.inject_faults(events=[FaultEvent("crash_core", "", at_step=4,
                                          job_id=tid)])
    assert wait_until(lambda: core.crashed, timeout=60)
    assert wait_until(lambda: core._tasks_returned(tid), timeout=60)
    assert CheckpointManager(f"{tmp_path}/w/ckpt/{tid}").steps() == []
    assert not core.storage.get_store("results").exists(
        tid, "trained_model.npy")
    core.close()


def test_a_learner_leaving_frees_its_client_buffers(tmp_path):
    """A learner that raises frees its client's error-feedback buffer as
    it leaves, even while a caller keeps the exception (and with it the
    learner's frames)."""
    zk = ZooKeeper()
    storage = StorageManager()
    storage.register("results", LocalFSStore(str(tmp_path / "results")))
    cfg = LearnerJobConfig(
        job_id="leave", framework="repro-mlp",
        framework_cfg={"d_in": 16, "n_classes": 4}, n_learners=1,
        steps=10, lr=0.1, compression="int8", checkpoint_dir=None,
        fail_at_step={0: 3})
    plugin, ps = _mlp_ps(cfg, 2, 0.1, compression="int8")
    cursor = GlobalCursor(zk, "/jobs/leave/cursor", dataset_size=128)
    body = make_learner_body(cfg, ps, cursor, storage, MetricsService(),
                             plugin=plugin)
    wd = port_watchdog.Watchdog(zk, "leave", "learner-0")
    kept = []
    try:
        wd.run(lambda w: body(w, 0))
    except RuntimeError as e:
        kept.append(e)          # holds the learner's frames
    assert kept and ps.active == 0
    clients = list(ps._clients)
    assert len(clients) == 1
    assert clients[0]._err is None and clients[0]._stage is None


def test_adam_resume_restarts_the_servers_moments(tmp_path, monkeypatch):
    """A learner's checkpoint holds the weights only (as the
    reference's): a job recovered on a new core runs on a new PS whose
    Adam step count, and so its moments, start from zero at the resumed
    step. An exact recovery needs a server solver without state."""
    _slow_heartbeats(monkeypatch, 0.1)
    wd = tmp_path / "w"
    c1 = DLaaSCore(str(wd), device="cpu")
    mid = c1.deploy_model(
        "name: adam\nlearners: 1\ngpus: 1\nsteps: 40\n"
        "checkpoint_every: 10\noptimizer: adam\nlr: 0.01\n"
        "framework:\n  name: repro-mlp\n  d_in: 16\n"
        "  n_classes: 4\n")["model_id"]
    tid = c1.create_training(mid)["training_id"]
    zombie_ps = c1.trainings[tid]["plan"].meta["ps"]
    c1.inject_faults(events=[FaultEvent("crash_core", "", at_step=15,
                                        job_id=tid)])
    assert wait_until(lambda: c1.crashed, timeout=60)
    assert wait_until(lambda: zombie_ps.released, timeout=60)
    c2 = DLaaSCore(str(wd), device="cpu")
    try:
        ps = c2.trainings[tid]["plan"].meta["ps"]
        assert c2.wait_for(tid, timeout=120) == "COMPLETED"
        resumed = [int(line.rsplit("=", 1)[1])
                   for line in c2.training_logs(tid)
                   if line.startswith("resumed from checkpoint step=")]
        assert resumed == [10]
        assert zombie_ps._step > resumed[0]
        assert ps._step == 40 - resumed[0]
    finally:
        c2.close()
        c1.close()


def test_a_restarted_learner_waits_for_learner_0s_checkpoint(tmp_path):
    """A learner other than 0 restarted while learner 0's checkpoint is
    still being written (learner 0's own restart waits for that write)
    resumes from it too, so the two learners run the same steps."""
    zk = ZooKeeper()
    storage = StorageManager()
    storage.register("results", LocalFSStore(str(tmp_path / "results")))
    metrics = MetricsService()
    ckdir = tmp_path / "ckpt"
    cfg = LearnerJobConfig(
        job_id="late", framework="repro-mlp",
        framework_cfg={"d_in": 16, "n_classes": 4}, n_learners=2,
        steps=6, lr=0.1, checkpoint_dir=str(ckdir), checkpoint_every=100)
    plugin, ps = _mlp_ps(cfg, 2, 0.1, trigger="on_arrival")
    cursor = GlobalCursor(zk, "/jobs/late/cursor", dataset_size=128)
    body = make_learner_body(cfg, ps, cursor, storage, metrics,
                             plugin=plugin)
    # learner 0's checkpoint 4, written but not yet published (renamed
    # from its .tmp directory, as CheckpointManager does)
    CheckpointManager(str(tmp_path / "stage")).save(
        4, {"flat": plugin.flat_state(0)},
        extra={"step": 4, "epoch": 0, "offset": 0}, block=True)
    ckdir.mkdir()
    writing = ckdir / "step_0000000004.tmp"
    os.rename(tmp_path / "stage" / "step_0000000004", writing)

    def learner_0_publishes():
        time.sleep(0.5)
        os.rename(writing, ckdir / "step_0000000004")
    writer = threading.Thread(target=learner_0_publishes)
    writer.start()
    wd = port_watchdog.Watchdog(zk, "late", "learner-1")
    wd.run(lambda w: body(w, 1))
    writer.join()
    logs = [zk.get(f"{wd.base}/log/{c}")[0].decode()
            for c in zk.children(f"{wd.base}/log")]
    assert "resumed from checkpoint step=4" in logs
    assert metrics.series("late", "loss").steps == [4, 5]
