"""The port's learner runtime against the JAX package's: the same
learner body on threads, under each package's own watchdog, ZooKeeper,
cursor, storage, metrics and software PS, trains from one flat vector
to the same PS params (1e-4, atol and rtol: the steps' gradients agree
to ~1e-5 and six updates add up); checkpoints written by one package
restore in the other; a port run resumes from its newest checkpoint;
and the platform modules the port copied are the reference's code.

All on the CPU (``device="cpu"``), at the reference plugin's smoke size
(``reduce_for_smoke(stablelm-1.6b)``, f32)."""
import ast
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.core.cursor import GlobalCursor as JaxCursor
from repro.core.software_ps import SoftwareParameterServer as JaxPS
from repro.platform.metrics import MetricsService as JaxMetrics
from repro.platform.storage import LocalFSStore as JaxFS
from repro.platform.storage import StorageManager as JaxStorage
from repro.platform.watchdog import Watchdog as JaxWatchdog
from repro.platform.zookeeper import ZooKeeper as JaxZK
from repro.runtime import learner as jax_learner
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.cursor import Chunk, GlobalCursor
from repro_torch.core import software_ps
from repro_torch.core.software_ps import SoftwareParameterServer
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.errors import UserError
from repro_torch.platform.metrics import MetricsService
from repro_torch.platform.storage import LocalFSStore, StorageManager
from repro_torch.platform.watchdog import JOB_FAILED, Watchdog
from repro_torch.platform.zookeeper import ZooKeeper
from repro_torch.runtime import learner as port_learner

ROOT = Path(__file__).resolve().parents[1]
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)

PORT = dict(zk=ZooKeeper, storage=StorageManager, fs=LocalFSStore,
            metrics=MetricsService, ps=SoftwareParameterServer,
            cursor=GlobalCursor, watchdog=Watchdog, learner=port_learner,
            ps_kw={"device": "cpu"})
# The reference's learner pulls as soon as it has joined its PS, and its
# BSP barrier counts only the members joined so far: a learner thread
# that starts late lets the other finish round 0 alone and takes its own
# step 0 on those weights. ``prejoin`` joins every slot before the
# threads start (the PS's own ``join``), so the reference cannot race;
# the port's learner waits at its PS's start barrier instead.
JAX = dict(zk=JaxZK, storage=JaxStorage, fs=JaxFS, metrics=JaxMetrics,
           ps=JaxPS, cursor=JaxCursor, watchdog=JaxWatchdog,
           learner=jax_learner, ps_kw={}, prejoin=True)


@pytest.fixture(scope="module")
def plugins():
    """One plugin per package for the whole module (JAX's jit compiles
    once) and JAX's own initial flat vector."""
    jp = jax_learner.LMPlugin({"arch": "stablelm-1.6b"})
    tp = port_learner.LMPlugin({"arch": "stablelm-1.6b"}, device="cpu")
    return {"jax": jp, "port": tp, "flat": jp.flat_state(0)}


def _train(pkg, plugin, flat, workdir, *, job="j", n_learners=2, steps=6,
           optimizer="sgd", lr=0.1, compression="none", ckpt_every=None,
           user_error_at=None, zk=None, slots=None):
    """Run the package's learner body on ``n_learners`` threads (or only
    on ``slots``) under its watchdog; returns (final PS params, {step:
    sorted losses}, zk, failures, results)."""
    zk = zk or pkg["zk"]()
    storage = pkg["storage"]()
    storage.register("results", pkg["fs"](str(workdir / "results")))
    metrics = pkg["metrics"]()
    ps = pkg["ps"](flat, n_shards=2, n_learners=n_learners,
                   optimizer=optimizer, lr=lr, compression=compression,
                   **pkg["ps_kw"])
    cursor = pkg["cursor"](zk, f"/jobs/{job}/cursor", dataset_size=512)
    cfg = pkg["learner"].LearnerJobConfig(
        job_id=job, n_learners=n_learners, batch_docs=2, steps=steps,
        lr=lr, optimizer=optimizer, compression=compression,
        checkpoint_dir=(str(workdir / "ckpt") if ckpt_every else None),
        checkpoint_every=ckpt_every or 20, user_error_at=user_error_at)
    if pkg.get("prejoin"):
        for i in range(n_learners):
            ps.join(i)
    results = {}
    body = pkg["learner"].make_learner_body(cfg, ps, cursor, storage,
                                            metrics, results, plugin=plugin)
    failures = []

    def run(i):
        wd = pkg["watchdog"](zk, job, f"learner-{i}")
        try:
            wd.run(lambda w: body(w, i))
        except Exception as e:          # reported to the test below
            failures.append(e)

    ts = [threading.Thread(target=run, args=(i,))
          for i in (range(n_learners) if slots is None else slots)]
    [t.start() for t in ts]
    [t.join(300) for t in ts]
    assert not any(t.is_alive() for t in ts)
    series = metrics.series(job, "loss")
    losses = {}
    for s, v in zip(series.steps, series.values):
        losses.setdefault(s, []).append(v)
    final = ps.pull(0)
    final = final.numpy() if isinstance(final, torch.Tensor) \
        else np.array(final)
    return final, {s: sorted(v) for s, v in losses.items()}, zk, failures, \
        results


# Learning rates that keep six steps out of the chaotic regime: at SGD
# lr 0.1 on this randomly initialised model the two frameworks' rounding
# differences grow step by step past any useful tolerance.
@pytest.mark.parametrize("n_learners,optimizer,lr,compression", [
    (2, "sgd", 2e-3, "none"),
    (2, "adam", 3e-4, "none"),
    (1, "sgd", 2e-3, "int8"),
])
def test_learner_body_matches_jax(plugins, tmp_path, n_learners, optimizer,
                                  lr, compression):
    flat = plugins["flat"]
    kw = dict(n_learners=n_learners, optimizer=optimizer, lr=lr,
              compression=compression)
    want, jlosses, _, jfail, _ = _train(JAX, plugins["jax"], flat,
                                        tmp_path / "jax", **kw)
    got, losses, _, fail, results = _train(PORT, plugins["port"], flat,
                                           tmp_path / "port", **kw)
    assert fail == [] and jfail == []
    assert sorted(losses) == list(range(6))
    for s in range(6):
        np.testing.assert_allclose(losses[s], jlosses[s], atol=1e-4,
                                   rtol=1e-4)
    assert np.abs(got - flat).max() > 10 * PARAM_TOL["atol"]   # it moved
    np.testing.assert_allclose(got, want, **PARAM_TOL)
    np.testing.assert_array_equal(results["params"], got)


class _Learner0Blocked(SoftwareParameterServer):
    """The port's PS, with an event set once learner 0 can go no further
    alone: it waits at the start barrier, or its first push returned."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.blocked = threading.Event()

    def start(self, learner_id):
        if learner_id == 0:
            self.blocked.set()
        return super().start(learner_id)

    def push(self, learner_id, payload, timeout=30.0):
        ok = super().push(learner_id, payload, timeout=timeout)
        if learner_id == 0:
            self.blocked.set()
        return ok


def test_late_learner_takes_step_0_on_the_initial_weights(plugins,
                                                          tmp_path):
    """Learner 1's thread reaches its PS only once learner 0 can go no
    further alone: learner 0 must wait for it at the start barrier, not
    finish round 0 by itself, so both step-0 losses are those of the
    initial weights on the first two chunks and the run ends where the
    JAX package's ends."""
    made = []

    def ps(*a, **kw):
        made.append(_Learner0Blocked(*a, **kw))
        return made[-1]

    def watchdog(zk, job, member):
        if member == "learner-1":
            assert made[0].blocked.wait(60)
        return Watchdog(zk, job, member)
    flat, port = plugins["flat"], plugins["port"]
    kw = dict(optimizer="adam", lr=3e-4)
    got, losses, _, fail, _ = _train(dict(PORT, ps=ps, watchdog=watchdog),
                                     port, flat, tmp_path / "port", **kw)
    assert fail == []
    corpus = SyntheticCorpus(port.dataset_spec({}))
    want0 = sorted(float(port.flat_loss_grad(
        flat, corpus.batch_for([Chunk(0, 2 * i, 2 * i + 2)]))[0])
        for i in range(2))
    np.testing.assert_allclose(losses[0], want0, atol=1e-6, rtol=1e-6)
    want, *_ = _train(JAX, plugins["jax"], flat, tmp_path / "jax", **kw)
    np.testing.assert_allclose(got, want, **PARAM_TOL)


def test_start_barrier_times_out_and_trains_with_the_learners_that_started(
        plugins, tmp_path, monkeypatch):
    """A job of two slots of which only learner 0 ever starts: learner 0
    waits ``BSP_TIMEOUT_S`` at the start barrier, logs it, then trains
    alone, and ends where the JAX package's learner 0 ends alone (its
    BSP rounds count the one member)."""
    monkeypatch.setattr(software_ps, "BSP_TIMEOUT_S", 0.5)
    flat = plugins["flat"]
    kw = dict(optimizer="sgd", lr=2e-3, slots=(0,))
    got, losses, zk, fail, _ = _train(PORT, plugins["port"], flat,
                                      tmp_path / "port", **kw)
    assert fail == []
    assert "start barrier timed out: training with the learners that " \
        "joined" in _log_lines(zk, "j", "learner-0")
    want, jlosses, _, jfail, _ = _train(dict(JAX, prejoin=False),
                                        plugins["jax"], flat,
                                        tmp_path / "jax", **kw)
    assert jfail == [] and sorted(losses) == sorted(jlosses) == \
        list(range(6))
    for s in range(6):
        np.testing.assert_allclose(losses[s], jlosses[s], atol=1e-4,
                                   rtol=1e-4)
    assert np.abs(got - flat).max() > 10 * PARAM_TOL["atol"]   # it moved
    np.testing.assert_allclose(got, want, **PARAM_TOL)


@pytest.mark.parametrize("trigger", ["bsp", "on_arrival"])
def test_start_barrier_opens_once_every_slot_has_started(trigger,
                                                         monkeypatch):
    """Under ``bsp`` a first start waits for the other slots (False once
    ``BSP_TIMEOUT_S`` has passed), the last slot to start opens the
    barrier, and a restarted learner then passes at once; under
    ``on_arrival``, which has no rounds, nobody waits."""
    monkeypatch.setattr(software_ps, "BSP_TIMEOUT_S", 0.2)
    ps = SoftwareParameterServer(np.zeros(64, np.float32), n_shards=2,
                                 n_learners=2, trigger=trigger,
                                 device="cpu")
    t0 = time.perf_counter()
    assert ps.start(0) is (trigger != "bsp")
    assert (time.perf_counter() - t0 >= 0.2) is (trigger == "bsp")
    monkeypatch.setattr(software_ps, "BSP_TIMEOUT_S", 60.0)
    t0 = time.perf_counter()
    assert ps.start(1) and ps.start(0)
    assert time.perf_counter() - t0 < 5


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"flat": torch.from_numpy(rng.standard_normal(300)
                                     .astype(np.float32)),
            "opt": {"m": rng.standard_normal((4, 3)).astype(np.float32),
                    "step": np.array(7, np.int64)}}
    ck = CheckpointManager(str(tmp_path), keep=2)
    ck.save(3, tree, extra={"step": 3, "epoch": 1, "offset": 5})
    ck.save(6, tree, extra={"step": 6, "epoch": 1, "offset": 9})
    ck.save(9, tree, extra={"step": 9, "epoch": 2, "offset": 1})
    ck.wait()
    assert ck.steps() == [6, 9]                   # keep-2 GC
    assert sorted(p.name for p in (tmp_path / "step_0000000009").iterdir()
                  ) == ["flat.npy", "manifest.json", "opt__m.npy",
                        "opt__step.npy"]
    jck = JaxCkpt(str(tmp_path))
    assert jck.latest_valid() == 9
    got, extra = jck.restore(9, {"flat": np.zeros(300, np.float32),
                                 "opt": {"m": np.zeros((4, 3)),
                                         "step": np.zeros((), np.int64)}})
    assert extra == {"step": 9, "epoch": 2, "offset": 1}
    np.testing.assert_array_equal(np.asarray(got["flat"]),
                                  tree["flat"].numpy())
    np.testing.assert_array_equal(np.asarray(got["opt"]["m"]),
                                  tree["opt"]["m"])
    assert int(got["opt"]["step"]) == 7


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    flat = np.random.RandomState(1).standard_normal(500).astype(np.float32)
    jck = JaxCkpt(str(tmp_path))
    jck.save(4, {"flat": flat}, extra={"step": 4, "epoch": 0,
                                       "offset": 8})
    jck.wait()
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_valid() == 4
    tree, extra = ck.restore(4, {"flat": None})
    assert extra == {"step": 4, "epoch": 0, "offset": 8}
    np.testing.assert_array_equal(tree["flat"], flat)
    # a corrupt leaf is skipped by latest_valid, in both packages
    (tmp_path / "step_0000000004" / "flat.npy").write_bytes(b"bitrot")
    assert ck.latest_valid() is None and jck.latest_valid() is None


def _log_lines(zk, job, member):
    base = f"/dlaas/jobs/{job}/members/{member}/log"
    return [zk.get(f"{base}/{c}")[0].decode() for c in zk.children(base)]


def test_checkpoint_snapshots_a_cpu_tensor_before_save_returns(
        tmp_path, monkeypatch):
    """The learner checkpoints its PS pull buffer, which its next pull
    overwrites in place: the checkpoint holds the values ``save`` saw,
    however late the writer thread serializes them (it waits here until
    the buffer has been overwritten)."""
    import threading

    import torch
    gate = threading.Event()
    write = CheckpointManager._write

    def gated(self, *a):
        assert gate.wait(30)
        write(self, *a)
    monkeypatch.setattr(CheckpointManager, "_write", gated)
    buf = torch.arange(8, dtype=torch.float32)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"flat": buf})
    buf.add_(100.0)                       # the next pull
    gate.set()
    ckpt.wait()
    tree, _ = ckpt.restore(1, {"flat": np.zeros(8, np.float32)})
    np.testing.assert_array_equal(tree["flat"], np.arange(8))


def test_port_run_resumes_from_checkpoint(plugins, tmp_path):
    """A 4-step run checkpoints at steps 2 and 4; a second run over the
    same directory resumes at step 4, logs it, and ends where an
    uninterrupted 6-step run ends."""
    flat = plugins["flat"]
    kw = dict(n_learners=1, job="r", ckpt_every=2)
    _train(PORT, plugins["port"], flat, tmp_path / "a", steps=4, **kw)
    assert CheckpointManager(str(tmp_path / "a" / "ckpt")).steps() == [2, 4]
    resumed, losses, zk, fail, _ = _train(PORT, plugins["port"], flat,
                                          tmp_path / "a", steps=6, **kw)
    assert fail == []
    assert "resumed from checkpoint step=4" in _log_lines(zk, "r",
                                                          "learner-0")
    assert sorted(losses) == [4, 5]
    straight, *_ = _train(PORT, plugins["port"], flat, tmp_path / "b",
                          steps=6, **kw)
    np.testing.assert_allclose(resumed, straight, atol=1e-6, rtol=1e-6)
    # the uploaded model is the final flat vector
    data = (tmp_path / "a" / "results" / "r" / "trained_model.npy")
    np.testing.assert_array_equal(np.load(data), resumed)


def test_user_error_fails_the_learner(plugins, tmp_path):
    _, losses, zk, fail, _ = _train(PORT, plugins["port"], plugins["flat"],
                                    tmp_path, n_learners=1, job="u",
                                    user_error_at=2)
    assert len(fail) == 1 and isinstance(fail[0], UserError)
    assert sorted(losses) == [0, 1]
    status = zk.get("/dlaas/jobs/u/members/learner-0/status")[0].decode()
    assert JOB_FAILED in status


COPIES = ["platform/journal.py", "platform/zookeeper.py",
          "platform/watchdog.py", "platform/storage.py",
          "platform/metrics.py", "platform/queue.py", "platform/lcm.py",
          "platform/cluster.py", "platform/faults.py",
          "platform/autoscale.py", "platform/health.py",
          "observability/stream.py", "observability/trace.py",
          "observability/log.py", "observability/slo.py",
          "observability/export.py", "service/manifest.py",
          "service/cli.py", "core/cursor.py", "data/pipeline.py",
          "kernels/grid.py"]


def _logger(name, var="log", indent=""):
    """A logger of the ``"repro"`` tree renamed into ``"repro_torch"``."""
    sub = f".{name}" if name else ""
    return ([f'{indent}{var} = logging.getLogger("repro{sub}")'],
            [f'{indent}{var} = logging.getLogger("repro_torch{sub}")'])


# The stated differences of the copies beyond their docstrings and their
# imports of the package: (the reference's lines, the port's lines in
# their place).
#   * platform/cluster.py takes ``_UserError`` and ``_Preempted`` from
#     ``repro_torch.errors`` (the classes its Watchdog re-raises), so the
#     reference's own definitions of the two classes are absent from it.
#   * Every logger of the port is under the ``"repro_torch"`` tree that
#     its observability/log.py sets up, never the reference's ``"repro"``:
#     one tree for both packages would hand the port's job lines to the
#     reference's log hubs in a process that loads both.
#   * platform/lcm.py's ``_set`` writes a znode that another thread
#     created between its check and its create, where the reference's
#     raises ``NodeExistsError`` (test_lcm_set_survives_a_concurrent_create).
#   * platform/lcm.py's ``JobControl`` has ``fence()`` / ``fenced``, which
#     ``DLaaSCore.crash()`` sets so that the crashed core's learners write
#     no checkpoint and no model
#     (tests/test_torch_fault_tolerance.py::test_crashed_core_writes_no_checkpoint).
REFERENCE_ONLY = {
    "platform/lcm.py": [
        (["                self.zk.create(path, data, makepath=True)"],
         ["                try:",
          "                    self.zk.create(path, data, makepath=True)",
          "                except NodeExistsError:     # created since the "
          "check",
          "                    self.zk.set(path, data)"]),
        (["        self._ckpt = threading.Event()"],
         ["        self._ckpt = threading.Event()",
          "        self._fence = threading.Event()"]),
        (["    def wait_while_paused(self, should_abort: Optional[Callable] "
          "= None):"],
         ["    def fence(self):",
          '        """The service that ran this job crashed: its task '
          "bodies write",
          '        nothing durable (checkpoint, model) from now on."""',
          "        self._fence.set()",
          "",
          "    @property",
          "    def fenced(self) -> bool:",
          "        return self._fence.is_set()",
          "",
          "    def wait_while_paused(self, should_abort: Optional[Callable] "
          "= None):"])],
    "platform/cluster.py": [
        (["class _UserError(Exception):",
          '    """Raised by task bodies for errors in user input/code '
          '(no restart)."""',
          "",
          "class _Preempted(Exception):",
          '    """Raised inside a task body when the scheduler preempted '
          'the task;',
          "    the task is already back in the queue and resumes from "
          'checkpoint."""',
          ""], []),
        _logger("cluster")],
    "platform/zookeeper.py": [_logger("zk")],
    "platform/watchdog.py": [_logger("job", var="job_log")],
    "platform/metrics.py": [_logger("metrics")],
    "platform/health.py": [_logger("health")],
    "observability/trace.py": [_logger("trace")],
    "observability/log.py": [_logger("", var="root", indent="    ")],
    "observability/slo.py": [_logger("slo")],
    "observability/export.py": [_logger("export")],
    "kernels/grid.py": [_logger("kernels.grid")],
}


def _is_package_import(node):
    return isinstance(node, ast.ImportFrom) and node.module and \
        re.match(r"repro(_torch)?(\.|$)", node.module)


def _code_after_docstring(path: Path):
    """The module's lines after its docstring, without the lines of its
    imports of ``repro`` / ``repro_torch`` (top level or nested, over as
    many lines as each spans), and runs of blank lines as one."""
    src = path.read_text()
    tree = ast.parse(src)
    body = tree.body
    start = body[0].end_lineno if isinstance(body[0], ast.Expr) else 0
    skip = set()
    for node in ast.walk(tree):
        if _is_package_import(node):
            skip.update(range(node.lineno, node.end_lineno + 1))
    out = []
    for no, line in enumerate(src.splitlines(), 1):
        if no > start and no not in skip and (line or out and out[-1]):
            out.append(line)
    return out


def _replaced(lines, old, new):
    """``lines`` with the one run of consecutive lines equal to ``old``
    replaced by ``new`` (an AssertionError when there is no such run)."""
    for i in range(len(lines) - len(old) + 1):
        if lines[i:i + len(old)] == old:
            return lines[:i] + new + lines[i + len(old):]
    raise AssertionError(f"reference lines not found: {old[:1]}")


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_are_the_reference_code(rel):
    """The port's copies differ from the reference only in their
    docstring, their imports of the package itself and the differences
    REFERENCE_ONLY names."""
    port = ROOT / "src" / "repro_torch" / rel
    assert f"``repro/{rel}``" in ast.get_docstring(ast.parse(
        port.read_text()))
    want = _code_after_docstring(ROOT / "src" / "repro" / rel)
    for old, new in REFERENCE_ONLY.get(rel, ()):
        want = _replaced(want, old, new)
    assert _code_after_docstring(port) == want


def test_cluster_copy_raises_the_ports_error_classes():
    from repro_torch import errors
    from repro_torch.platform import cluster
    assert cluster.UserError is cluster._UserError is errors.UserError
    assert cluster.Preempted is cluster._Preempted is errors.Preempted


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_lcm_set_survives_a_concurrent_create(pkg):
    """Two threads in ``LifecycleManager.monitor`` (the service's tick
    loop and a status request) both find no ``progress`` znode, and one
    creates it first: the port's ``_set`` then writes it, where the
    reference's create raises ``NodeExistsError``."""
    import importlib
    import json
    zkmod = importlib.import_module(f"{pkg}.platform.zookeeper")
    cluster = importlib.import_module(f"{pkg}.platform.cluster")
    lcm_mod = importlib.import_module(f"{pkg}.platform.lcm")
    zk = zkmod.ZooKeeper()
    lcm = lcm_mod.LifecycleManager(zk, cluster.Scheduler(cluster.Cluster(
        [cluster.Node("n0", cluster.Resources(cpus=4, gpus=1,
                                              memory_mb=1024))])))
    path = "/dlaas/jobs/job-r/progress"
    checked = zk.exists

    def exists(p):
        # the other thread's create lands between this check and ours
        found = checked(p)
        if p == path and not found:
            zk.create(path, b"{}", makepath=True)
        return found
    zk.exists = exists
    write = lambda: lcm._set("job-r", "progress", {"alive": 1})
    if pkg == "repro":
        with pytest.raises(zkmod.NodeExistsError):
            write()
        return
    write()
    assert json.loads(zk.get(path)[0]) == {"alive": 1}
