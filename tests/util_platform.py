"""One package's platform for the backend and endpoint tests.

``Platform("repro", ...)`` or ``Platform("repro_torch", ...)`` wires that
package's ZooKeeper, storage (``local``, ``objectstore`` and ``results``
under the workdir, as ``repro/service/core.py:136-139`` registers them),
metrics, a one-node cluster, scheduler and Lifecycle Manager, and a
``BackendContext``. ``drive`` is the tick loop that ``DLaaSCore`` runs
in the reference (``core.py:200-221``): ``scheduler.tick()`` and
``lcm.monitor(job_id)`` until the job reaches a state, with a deadline.
"""
import importlib
import time

TERMINAL = ("COMPLETED", "FAILED", "KILLED")


class Platform:
    def __init__(self, pkg: str, workdir, *, gpus: int = 4, **ctx_kw):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")
        cl, st = mod("platform.cluster"), mod("platform.storage")
        self.pkg = pkg
        self.workdir = str(workdir)
        self.lcm_mod = mod("platform.lcm")
        self.backends = mod("runtime.backend")
        self.endpoints = mod("serving.endpoint")    # registers "serving"
        self.manifests = mod("service.manifest")
        self.zk = mod("platform.zookeeper").ZooKeeper()
        self.storage = st.StorageManager()
        self.storage.register("local", st.LocalFSStore(f"{workdir}/local"))
        self.storage.register("objectstore",
                              st.ObjectStore(f"{workdir}/objectstore"))
        self.storage.register("results",
                              st.LocalFSStore(f"{workdir}/results"))
        self.metrics = mod("platform.metrics").MetricsService()
        self.cluster = cl.Cluster([cl.Node(
            "node-0", cl.Resources(cpus=16.0, gpus=gpus, memory_mb=65536))])
        self.scheduler = cl.Scheduler(self.cluster)
        self.lcm = self.lcm_mod.LifecycleManager(self.zk, self.scheduler)
        self.ctx = self.backends.BackendContext(
            zk=self.zk, storage=self.storage, metrics=self.metrics,
            workdir=self.workdir, **ctx_kw)

    def spec(self, job_id, manifest, *, gpus=1, tenant="default",
             priority=0):
        return self.lcm_mod.JobSpec(
            job_id=job_id, learners=int(manifest.get("learners", 1)),
            gpus_per_learner=gpus, tenant=tenant, priority=priority)

    def plan(self, job_id, manifest, backend=None, **kw):
        be = self.backends.get_backend(
            backend or self.manifests.resolve_distribution(manifest))
        return be, be.plan(self.spec(job_id, manifest, **kw), manifest,
                           self.ctx)

    def launch(self, job_id, manifest, **kw):
        """Plan, admit (as ``DLaaSCore`` does before it launches) and
        launch a training; returns the ``JobHandle``."""
        be, plan = self.plan(job_id, manifest, **kw)
        self.scheduler.check_admission(plan.tenant, plan.total_resources())
        return be.launch(plan, self.lcm)

    def deploy(self, endpoint_id, *, source_training=None,
               arch="stablelm-1.6b", gpus=1, tenant="default", **serving):
        """An endpoint of ``arch`` through the ``serving`` backend, with
        the weights of ``source_training`` (None: fresh init)."""
        manifest = {"framework": {"name": "repro-lm", "arch": arch},
                    "source_training": source_training,
                    "serving": serving}
        be, plan = self.plan(endpoint_id, manifest, backend="serving",
                             gpus=gpus, tenant=tenant)
        self.scheduler.check_admission(tenant, plan.total_resources())
        ep = self.endpoints.ModelEndpoint(endpoint_id, plan)
        ep.handle = be.launch(plan, self.lcm)
        return ep

    def drive(self, job_id, until=TERMINAL, timeout=120.0):
        """Tick until ``lcm.monitor(job_id)`` returns a state in
        ``until``; returns it (or the state at the deadline)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.scheduler.tick()
            st = self.lcm.monitor(job_id)
            if st in until:
                return st
            time.sleep(0.01)
        return self.lcm.job_state(job_id)

    def drive_endpoint(self, ep, want, timeout=120.0):
        """Tick until the endpoint's state is ``want``; a terminal job
        state finalizes it, as the reference's tick loop does."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.scheduler.tick()
            if self.lcm.monitor(ep.endpoint_id) in TERMINAL:
                ep.finalize(self.metrics)
            if ep.state() == want:
                return want
            time.sleep(0.01)
        raise AssertionError(f"endpoint never reached {want}: "
                             f"{ep.status()}")

    def learner_task(self, job_id, idx=0, role="learner"):
        app = self.scheduler.apps[self.lcm.group_app_id(job_id, role)]
        return app.tasks[f"{app.app_id}.{idx}"]

    def log_lines(self, job_id, member="learner-0"):
        base = f"/dlaas/jobs/{job_id}/members/{member}/log"
        return [self.zk.get(f"{base}/{c}")[0].decode()
                for c in self.zk.children(base)]
