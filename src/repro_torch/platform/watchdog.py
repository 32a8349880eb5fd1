"""Watchdog sidecar (paper §Lifecycle Management).

"A sidecar (auxiliary) process called the 'watchdog' in the container
monitors the learner/parameter server and updates its status in the
corresponding znode." Each container also "creates an ephemeral znode at
startup, enabling the LCM to detect ... container crashes".

Here the watchdog wraps a learner callable: it creates the ephemeral
liveness znode, mirrors status + heartbeats + log lines into ZooKeeper,
classifies exceptions (user error -> JOB_FAILED, no restart; infra error ->
re-raise so the scheduler restarts the task), and tears the session down on
exit (which deletes the ephemeral and wakes the LCM).

Copied from ``repro/platform/watchdog.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.

Its logger is named under the port's own ``"repro_torch"`` tree (see
``observability/log.py``), so in a process that loads both packages the
reference's log hubs receive none of the port's records.
"""
from __future__ import annotations

import json
import logging
import time
import traceback
from typing import Callable, Optional

from repro_torch.errors import Preempted, UserError
from repro_torch.platform.zookeeper import ZooKeeper, zk_retry

# the per-job structured log channel: records carry job_id/trace_id/
# member extras, and the observability HubHandler fans them into the
# live ``logs?follow=1`` streams
job_log = logging.getLogger("repro_torch.job")

# learner status values (paper: e.g. JOB_FAILED)
PENDING, DOWNLOADING, TRAINING, CHECKPOINTING, JOB_DONE, JOB_FAILED = (
    "PENDING", "DOWNLOADING", "TRAINING", "CHECKPOINTING", "JOB_DONE",
    "JOB_FAILED")


class Watchdog:
    def __init__(self, zk: ZooKeeper, job_id: str, member: str,
                 preempt_check: Optional[Callable[[], bool]] = None,
                 trace_id: Optional[str] = None):
        self.zk = zk
        self.job_id = job_id
        self.member = member            # e.g. learner-0, ps-0
        self.trace_id = trace_id or "-"
        self.base = f"/dlaas/jobs/{job_id}/members/{member}"
        self.preempt_check = preempt_check
        self.session = zk.session()
        # a transient quorum loss at container start must not kill the
        # task before it even runs — bounded retry, then give up loudly
        zk_retry(lambda: zk.ensure(self.base))
        zk_retry(lambda: zk.create(
            f"{self.base}/alive", b"1", ephemeral=True,
            session=self.session, makepath=True))
        self.set_status(PENDING)

    # ---- status / heartbeat / logs ---------------------------------------
    def _put(self, path: str, data: bytes):
        def write():
            if self.zk.exists(path):
                self.zk.set(path, data)
            else:
                self.zk.create(path, data, makepath=True)
        zk_retry(write)

    def set_status(self, status: str, detail: str = ""):
        self._put(f"{self.base}/status",
                  json.dumps({"status": status, "detail": detail,
                              "ts": time.time()}).encode())

    def heartbeat(self, step: int, **metrics):
        self._put(f"{self.base}/heartbeat",
                  json.dumps({"step": step, "ts": time.time(),
                              **metrics}).encode())

    def log(self, line: str):
        path = f"{self.base}/log"
        zk_retry(lambda: self.zk.create(
            path + "/l", line.encode(), sequential=True, makepath=True))
        # mirror into the structured per-job channel (live streams)
        job_log.info("%s", line,
                     extra={"job_id": self.job_id, "member": self.member,
                            "trace_id": self.trace_id})

    def maybe_preempt(self):
        """Raise Preempted if the scheduler asked this task to yield.
        Learner bodies call this at every step boundary so preemption
        lands between steps — after the last checkpoint, never mid-push."""
        if self.preempt_check is not None and self.preempt_check():
            raise Preempted(f"{self.member} preempted")

    # ---- supervised execution --------------------------------------------
    def run(self, fn: Callable[["Watchdog"], None]):
        """Run the learner body under supervision."""
        try:
            self.set_status(TRAINING)
            fn(self)
            self.set_status(JOB_DONE)
        except Preempted as e:
            # not a failure: status returns to PENDING; the scheduler has
            # already requeued the task and it resumes from checkpoint
            self.log(f"preempted: {e}")
            self.set_status(PENDING, "preempted")
            raise
        except UserError as e:
            # paper: user-input faults -> graceful terminate + JOB_FAILED;
            # LCM terminates the job, no restart.
            self.log(f"user error: {e}")
            self.set_status(JOB_FAILED, str(e))
            raise
        except Exception as e:
            self.log(f"infra error: {type(e).__name__}: {e}\n"
                     + traceback.format_exc()[-1500:])
            self.set_status(JOB_FAILED, f"infra: {e}")
            raise
        finally:
            self.session.close()       # deletes the ephemeral znode

    def crash(self):
        """Simulate a container crash: the session expires WITHOUT any
        status update — the LCM must notice via the ephemeral znode."""
        self.session.expire()


class NodeWatchdog:
    """Node-side sidecar: the membership analogue of the container
    watchdog. Every managed node runs one; each cluster tick it reports
    the node alive (``Cluster.node_heartbeat``). Faults act on the
    channel, not the agent: a partition drops the beats in flight, a
    delay keeps the agent silent for N ticks, a crash removes the node
    (and the agent with it) — and after ``heartbeat_timeout`` silent
    ticks the cluster declares the node DEAD."""

    def __init__(self, cluster, node_name: str):
        self.cluster = cluster
        self.node_name = node_name

    def beat(self):
        node = self.cluster.nodes.get(self.node_name)
        if node is None or node.state == "DEAD":
            return
        if node.heartbeat_delay > 0:
            node.heartbeat_delay -= 1
            return
        self.cluster.node_heartbeat(self.node_name)
