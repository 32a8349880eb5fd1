"""Spawn the ranks of a gloo process group for a test: ``WORLD``
processes of a worker script, each ``python WORKER RANK WORLD WORKDIR``,
which rendezvous through a ``FileStore`` in ``WORKDIR`` (no port, so
tests under xdist do not collide), each logging to
``WORKDIR/log-RANK.txt``."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path


def spawn_ranks(worker: Path, work: Path, world: int,
                timeout: float = 600) -> None:
    """Run ``world`` ranks of ``worker`` in ``work`` to their end; raise
    with a rank's log tail if one fails. One OpenMP thread each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(work / f"log-{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(worker), str(r), str(world), str(work)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (work / f"log-{r}.txt").read_text()[-4000:]
