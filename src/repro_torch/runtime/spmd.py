"""The rank processes of the pjit gang on a mesh: the port's counterpart
of the devices that ``jax.make_mesh`` hands worker 0 of the reference's
gang (``repro/runtime/backend.py``). A ``torch.distributed`` rank is a
process, so where the reference's one SPMD program spans the devices of
one process, the port starts one process per rank of the mesh:

    python -m repro_torch.runtime.spmd --rank R --world N \\
        --workdir DIR --mesh data=2,model=2 --fd FD [--device cpu]

Each rank joins a process group through a ``FileStore`` under ``DIR``
(NCCL on ``cuda``, gloo when the caller asked for ``cpu``; no port),
builds the mesh (``launch.mesh.make_mesh``) and a ``Trainer`` on it from
``DIR/job.pkl``, and restores the latest valid checkpoint (or draws the
seed's weights where there is none). It then serves the leader over the
duplex pipe ``FD`` (a ``multiprocessing.connection`` socket pair), one
command at a time:

  * ``("step", batch, extra)``: one ``Trainer.step_once`` on the global
    batch (numpy int64 ``tokens`` / ``labels``), a checkpoint with
    ``extra`` (the leader's data cursor) every ``ckpt_every`` steps;
    replies the loss, the step's seconds, the checkpoint steps this rank
    has finished writing and ``ops.launch_counts()``;
  * ``("save", extra)``: a checkpoint now;
  * ``("finish",)``: the params gathered whole (a collective); rank 0
    replies the flat vector's shape and dtype, then sends its bytes in
    ``CHUNK``-byte messages (``weights.flat_from_params``), then exits;
  * ``("stop",)``: exits at this step boundary (after its writes).

A failure is replied as ``("error", traceback)`` and ends the process
with code 1. The rank also ends when the leader's thread ends
(``PR_SET_PDEATHSIG``) or its end of the pipe closes.

``TIMEOUT`` bounds every wait of a rank on the others: the process
group starts with it, and ``make_mesh`` gives it to every group of the
mesh and to the mesh's side group, so a rank that fails alone costs the
others at most that long in one wait (``runtime/trainer.py``).

``RankGang`` is the leader's side (``runtime/backend.py``'s
``PjitBackend``): it writes ``job.pkl``, starts the processes and talks
to them.
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import math
import os
import pickle
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

TIMEOUT = datetime.timedelta(seconds=120)
# bytes a message of the flat vector: a receive allocates its message's
# whole size for every read of the socket, which at the 4 GB of a
# full-width vector in one message stalled the transfer for minutes on
# the card's machine
CHUNK = 1 << 24
MESH_AXES = (("data", "model"), ("pod", "data", "model"))


def parse_mesh(text: str) -> Dict[str, int]:
    """``"data=2,model=2"`` -> ``{"data": 2, "model": 2}``."""
    axes = {}
    for part in text.split(","):
        name, size = part.split("=")
        axes[name] = int(size)
    if tuple(axes) not in MESH_AXES:
        raise ValueError(f"mesh axes {tuple(axes)} are none of {MESH_AXES}")
    return axes


def _die_with_parent():
    """SIGKILL this process when the thread that started it ends."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # SET_PDEATHSIG
    if os.getppid() == 1:
        sys.exit(1)


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------


def _serve(conn, rank: int, axes: Dict[str, int], job: Dict, device):
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import Dist, gather
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import map_leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.weights import flat_from_params

    mesh = make_mesh(axes["data"], axes["model"], axes.get("pod", 1),
                     device=device)
    tr = Trainer(job["cfg"], Dist(mesh=mesh, policy=job["policy"]),
                 job["opt"], TrainerConfig(**job["tc"]), device=device)
    t0 = time.perf_counter()
    last = tr.ckpt.latest_valid()
    extra = tr.restore(last) if last is not None else {}
    if last is None:
        tr.init(job["seed"])
    restore_s = time.perf_counter() - t0
    cost = tr.program_cost() if rank == 0 and job["want_cost"] else None
    conn.send(("ready", {"step": tr.step, "restored": last, "extra": extra,
                         "restore_s": restore_s, "cost": cost}))
    in_flight: List[int] = []

    def written():
        """Checkpoint steps whose write this rank has finished."""
        if tr.ckpt.pending():
            return []
        done = list(in_flight)
        in_flight.clear()
        return done

    def save(extra):
        tr.save(extra=extra)
        if rank == 0:                 # the mesh's first coordinate writes
            in_flight.append(tr.step)

    every = job["tc"]["ckpt_every"]
    while True:
        cmd = conn.recv()
        if cmd[0] == "step":
            _, batch, extra = cmd
            b = {k: torch.from_numpy(np.asarray(v, np.int64)).to(tr.device)
                 for k, v in batch.items()}
            t1 = time.perf_counter()
            loss = tr.step_once(b)
            step_s = time.perf_counter() - t1
            saved = None
            if tr.step % every == 0:
                save(extra)
                saved = tr.step
            conn.send(("step", {"step": tr.step - 1, "loss": loss,
                                "step_s": step_s, "saved": saved,
                                "written": written(),
                                "launches": ops.launch_counts()}))
        elif cmd[0] == "save":
            save(cmd[1])
            conn.send(("saved", {"step": tr.step, "written": written()}))
        elif cmd[0] == "finish":
            pflat = flat_from_params(map_leaves(lambda _p, x: gather(x),
                                                tr.params))
            tr.ckpt.wait()
            conn.send(("done", {
                "flat": (pflat.shape, pflat.dtype.str) if rank == 0
                else None,
                "written": written(), "launches": ops.launch_counts()}))
            if rank == 0:
                raw = memoryview(pflat).cast("B")
                for off in range(0, raw.nbytes, CHUNK):
                    conn.send_bytes(raw[off:off + CHUNK])
            return
        elif cmd[0] == "stop":
            tr.ckpt.wait()
            conn.send(("stopped", {"written": written()}))
            return
        else:
            raise ValueError(f"unknown command {cmd[0]!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.runtime.spmd")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--mesh", required=True, type=parse_mesh)
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    _die_with_parent()
    from multiprocessing.connection import Connection
    conn = Connection(args.fd)
    try:
        import torch
        import torch.distributed as tdist

        from repro_torch.device import resolve_device
        device = resolve_device(args.device)     # raises without a card
        if math.prod(args.mesh.values()) != args.world:
            raise ValueError(f"mesh {args.mesh} is not {args.world} ranks")
        if device.type == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
        work = Path(args.workdir)
        job = pickle.loads((work / "job.pkl").read_bytes())
        tdist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=tdist.FileStore(str(work / "store"), args.world),
            rank=args.rank, world_size=args.world, timeout=TIMEOUT)
        try:
            _serve(conn, args.rank, args.mesh, job, device.type)
        finally:
            tdist.destroy_process_group()
    except (EOFError, BrokenPipeError):
        return 1                               # the leader is gone
    except BaseException:
        text = traceback.format_exc()
        print(text, file=sys.stderr, flush=True)
        try:
            conn.send(("error", text[-4000:]))
        except OSError:
            pass
        return 1
    return 0


# ---------------------------------------------------------------------------
# the leader's side
# ---------------------------------------------------------------------------


class RankGang:
    """The ``n`` rank processes of one incarnation on a mesh of ``axes``:
    started on construction, each with its pipe and its log
    (``workdir/rank-R.log``); ``job`` (``cfg``, ``opt``, ``tc``,
    ``policy``, ``seed``, ``want_cost``) goes to ``workdir/job.pkl``.
    CPU ranks run ``OMP_NUM_THREADS`` from the environment, else the
    host's cores shared out among them."""

    def __init__(self, axes: Dict[str, int], job: Dict, workdir,
                 device: str):
        from multiprocessing import Pipe
        import repro_torch
        self.axes = dict(axes)
        self.n = math.prod(self.axes.values())
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True)
        (self.workdir / "job.pkl").write_bytes(pickle.dumps(job))
        env = dict(os.environ)
        src = str(Path(repro_torch.__file__).resolve().parents[1])
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
        if device == "cpu" and "OMP_NUM_THREADS" not in env:
            env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                             // self.n))
        mesh = ",".join(f"{k}={v}" for k, v in self.axes.items())
        self.procs: List[subprocess.Popen] = []
        self.conns = []
        self.t_start = time.perf_counter()
        try:
            for r in range(self.n):
                ours, theirs = Pipe(duplex=True)
                with open(self.workdir / f"rank-{r}.log", "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.runtime.spmd",
                         "--rank", str(r), "--world", str(self.n),
                         "--workdir", str(self.workdir), "--mesh", mesh,
                         "--fd", str(theirs.fileno()), "--device", device],
                        pass_fds=(theirs.fileno(),), env=env,
                        stdout=log, stderr=subprocess.STDOUT))
                theirs.close()
                self.conns.append(ours)
        except BaseException:
            self.kill()
            raise

    def log_tail(self, r: int, n: int = 3000) -> str:
        try:
            return (self.workdir / f"rank-{r}.log").read_text()[-n:]
        except OSError:
            return ""

    def send(self, cmd) -> None:
        for r, c in enumerate(self.conns):
            try:
                c.send(cmd)
            except OSError:
                self._dead(r)

    def _dead(self, r: int):
        rc = self.procs[r].wait()
        raise RuntimeError(f"rank {r} exited with code {rc}: "
                           f"{self.log_tail(r)}")

    def collect(self, kind: str) -> List[Dict]:
        """Every rank's reply to the last command, in rank order; raises
        when a rank replied with an error or exited without a reply."""
        out: List[Optional[Dict]] = [None] * self.n
        waiting = set(range(self.n))
        while waiting:
            for r in sorted(waiting):
                if not self.conns[r].poll(0.02):
                    if self.procs[r].poll() is not None \
                            and not self.conns[r].poll(0):
                        self._dead(r)
                    continue
                try:
                    got, body = self.conns[r].recv()
                except (EOFError, OSError):
                    self._dead(r)
                if got == "error":
                    raise RuntimeError(f"rank {r} failed: {body}")
                if got != kind:
                    raise RuntimeError(f"rank {r} replied {got!r} to a "
                                       f"{kind!r} wait")
                out[r] = body
                waiting.discard(r)
        return out

    def recv_array(self, r: int, shape, dtype):
        """The array rank ``r`` sends as raw bytes after its reply."""
        import numpy as np
        out = np.empty(shape, dtype)
        raw, off = memoryview(out).cast("B"), 0
        while off < raw.nbytes:
            off += self.conns[r].recv_bytes_into(raw, off)
        return out

    def alive(self, r: int) -> bool:
        return self.procs[r].poll() is None

    def returncode(self, r: int) -> Optional[int]:
        return self.procs[r].poll()

    def kill(self, r: Optional[int] = None) -> None:
        for i, p in enumerate(self.procs):
            if r is None or i == r:
                if p.poll() is None:
                    p.kill()
                p.wait()

    def stop(self, grace: float = 60.0) -> List[int]:
        """Ask every live rank to stop at this step boundary, wait for
        them to end (``grace`` seconds), then kill what is left. Returns
        the checkpoint steps that rank 0 finished writing meanwhile."""
        for c in self.conns:
            try:
                c.send(("stop",))
            except OSError:
                pass
        deadline = time.time() + grace
        written: List[int] = []
        if self.alive(0) and self.conns[0].poll(grace):
            try:
                got, body = self.conns[0].recv()
                if got == "stopped":
                    written = body["written"]
            except (EOFError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        self.close()
        return written

    def close(self) -> None:
        self.kill()
        for c in self.conns:
            c.close()


if __name__ == "__main__":
    sys.exit(main())
