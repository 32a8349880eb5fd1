"""The device trace of a traced run's sub-window and what the readers take
from it.

``Profile`` runs ``torch.profiler`` over a few steady seconds after a
run's window (the device's kernels, copies and sets; with ``cpu`` also
the host ops, with their input shapes, of the thread that starts it),
exports the Chrome trace into ``$TMPDIR`` and reduces it:

  * ``device``: every device interval (kernel, memcpy, memset) with its
    name and, where host ops were recorded, the op that launched it;
  * ``busy_s``: the union of the device intervals over the traced span,
    so kernels that overlap count once;
  * ``device_ops``: seconds by device operation name, largest first;
  * ``idle_gaps``: the longest stretches with nothing on the device, each
    named by what the host was doing (``_host_in``);
  * ``ops``: the host ops with their input shapes.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from bench.common import gaps, union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """``torch.profiler.profile``, as a context manager or driven by hand
    (``start``, ``begin``, ``stop``, then ``reduce``). The profiler starts
    keeping nothing until ``begin()``, so its own start-up is not in the
    trace; ``summary`` holds the reduced trace. Device activity only,
    unless ``cpu``: then also the host ops of the thread that calls
    ``start``, with their input shapes, which slows that thread and so is
    used only to tell which op launched which kernel. The profiler's
    option to record every thread is not used: its threads' event queues
    are read while those threads still write them. ``start``, ``begin``
    and ``stop`` belong to one thread; ``reduce`` may run on another once
    ``stop`` has returned."""

    def __init__(self, cpu: bool = False):
        self.cpu = cpu
        self.summary: Optional[dict] = None
        self._path: Optional[str] = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        kw = {}
        if self.cpu or not acts:
            acts.append(ProfilerActivity.CPU)
            kw = dict(record_shapes=True)
        self._prof = profile(activities=acts,
                             schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=self._ready, **kw)
        self._prof.start()

    def begin(self):
        """End of the warm-up: what follows is traced."""
        self._prof.step()

    def stop(self):
        self._prof.step()
        self._prof.stop()
        del self._prof

    def _ready(self, prof):
        # the profiler drops its events once this returns: export here
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        self._path = path
        prof.export_chrome_trace(path)

    def reduce(self) -> dict:
        """Reduce the exported trace into ``summary``."""
        try:
            with open(self._path) as f:
                self.summary = reduce_trace(json.load(f))
        finally:
            os.unlink(self._path)
            self._path = None
        return self.summary

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        if self._path is not None:
            self.reduce()
        return False


def _short(name: str, n: int = 96) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= n else name[: n - 3] + "..."


def reduce_trace(trace: dict) -> dict:
    """The summary of a Chrome trace (times in seconds)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ts = [e["ts"] for e in events if "ts" in e]
    te = [e["ts"] + e.get("dur", 0) for e in events if "ts" in e]
    lo, hi = (min(ts), max(te)) if ts else (0.0, 0.0)
    by_ext = {}
    for e in ops:
        ext = e.get("args", {}).get("External id")
        if ext is not None:
            by_ext[ext] = e
    device = []
    for e in dev:
        op = by_ext.get(e.get("args", {}).get("External id"))
        device.append({
            "name": e["name"], "start": e["ts"] * 1e-6,
            "dur": e.get("dur", 0) * 1e-6,
            "op": op["name"] if op else None})
    iv = [(d["start"], d["start"] + d["dur"]) for d in device]
    busy = union_seconds(iv, lo * 1e-6, hi * 1e-6)
    totals: Dict[str, float] = defaultdict(float)
    for d in device:
        totals[_short(d["name"])] += d["dur"]
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    idle = []
    for g0, g1 in gaps(iv, lo * 1e-6, hi * 1e-6)[:10]:
        idle.append([_host_in(ops, runtime, g0 * 1e6, g1 * 1e6), g1 - g0])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy,
            "device": device, "device_ops": [list(x) for x in device_ops],
            "idle_gaps": idle,
            "ops": [{"name": e["name"], "tid": e.get("tid"),
                     "start": e["ts"] * 1e-6,
                     "dims": e.get("args", {}).get("Input Dims")}
                    for e in ops]}


def _host_in(ops: List[dict], runtime: List[dict], t0: float,
             t1: float) -> str:
    """What the host did while the device sat idle over [t0, t1]
    (microseconds): the innermost op running at its middle where ops were
    recorded; else the CUDA runtime call that spans most of it, or how
    many calls it made."""
    mid = (t0 + t1) / 2
    best = None
    for e in ops:
        if e["ts"] <= mid <= e["ts"] + e.get("dur", 0):
            if best is None or e.get("dur", 0) < best.get("dur", 0):
                best = e
    if best is not None:
        return "host: " + _short(best["name"])
    inside = [e for e in runtime
              if e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    for e in inside:
        if min(t1, e["ts"] + e.get("dur", 0)) - max(t0, e["ts"]) \
                > (t1 - t0) / 2:
            return "host: in " + _short(e["name"])
    if inside:
        return f"host: {len(inside)} CUDA calls, none long"
    return "host: no CUDA call (Python and ATen on the CPU)"


def kernel_seconds(summary: dict, pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of device kernels whose name matches."""
    rx = re.compile(pattern)
    hits = [d["dur"] for d in summary["device"] if rx.search(d["name"])]
    return sum(hits), len(hits)


def breakdown(summary: dict) -> dict:
    return {"device_ops": summary["device_ops"],
            "idle_gaps": summary["idle_gaps"]}
