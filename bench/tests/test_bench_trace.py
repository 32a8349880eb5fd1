"""The traced serve run on the CPU at tiny width: the host ops that tell
the expert products' kernels apart are recorded on the engine's own
thread, which starts and stops the profiler at its step boundaries, and
a profiler driven from another thread keeps its events."""
import threading

import torch

from bench.common import benchmark_spec
from bench.run import execute
from bench.runners import Ctx
from bench.tests import tiny
from bench.tests.test_bench_faults import TINY_LIMITS
from bench.trace import Profile

SEED = 2 ** 31 + 11


def _work(n=20):
    a = torch.randn(16, 16)
    for _ in range(n):
        torch.bmm(a[None], a[None])


def test_a_profile_driven_on_another_thread_keeps_its_ops():
    with Profile(cpu=True) as p:
        p.begin()
        _work()
    prof = Profile(cpu=True)

    def body():
        prof.start()
        _work()
        prof.begin()
        _work()
        prof.stop()
    th = threading.Thread(target=body)
    th.start()
    th.join()
    summary = prof.reduce()
    bmm = [o for o in summary["ops"] if o["name"] == "aten::bmm"]
    assert len(bmm) >= 20
    assert len({o["tid"] for o in summary["ops"]}) == 1


def test_traced_serve_run_records_the_engine_threads_expert_products():
    spec = benchmark_spec()
    w = next(w for w in spec["workloads"] if w["name"] == "serve-grok-chat")
    cfg = tiny.config("grok-1-L4")
    ctx = Ctx(seed=SEED, seconds=1.5, trace=True, workload=w, config=cfg,
              mix=tiny.serve_mix(), limits=TINY_LIMITS, device="cpu")
    out, run = execute(ctx, spec, 1)
    assert out["correct"]
    assert "occupancy.serve" in out["metrics"]
    ops = run.record["trace_ops"]["ops"]
    experts = [o for o in ops if o["name"] == "aten::bmm" and o["dims"]
               and o["dims"][0][0] == cfg["num_experts"]]
    assert experts
    assert len({o["tid"] for o in ops}) == 1
    assert threading.active_count() == 1
