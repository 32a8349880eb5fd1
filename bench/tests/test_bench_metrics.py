"""The metric arithmetic: a tail over all requests with failures as
missing, a rate as all the window's work over all its time, idle as a
union of intervals,
the readers on hand-made records and traces, and a metric added as a new
file with no edit to a harness file."""
import json
import math
import shutil
import subprocess
import sys
import textwrap

import pytest

from bench import cost
from bench.common import (BENCH, ROOT, benchmark_spec, gaps, load_module,
                          percentile, union_seconds)
from bench.trace import reduce_trace
from bench.weights import Spec


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "m_" + name)


def test_tail_counts_missing_requests():
    lat = [1.0] * 90 + [2.0] * 5 + [math.inf] * 5
    assert percentile(lat, 95) == 2.0
    assert percentile(lat + [math.inf], 95) == math.inf
    assert percentile(lat, 50) == 1.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert union_seconds(iv, 1.5, 5.5) == pytest.approx(2.0)
    assert gaps(iv, 0.0, 10.0) == [(6.0, 10.0), (3.0, 5.0)]


def _trace():
    """Two threads: a router mm, then two bmm calls with a kernel each; an
    overlapping kernel and a memcpy; idle between."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "tid": 1, "ts": 0,
         "dur": 5, "args": {"External id": 1,
                            "Input Dims": [[16, 8], [8, 4]]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "tid": 1, "ts": 10,
         "dur": 5, "args": {"External id": 2,
                            "Input Dims": [[4, 8, 8], [4, 8, 16]]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "tid": 1, "ts": 20,
         "dur": 5, "args": {"External id": 3,
                            "Input Dims": [[4, 8, 16], [4, 16, 8]]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 2, "ts": 40,
         "dur": 50, "args": {"External id": 4}},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 12, "dur": 10,
         "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm_b", "ts": 22, "dur": 10,
         "args": {"External id": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 25,
         "dur": 10, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "ew", "ts": 80, "dur": 20,
         "args": {"External id": 4}},
    ]
    return {"traceEvents": ev}


def test_reduce_trace_busy_is_a_union():
    s = reduce_trace(_trace())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((35 - 12 + 20) * 1e-6)
    assert s["device_ops"][0] == ["ew", pytest.approx(20e-6)]
    assert s["idle_gaps"][0][0] == "host: aten::add"
    assert s["idle_gaps"][0][1] == pytest.approx(45e-6)
    assert [d["op"] for d in s["device"]][:2] == ["aten::bmm", "aten::bmm"]
    idle = reader("device_idle.serve").read({"trace": s})
    assert idle == pytest.approx(100 * (1 - 43 / 100))


def test_moe_roofline_reader():
    s = reduce_trace(_trace())
    spec = Spec(family="moe", d=8, ff=16, heads=2, kv=1, hd=4, layers=1,
                vocab=32, experts=4, top_k=2)
    got = reader("moe_roofline.serve").read({"trace_ops": s, "spec": spec})
    least = (cost.expert_bmm(4, 8, 8, 16, 32).seconds()
             + cost.expert_bmm(4, 8, 16, 8, 32).seconds())
    assert got == pytest.approx(100 * least / 20e-6)


def test_train_readers():
    spec = Spec(family="dense", d=8, ff=16, heads=2, kv=2, hd=4, layers=2,
                vocab=32)
    mix = {"seq_len": 16, "batch_docs": 1, "learners": 2, "shards": 4}
    rec = {"spec": spec, "mix": mix, "tokens": 3200, "window_s": 2.0,
           "sync_s": [0.01, 0.03]}
    assert reader("train_mfu").read(rec) == pytest.approx(
        100 * cost.train_flops_per_token(spec, 16) * 3200
        / (2.0 * cost.PEAK_FLOPS_BF16))
    assert reader("ps_sync_ms.train").read(rec) == pytest.approx(20.0)
    assert reader("attn_roofline.train").read(rec) is None
    dev = [{"name": "flash_fwd_kernel_tc", "dur": 1e-3},
           {"name": "flash_bwd_dq_tc_kernel", "dur": 2e-3},
           {"name": "flash_bwd_dkv_tc_kernel", "dur": 1e-3},
           {"name": "ps_aggregate_kernel", "dur": 1e-3},
           {"name": "quantize_ef_kernel", "dur": 1e-3},
           {"name": "dequantize_kernel", "dur": 1e-3}]
    rec["trace"] = {"device": dev, "busy_s": 1.0, "window_s": 4.0}
    rec.update(ps_padded=1024, grad_esize=2)
    want = (cost.flash_fwd(1, 16, 2, 2, 4, lse=True).seconds()
            + cost.flash_bwd(1, 16, 2, 2, 4).seconds()) / 4e-3
    assert reader("attn_roofline.train").read(rec) == pytest.approx(100 * want)
    want = (cost.ps_aggregate(2, 256).seconds()
            + cost.quantize_ef(1024, 2).seconds()
            + cost.dequantize(1024).seconds()) / 3e-3
    assert reader("ps_kernels_roofline.train").read(rec) == pytest.approx(
        100 * want)
    assert reader("device_idle.train").read(rec) == pytest.approx(75.0)


def test_serve_readers():
    spec = Spec(family="moe", d=8, ff=16, heads=2, kv=1, hd=4, layers=1,
                vocab=32, experts=4, top_k=2)
    rec = {"spec": spec, "window_s": 10.0, "capacity": 4,
           "decode_seconds": 0.5, "decode_steps": 20,
           "occupied_slot_steps": 60, "prefill_seconds": 0.2,
           "prefills": [(1, 100), (2, 50)]}
    assert reader("decode_step_ms.serve").read(rec) == pytest.approx(25.0)
    assert reader("occupancy.serve").read(rec) == pytest.approx(75.0)
    assert reader("prefill_ms_per_ktok.serve").read(rec) == \
        pytest.approx(0.2 / 200 * 1e6)
    flops = (cost.prefill_flops(spec, 1, 100) + cost.prefill_flops(spec, 2, 50)
             + cost.decode_flops(spec, 60))
    assert reader("serve_mfu").read(rec) == pytest.approx(
        100 * flops / (10.0 * cost.PEAK_FLOPS_BF16))
    assert reader("decode_step_ms.serve").read({"decode_steps": 0}) is None


def test_every_metric_has_a_reader():
    spec = benchmark_spec()
    for m in spec["per_layer"]:
        assert hasattr(reader(m["name"]), "read"), m["name"]
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_a_metric_is_a_new_file(tmp_path):
    """A throwaway per-layer metric added as one file and one entry of
    BENCHMARK.json appears in a traced run's line; no harness file
    changes."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "bench" / "metrics" / "window_twice_s.train.py").write_text(
        "def read(run):\n    return 2 * run['window_s']\n")
    spec = benchmark_spec()
    spec["per_layer"].append(
        {"name": "window_twice_s.train", "unit": "s", "better": "lower",
         "source": "host_clock", "layer": "test", "moves":
         "train_tokens_per_s", "workloads": ["train-stablelm-ps-4k"]})
    code = textwrap.dedent(f"""
        import json, sys
        from bench.runners import Ctx
        from bench.run import execute
        from bench.tests import tiny
        spec = json.loads({json.dumps(json.dumps(spec))})
        w = spec["workloads"][0]
        ctx = Ctx(seed=5, seconds=0.5, trace=True, workload=w,
                  config=tiny.config("stablelm-2-1.6b-L12", "float32"),
                  mix=tiny.train_mix(), limits=dict(loss_rel_gap=1,
                  grad1_norm_gap=1, grad1_diff=1, change_norm_gap=1),
                  device="cpu")
        out, run = execute(ctx, spec, 1)
        print(json.dumps(out["metrics"]))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["window_twice_s.train"]["value"] > 1.0
    assert "train_mfu" in got
