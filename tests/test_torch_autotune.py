"""The port's launch-shape tuner (``repro_torch/kernels/autotune.py``)
and grid helper (``kernels/grid.py``) on the CPU: ``fit_block``,
``divisor_blocks``, the generic ``tune`` and its cache held against the
reference's (``repro.kernels``) on the same calls; the port's own
behaviour (the cache across processes, the kill switch, legal
candidates, nothing tuned for CPU or meta tensors) and the
``DLaaSCore`` surfaces (``kernels_small_block_total``, the three
``dlaas_autotune_cache_*`` families).

No card here: measurement is exercised through ``tune``'s
``measure_s`` with callables the test gives; the kernels' own probes
run in tests/test_torch_cuda.py. Every cache lives under ``tmp_path``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.kernels import autotune as ref_tune
from repro.kernels import grid as ref_grid
from repro_torch.analysis import roofline
from repro_torch.kernels import autotune, grid, ops
from repro_torch.kernels import flash_attention as kfa
from repro_torch.observability.export import parse_prometheus_text

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """A private cache file for each package; the kill switches unset."""
    for var in ("DLAAS_AUTOTUNE", "DLAAS_AUTOTUNE_MEASURE"):
        monkeypatch.delenv(var, raising=False)
    paths = {"repro": tmp_path / "ref.json", "port": tmp_path / "port.json"}
    monkeypatch.setenv("DLAAS_AUTOTUNE_CACHE", str(paths["port"]))
    yield paths
    ref_tune._caches.pop(str(paths["repro"]), None)
    autotune._caches.pop(str(paths["port"]), None)


def _in(monkeypatch, path):
    monkeypatch.setenv("DLAAS_AUTOTUNE_CACHE", str(path))


# ---------------------------------------------------------------------------
# Held against the reference
# ---------------------------------------------------------------------------

FIT_CASES = [(1 << 14, 1024, 1), (2304, 1024, 1), (1000, 1024, 1),
             (2002, 1024, 1), (30030, 1024, 1), (255, 1024, 1),
             (7, 1024, 1), (256 * 21, 4096, 256), (256 * 1001, 4096, 256),
             (1 << 20, 4096, 256), (256_913_920, 1024, 1),
             (1_027_655_680, 4096, 256), (616_581_120, 1024, 256)]


@pytest.mark.parametrize("f,block,multiple", FIT_CASES)
def test_fit_block_and_its_events_match_the_reference(f, block, multiple):
    ref_before = len(ref_grid.small_block_events())
    port_before = len(grid.small_block_events())
    got = grid.fit_block(f, block, multiple)
    assert got == ref_grid.fit_block(f, block, multiple)
    assert f % got == 0 and got % multiple == 0 and got <= max(block,
                                                                multiple)
    assert grid.small_block_events()[port_before:] == \
        ref_grid.small_block_events()[ref_before:]


@pytest.mark.parametrize("f,multiple,cap", [
    (1 << 14, 256, 1 << 15), (2304, 256, 1 << 16), (256 * 1001, 256, 8192),
    (616_581_120, 256, 15872), (1_027_655_680, 256, 8192), (30030, 1, 4096),
    (1 << 13, 1, 1 << 16), (768, 256, 256)])
def test_divisor_blocks_match_the_reference(f, multiple, cap):
    assert autotune.divisor_blocks(f, multiple, cap) == \
        ref_tune.divisor_blocks(f, multiple, cap)


INF = float("inf")
# (candidates, predicted us, measured s or None, default)
TUNE_CASES = {
    "measured": ([256, 512, 1024, 2048],
                 {256: 9.0, 512: 5.0, 1024: 4.0, 2048: 3.0},
                 {256: 2e-6, 512: 1e-6, 1024: 3e-6, 2048: 4e-6}, 256),
    "predicted": ([256, 512, 1024], {256: 3.0, 512: 1.0, 1024: 2.0}, None,
                  256),
    "infeasible-pruned": ([256, 512, 1024], {256: 3.0, 512: INF, 1024: 2.0},
                          {256: 5e-6, 1024: 7e-6}, 512),
    "all-infeasible": ([512, 1024], {512: INF, 1024: INF}, {}, 256),
    "one-candidate": ([1024], {1024: 1.0}, {1024: 1e-6}, 1024),
    "tuples": ([(128, 64), (64, 64)], {(128, 64): 2.0, (64, 64): 3.0},
               {(128, 64): 2e-6, (64, 64): 1e-6}, (128, 64)),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_matches_the_reference(case, caches, monkeypatch):
    """Same candidates and callables: the same choice on a miss and on
    the hit after it, the same record and the same hit/miss counts."""
    cands, pred, meas, default = TUNE_CASES[case]
    out, recs, counts = {}, {}, {}
    for pkg, mod in (("repro", ref_tune), ("port", autotune)):
        _in(monkeypatch, caches[pkg])
        kw = dict(candidates=cands, predict_us=pred.__getitem__,
                  measure_s=None if meas is None else meas.__getitem__,
                  default=default)
        out[pkg] = [mod.tune("k", (4, 1 << 14), "float32", **kw)
                    for _ in range(2)]
        (rec,) = json.loads(caches[pkg].read_text()).values()
        recs[pkg] = rec
        cache = mod.get_cache()
        counts[pkg] = (cache.hits, cache.misses, cache.size())
    assert out["port"] == out["repro"]
    assert out["port"][0] == out["port"][1]
    assert recs["port"] == recs["repro"]
    assert counts["port"] == counts["repro"] == (1, 1, 1)


def test_a_failed_measurement_raises_and_stores_nothing(caches):
    """The reference falls back to its default (autotune.py:234-236); the
    port raises, and the shape stays untuned."""
    def broken(c):
        raise RuntimeError(f"probe at {c} failed")
    kw = dict(candidates=[256, 512], predict_us=lambda c: 1.0 / c,
              measure_s=broken, default=256)
    with pytest.raises(RuntimeError, match="probe at 512 failed"):
        autotune.tune("k", (1024,), "float32", **kw)
    assert not caches["port"].exists()
    assert autotune.get_cache().size() == 0


# ---------------------------------------------------------------------------
# The port's own behaviour
# ---------------------------------------------------------------------------


def test_flash_choice_tuple_survives_disk_round_trip(caches):
    args = (2 * 8, 300, 300, 128, torch.bfloat16)
    kw = dict(heads=(8, 2), causal=True, lse=True)
    c1 = autotune.tuned_flash_blocks(*args, **kw)
    assert isinstance(c1, tuple) and c1 in kfa.TC_SHAPES
    # evict the in-memory mirror: the next call re-reads the JSON file,
    # where the tuple became a list
    autotune._caches.pop(str(caches["port"]), None)
    c2 = autotune.tuned_flash_blocks(*args, **kw)
    assert isinstance(c2, tuple) and c2 == c1
    cache = autotune.get_cache()
    assert (cache.hits, cache.misses) == (1, 0)
    (key,) = json.loads(caches["port"].read_text())
    assert key == ("flash_attention|16x300x300x128|bfloat16|cpu|"
                   "h8kv2|causal1|off0|lse1")


def test_merge_on_write_between_two_processes(caches):
    path = str(caches["port"])
    here = autotune.AutotuneCache(path)
    here.put("k1", {"choice": 1})
    env = dict(os.environ, DLAAS_AUTOTUNE_CACHE=path,
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.kernels import autotune\n"
         "autotune.get_cache().put('k2', {'choice': [64, 64]})"],
        capture_output=True, text=True, env=env, timeout=300)
    assert child.returncode == 0, child.stderr
    here.put("k3", {"choice": 3})        # loaded before k2 was written
    data = json.loads(caches["port"].read_text())
    assert data == {"k1": {"choice": 1}, "k2": {"choice": [64, 64]},
                    "k3": {"choice": 3}}


def test_disabled_gives_the_fit_block_default(caches, monkeypatch):
    monkeypatch.setenv("DLAAS_AUTOTUNE", "0")
    f = 256 * 1001
    assert autotune.tuned_ps_block(4, f) == grid.fit_block(f, 1024) == 256
    assert autotune.tuned_quantize_block(f) == \
        grid.fit_block(f, 4096, multiple=256)
    assert autotune.tuned_flash_blocks(
        32, 512, 512, 64, torch.bfloat16, heads=(32, 32)) == (128, 64)
    assert not caches["port"].exists()


@pytest.mark.parametrize("nl,f", [(2, 256_913_920), (4, 616_581_120),
                                  (3, 9 * 256), (2, 1000)])
def test_ps_candidates_are_legal(caches, nl, f):
    plan = autotune.ps_plan(nl, f)
    assert plan.default == grid.fit_block(f, 1024)
    if f % 256:
        assert plan.candidates == [plan.default]
    for b in plan.candidates if f % 256 == 0 else []:
        assert b % 256 == 0 and f % b == 0
        assert b <= 2048
    assert autotune.tuned_ps_block(nl, f) in plan.candidates
    assert roofline.kernel_cost(plan.cost[0], **plan.cost[1]).bytes == \
        nl * f * 4 + 6 * f * 4                  # adam: rows, p/m/v in, out


@pytest.mark.parametrize("f,dtype", [(1_027_655_680, torch.bfloat16),
                                     (616_581_120, torch.float32),
                                     (616_581_120, torch.int8),
                                     (256 * 21, torch.float32)])
def test_quantize_candidates_are_legal(caches, f, dtype):
    plan = autotune.quantize_plan(f, 256, dtype)
    assert plan.default == grid.fit_block(f, 4096, multiple=256)
    for b in plan.candidates:
        assert b % 256 == 0 and f % b == 0 and 256 <= b <= 8192
    assert autotune.tuned_quantize_block(f, 256, dtype) in plan.candidates
    assert roofline.kernel_cost(plan.cost[0], **plan.cost[1]).bytes > 0
    with pytest.raises(ValueError, match="quantization block"):
        autotune.quantize_plan(f, 128, dtype)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 112),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 64),
                                      (torch.float32, 128)])
@pytest.mark.parametrize("sq,sk,causal,q_offset", [
    (2048, 2048, True, 0), (33, 33, True, 0), (512, 2048, True, 1536),
    (1500, 1500, False, 0)])
def test_flash_candidates_are_legal(caches, dtype, hd, sq, sk, causal,
                                    q_offset):
    plan = autotune.flash_plan(2 * 8, sq, sk, hd, dtype, heads=(8, 2),
                               causal=causal, q_offset=q_offset)
    if dtype == torch.bfloat16 and hd in kfa.TENSOR_CORE_HEAD_DIMS:
        assert plan.candidates == [(128, 64), (64, 64)]
        assert all(plan.predict_us(c) < float("inf")
                   for c in plan.candidates)
    else:
        assert plan.candidates == [kfa.CUDA_CORE_SHAPES[hd]]
    assert plan.default == plan.candidates[0]
    got = autotune.tuned_flash_blocks(2 * 8, sq, sk, hd, dtype,
                                      heads=(8, 2), causal=causal,
                                      q_offset=q_offset)
    assert got in plan.candidates
    assert roofline.kernel_cost(plan.cost[0], **plan.cost[1]).flops > 0


@pytest.mark.parametrize("b,h,group,sq,hd,want", [
    (2, 64, 8, 2048, 128, (1, 64)),       # jamba: one batch row
    (1, 64, 8, 8192, 128, (1, 16)),       # then whole GQA groups
    (4, 64, 8, 512, 112, (4, 64)),        # kimi-k2: all of it
    (1, 32, 1, 4096, 64, (1, 32))])
def test_flash_probe_scratch_is_bounded(b, h, group, sq, hd, want):
    got = autotune.flash_probe_rows(b, h, group, sq, hd)
    assert got == want
    assert got[0] * sq * got[1] * hd <= autotune.PROBE_VALUES
    assert autotune.flash_probe_rows(b, h, group, sq, hd, None) == (b, h)


def test_nothing_is_tuned_for_cpu_or_meta_tensors(caches):
    """A CPU PS round through ``ops`` (K2, K3, K1 and K4 on their plain
    versions) and a ``count_program`` of the same on meta: no lookup, no
    cache file, no probe launch."""
    probes = autotune.probe_launches
    g = torch.Generator().manual_seed(0)

    def round_trip(x, err, rows, params, m, v, q, k, vv):
        qq, s, _ = ops.quantize_ef(x, err)
        ops.dequantize(qq, s, out=rows[0])
        ops.ps_aggregate(rows, params, m, v, 1, solver="adam")
        return ops.flash_attention(q, k, vv, causal=True, return_lse=True)

    f = 2048
    args = (torch.randn(f, generator=g), torch.zeros(f),
            torch.randn(2, f, generator=g), torch.randn(f, generator=g),
            torch.zeros(f), torch.zeros(f),
            torch.randn(1, 64, 4, 64, generator=g).bfloat16(),
            torch.randn(1, 64, 2, 64, generator=g).bfloat16(),
            torch.randn(1, 64, 2, 64, generator=g).bfloat16())
    round_trip(*args)
    counted = roofline.count_program(round_trip, *args)
    assert counted["flops_per_device"] > 0
    cache = autotune.get_cache()
    assert (cache.hits, cache.misses, cache.size()) == (0, 0, 0)
    assert not caches["port"].exists()
    assert autotune.probe_launches == probes


def test_core_counts_small_blocks_and_exports_the_cache(tmp_path, caches):
    """A degraded ``fit_block`` raises ``kernels_small_block_total`` on a
    ``DLaaSCore``'s metrics, as in the reference; its ``/metrics`` text
    carries the three autotune families with the cache's numbers."""
    from repro_torch.service.core import DLaaSCore
    core = DLaaSCore(str(tmp_path / "w"), device="cpu")
    try:
        def small_blocks():
            return core.metrics.counters("platform").get(
                "kernels_small_block_total", 0)
        before = small_blocks()
        assert grid.fit_block(30030, 1024) == 2       # 2 * 3 * 5 * 7 ...
        assert small_blocks() == before + 1
        assert grid.fit_block(1 << 14, 1024) == 1024  # not degraded
        assert small_blocks() == before + 1
        for _ in range(3):
            autotune.tuned_ps_block(2, 1 << 20)
        autotune.tuned_quantize_block(1 << 20)
        text = core.prometheus_text()
        parse_prometheus_text(text)                   # well formed
        got = {}
        for line in text.splitlines():
            name, _, value = line.partition(" ")
            if name.startswith("dlaas_autotune_cache_"):
                got[name] = float(value)
        assert got == {"dlaas_autotune_cache_entries": 2.0,
                       "dlaas_autotune_cache_hits_total": 2.0,
                       "dlaas_autotune_cache_misses_total": 2.0}
    finally:
        core.close()
