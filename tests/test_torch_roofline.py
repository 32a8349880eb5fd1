"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's (``repro.analysis.roofline``).

``model_flops`` equals the reference's for every arch and shape; each of
the seven kernel ops on the meta device returns its kernel's outputs and
records the hand formula's FLOPs and bytes (K5b's also through
``SSDScan``'s backward, and pinned at full width); ``count_program`` of
the learner step (dense and ssm) and of the decode step agrees with the
reference's HLO count of the same program; views count no bytes;
full-width StableLM counts on meta in seconds; ``chip_smoke.py``'s
kernel bounds are ``kernel_cost``'s and PERF.md's table of kernels.

All on the CPU: the port's programs on the meta device, the reference's
lowered by XLA for the CPU."""
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs import base as jax_base
from repro.configs.registry import get_arch as jax_get_arch
from repro.runtime import learner as jax_learner
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.analysis import roofline
from repro_torch.configs import base
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.kernels import ops
from repro_torch.runtime.learner import LMPlugin, MLPPlugin
from repro_torch.serving.engine import InferenceEngine
from util_poll import wait_until

ROOT = Path(__file__).resolve().parents[1]
# the port's step against the reference's HLO count of the same step: the
# attention products differ (the port's kernels skip the masked half and
# K4b recomputes S; the reference's jnp attention and its VJP do not)
LM_FLOPS_RTOL = 0.05
MLP_FLOPS_RTOL = 0.01      # the same four products
DECODE_FLOPS_RTOL = 0.01   # the same products, attention over the cache
MODEL_FLOPS_RANGE = (0.85, 1.15)


@pytest.fixture(autouse=True)
def _reference_switches(monkeypatch):
    monkeypatch.setenv("DLAAS_JAX_CACHE", "0")


# ------------------------------------------------------------ model_flops
@pytest.mark.parametrize("arch,smoke,shape", [
    (a, False, s.name) for a in ARCH_IDS for s in base.ALL_SHAPES] + [
    (a, True, s.name) for a in ARCH_IDS
    for s in (base.SMOKE_TRAIN, base.SMOKE_PREFILL, base.SMOKE_DECODE)])
def test_model_flops_equals_the_reference(arch, smoke, shape):
    """Exactly equal, config by config."""
    shapes = {s.name: s for s in base.ALL_SHAPES + (
        base.SMOKE_TRAIN, base.SMOKE_PREFILL, base.SMOKE_DECODE)}
    jshapes = {s.name: s for s in jax_base.ALL_SHAPES + (
        jax_base.SMOKE_TRAIN, jax_base.SMOKE_PREFILL,
        jax_base.SMOKE_DECODE)}
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    if smoke:
        cfg, jcfg = base.reduce_for_smoke(cfg), jax_base.reduce_for_smoke(
            jcfg)
    got = roofline.model_flops(cfg, shapes[shape])
    assert got == jax_roofline.model_flops(jcfg, jshapes[shape]) > 0


def test_roofline_row_reads_the_count():
    cfg = base.reduce_for_smoke(get_arch("stablelm-1.6b"))
    a = LMPlugin({}, device="cpu").program_cost(4, {"seq_len": 64})
    row = roofline.roofline_row({}, a, cfg, base.SMOKE_TRAIN, 1)
    assert row["model_flops"] == roofline.model_flops(cfg, base.SMOKE_TRAIN)
    assert row["hlo_flops_per_device"] == a["flops_per_device"]
    assert row["dominant"] == "memory"
    assert 0 < row["roofline_frac"] < 1


# ----------------------------------------------------- the six kernel ops
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pairs_loop(sq, sk, causal, q_offset):
    if not causal:
        return sq * sk
    return sum(min(sk, i + 1 + q_offset) for i in range(sq))


@pytest.mark.parametrize("sq,sk,causal,q_offset", [
    (1, 1, True, 0), (37, 37, True, 0), (37, 37, True, 9), (5, 40, True, 35),
    (40, 5, True, 0), (8, 8, True, 100), (16, 9, False, 0),
    (4096, 4096, True, 0)])
def test_causal_pairs_closed_form(sq, sk, causal, q_offset):
    assert roofline.causal_pairs(sq, sk, causal, q_offset) == \
        _pairs_loop(sq, sk, causal, q_offset)


def _flash_case(dtype, return_lse, q_offset):
    B, S, H, KV, hd = 2, 48, 8, 2, 64
    es = torch.empty((), dtype=dtype).element_size()
    pairs = _pairs_loop(S, S, True, q_offset)

    def call():
        return ops.flash_attention(_meta((B, S, H, hd), dtype),
                                   _meta((B, S, KV, hd), dtype),
                                   _meta((B, S, KV, hd), dtype),
                                   causal=True, q_offset=q_offset,
                                   return_lse=return_lse)
    out = [((B, S, H, hd), dtype)]
    if return_lse:
        out.append(((B, H, S), torch.float32))
    nbytes = (2 * B * S * H + 2 * B * S * KV) * hd * es \
        + (4 * B * H * S if return_lse else 0)
    return call, out, 4 * B * H * hd * pairs, nbytes


def _flash_bwd_case(dtype):
    B, Sq, Sk, H, KV, hd = 1, 33, 33, 4, 2, 32
    es = torch.empty((), dtype=dtype).element_size()
    q, o, do = (_meta((B, Sq, H, hd), dtype) for _ in range(3))
    k, v = (_meta((B, Sk, KV, hd), dtype) for _ in range(2))
    lse = _meta((B, H, Sq))

    def call():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    out = [((B, Sq, H, hd), dtype), ((B, Sk, KV, hd), dtype),
           ((B, Sk, KV, hd), dtype)]
    # q, o, dO, k, v and the LSE read; dq, dk, dv written; five products
    nbytes = (4 * B * Sq * H + 4 * B * Sk * KV) * hd * es + 4 * B * H * Sq
    return call, out, 10 * B * H * hd * _pairs_loop(Sq, Sk, True, 0), nbytes


def _ssd_case(dtype):
    B, S, H, P, G, N, chunk = 2, 300, 8, 16, 2, 32, 128
    es = torch.empty((), dtype=dtype).element_size()

    def call():
        return ops.ssd_scan(_meta((B, S, H, P), dtype), _meta((B, S, H)),
                            _meta((H,)), _meta((B, S, G, N), dtype),
                            _meta((B, S, G, N), dtype), chunk=chunk)
    out = [((B, S, H, P), dtype), ((B, H, P, N), torch.float32)]
    # chunks of 128, 128 and 44 positions: s <= t pairs in each
    pairs = 2 * (128 * 129 // 2) + 44 * 45 // 2
    flops = B * H * (2 * P * pairs + 4 * S * P * N) + B * G * 2 * N * pairs
    nbytes = ((2 * B * S * H * P + 2 * B * S * G * N) * es + 4 * B * S * H
              + 4 * H + 4 * B * H * P * N)
    return call, out, flops, nbytes


def _ssd_bwd_case(dtype, dstate):
    B, S, H, P, G, N, chunk = 2, 300, 8, 16, 2, 32, 128
    es = torch.empty((), dtype=dtype).element_size()

    def call():
        return ops.ssd_scan_bwd(
            _meta((B, S, H, P), dtype), _meta((B, S, H)), _meta((H,)),
            _meta((B, S, G, N), dtype), _meta((B, S, G, N), dtype),
            _meta((B, S, H, P), dtype),
            _meta((B, H, P, N)) if dstate else None, chunk=chunk)
    out = [((B, S, H, P), dtype), ((B, S, H), torch.float32),
           ((H,), torch.float32), ((B, S, G, N), dtype),
           ((B, S, G, N), dtype)]
    pairs = 2 * (128 * 129 // 2) + 44 * 45 // 2
    flops = (B * H * (4 * P * pairs + 4 * N * pairs + 10 * S * P * N)
             + B * G * 2 * N * pairs)
    # x, dy, dx; b, c, db, dc; dt, ddt; a_log, da_log; dstate read when
    # given
    nbytes = ((3 * B * S * H * P + 4 * B * S * G * N) * es + 8 * B * S * H
              + 8 * H + (4 * B * H * P * N if dstate else 0))
    return call, out, flops, nbytes


def _quantize_case(dtype):
    F = 4 * 256
    es = torch.empty((), dtype=dtype).element_size()

    def call():
        return ops.quantize_ef(_meta((F,), dtype), _meta((F,)))
    out = [((F,), torch.int8), ((F // 256,), torch.float32),
           ((F,), torch.float32)]
    return call, out, 0, F * es + 4 * F + F + 4 * F // 256 + 4 * F


def _dequantize_case():
    F = 8 * 256

    def call():
        return ops.dequantize(_meta((F,), torch.int8), _meta((F // 256,)))
    return call, [((F,), torch.float32)], 0, F + 4 * F // 256 + 4 * F


def _ps_aggregate_case(solver):
    NL, F = 3, 1000
    state = {"sgd": 2, "momentum": 4, "adam": 6, "easgd_center": 2,
             "average": 1}[solver]

    def call():
        return ops.ps_aggregate(_meta((NL, F)), _meta((F,)), _meta((F,)),
                                _meta((F,)), 1, solver=solver)
    return call, [((F,), torch.float32)] * 3, 0, 4 * F * (NL + state)


KERNEL_CASES = {
    "flash_attention-bf16": ("flash_attention",
                             lambda: _flash_case(torch.bfloat16, False, 0)),
    "flash_attention-f32-lse-offset": (
        "flash_attention", lambda: _flash_case(torch.float32, True, 7)),
    "flash_attention_bwd-bf16": ("flash_attention_bwd",
                                 lambda: _flash_bwd_case(torch.bfloat16)),
    "flash_attention_bwd-f32": ("flash_attention_bwd",
                                lambda: _flash_bwd_case(torch.float32)),
    "ssd_scan-bf16": ("ssd_scan", lambda: _ssd_case(torch.bfloat16)),
    "ssd_scan-f32": ("ssd_scan", lambda: _ssd_case(torch.float32)),
    "ssd_scan_bwd-bf16": ("ssd_scan_bwd",
                          lambda: _ssd_bwd_case(torch.bfloat16, False)),
    "ssd_scan_bwd-f32-dstate": ("ssd_scan_bwd",
                                lambda: _ssd_bwd_case(torch.float32, True)),
    "quantize_ef-f32": ("quantize_ef",
                        lambda: _quantize_case(torch.float32)),
    "quantize_ef-bf16": ("quantize_ef",
                         lambda: _quantize_case(torch.bfloat16)),
    "dequantize": ("dequantize", _dequantize_case),
    **{f"ps_aggregate-{s}": ("ps_aggregate",
                             lambda s=s: _ps_aggregate_case(s))
       for s in ("sgd", "momentum", "adam", "easgd_center", "average")},
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_op_on_meta_counts_its_formula(case):
    """The op returns meta tensors of the kernel's output shapes and
    dtypes, records one call with the hand formula's FLOPs and bytes,
    and moves no launch count."""
    name, make = KERNEL_CASES[case]
    call, want_out, want_flops, want_bytes = make()
    before = ops.launch_counts()
    counter = roofline.ProgramCounter()
    with counter:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(t.shape), t.dtype) for t in out] == want_out
    assert all(t.device.type == "meta" for t in out)
    assert ops.launch_counts() == before
    tally = counter.by_key[name]
    assert (tally.calls, tally.flops, tally.bytes) == (1, want_flops,
                                                       want_bytes)
    # allocating the outputs moves no bytes
    assert set(counter.by_key) == {name}


def test_kernel_op_on_meta_without_a_counter_counts_nothing():
    q = _meta((1, 8, 2, 16))
    o = ops.flash_attention(q, q, q, causal=True)
    assert o.shape == q.shape and o.device.type == "meta"


def test_mixed_meta_and_cpu_tensors_raise():
    with pytest.raises(ValueError, match="meta"):
        ops.dequantize(_meta((256,), torch.int8), torch.ones(1))


def test_flash_attention_differentiates_on_meta_through_k4b_cost():
    """``FlashAttention``'s backward on meta records K4b's cost."""
    from repro_torch.models.attention import flash_attention
    B, S, H, hd = 1, 16, 2, 16

    def step(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.sum(), (q, k, v))
    counter = roofline.ProgramCounter()
    args = [_meta((B, S, H, hd)) for _ in range(3)]
    with counter:
        grads = step(*args)
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert counter.by_key["flash_attention"].calls == 1
    assert counter.by_key["flash_attention_bwd"].calls == 1
    pairs = S * (S + 1) // 2
    assert counter.by_key["flash_attention_bwd"].flops == \
        10 * B * H * hd * pairs


def test_ssd_scan_differentiates_on_meta_through_k5b_cost():
    """``SSDScan``'s backward on meta records K5b's cost, without dstate
    (a loss of y alone)."""
    from repro_torch.models.mamba import ssd_scan
    B, S, H, P, G, N, chunk = 1, 64, 2, 16, 1, 16, 32

    def step(x, dt, a_log, b, c):
        ts = [t.requires_grad_() for t in (x, dt, a_log, b, c)]
        y, _ = ssd_scan(*ts, chunk=chunk)
        return torch.autograd.grad(y.sum(), ts)
    args = [_meta((B, S, H, P)), _meta((B, S, H)), _meta((H,)),
            _meta((B, S, G, N)), _meta((B, S, G, N))]
    counter = roofline.ProgramCounter()
    with counter:
        grads = step(*args)
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert counter.by_key["ssd_scan"].calls == 1
    cost = roofline.kernel_cost("ssd_scan_bwd", B=B, S=S, H=H, P=P, G=G,
                                N=N, chunk=chunk, dtype=torch.float32)
    tally = counter.by_key["ssd_scan_bwd"]
    assert (tally.calls, tally.flops, tally.bytes) == (1, cost.flops,
                                                       cost.bytes)


def test_ssd_scan_bwd_cost_at_full_width():
    """K5b at the learner's (1, 2048) mamba2-1.3b shape, bf16: the
    formula's FLOPs and bytes (inputs and outputs once), bound by the
    operations at the bf16 peak, 3.642 times K5's FLOPs at the same
    shape."""
    shape = dict(B=1, S=2048, H=64, P=64, G=1, N=128, chunk=256,
                 dtype="bfloat16")
    cost = roofline.kernel_cost("ssd_scan_bwd", **shape)
    assert (cost.flops, cost.bytes) == (23_740_022_784, 53_477_888)
    assert cost.bound_by == "operations"
    assert 1e3 * cost.bound_s == pytest.approx(0.024004, rel=1e-4)
    fwd = roofline.kernel_cost("ssd_scan", **shape)
    assert cost.flops / fwd.flops == pytest.approx(3.6421, rel=1e-4)
    with_state = roofline.kernel_cost("ssd_scan_bwd", dstate=True, **shape)
    assert with_state.bytes - cost.bytes == 4 * 64 * 64 * 128


# ------------------------------------------------------ bytes of aten ops
def test_views_count_no_bytes():
    def views(x):
        y = x.view(64, 32).t().transpose(0, 1).permute(1, 0)
        y = y.unsqueeze(0).expand(3, 32, 64)[1:, 2:5].select(0, 1)
        y = y.detach().as_strided((4, 4), (1, 4)).t()
        return y, x.reshape(2, -1)
    a = roofline.count_program(views, torch.ones(32, 64))
    assert a["hbm_bytes_per_device"] == 0 and a["flops_per_device"] == 0


def test_aten_op_bytes():
    """Inputs read once plus outputs written once; a copy reads its
    source only; a gather reads its rows; a broadcast input once."""
    n = 1000
    x = torch.ones(n)
    assert roofline.count_program(lambda t: t + 1, x)[
        "hbm_bytes_per_device"] == 2 * 4 * n
    assert roofline.count_program(
        lambda t: t.to(torch.bfloat16), x)["hbm_bytes_per_device"] == 6 * n
    assert roofline.count_program(
        lambda a, b: a.copy_(b), x, torch.ones(n))[
            "hbm_bytes_per_device"] == 8 * n
    table = torch.ones(500, 64)
    idx = torch.zeros(7, dtype=torch.int64)
    assert roofline.count_program(
        lambda w, i: torch.nn.functional.embedding(i, w), table, idx)[
            "hbm_bytes_per_device"] == 7 * 8 + 2 * 7 * 64 * 4
    row = torch.ones(64)
    assert roofline.count_program(
        lambda r: r.expand(100, 64) * 2, row)[
            "hbm_bytes_per_device"] == 64 * 4 + 100 * 64 * 4

    def write_rows(cache, i, v):
        cache[i] = v               # index_put_: the rows, not the cache
    assert roofline.count_program(write_rows, table, idx, torch.ones(
        7, 64))["hbm_bytes_per_device"] == 7 * 8 + 2 * 7 * 64 * 4


def test_mm_flops_and_peak_by_dtype():
    a = roofline.count_program(lambda x, y: x @ y, torch.ones(64, 128),
                               torch.ones(128, 32))
    flops = 2 * 64 * 128 * 32
    assert a["flops_per_device"] == flops
    assert a["compute_s"] == flops / roofline.PEAK_FLOPS["float32"]
    b = roofline.count_program(
        lambda x, y: x @ y, torch.ones(64, 128, dtype=torch.bfloat16),
        torch.ones(128, 32, dtype=torch.bfloat16))
    assert b["compute_s"] == flops / roofline.PEAK_FLOPS["bfloat16"]
    assert a["memory_s"] == a["hbm_bytes_per_device"] / roofline.HBM_BW
    assert (a["ici_bytes_per_device"], a["dcn_bytes_per_device"],
            a["collective_bytes_by_kind"], a["collective_s"]) == (
        0.0, 0.0, {}, 0.0)


def test_breakdown_attributes_by_op_and_kernel():
    p = LMPlugin({}, device="cpu")
    total = p.program_cost(2, {})
    twin = p._meta                 # the meta twin program_cost built
    assert twin.device.type == "meta" and twin.model is p.model
    tok = np.zeros((2, 32), np.int64)
    rows = roofline.breakdown(twin.flat_loss_grad, torch.ones(p.flat_size),
                              {"tokens": tok, "labels": tok}, top=100)
    names = {r["op"] for r in rows}
    assert {"mm", "flash_attention", "flash_attention_bwd"} <= names
    assert [r["GB"] for r in rows] == sorted((r["GB"] for r in rows),
                                             reverse=True)
    assert sum(r["flops"] for r in rows) == total["flops_per_device"]


# -------------------------------------- programs against the reference
@pytest.mark.parametrize("batch_docs", [2, 4])
def test_lm_step_flops_match_the_reference_hlo(batch_docs):
    """The smoke ``stablelm-1.6b`` learner step (2 layers, d_model 64,
    seq_len 32): the reference measured 38,273,024 at 2 documents."""
    want = jax_roofline.analyze_hlo_text(
        jax_learner.LMPlugin({"arch": "stablelm-1.6b"}).lowered_hlo(
            batch_docs, {}), jax_roofline.KERNEL_SCOPES)["flops_per_device"]
    got = LMPlugin({"arch": "stablelm-1.6b"}, device="cpu").program_cost(
        batch_docs, {})
    assert abs(got["flops_per_device"] - want) <= LM_FLOPS_RTOL * want
    assert got["hbm_bytes_per_device"] > 0


# the smoke ssm step against the reference's HLO count: at one chunk (S
# 32) XLA drops the inter-chunk products whose results are dead (the
# first chunk's zero incoming state, the dropped final state), which the
# port's K5/K5b formulas count in every chunk; JAX's jnp scan computes
# the full Q x Q square where the formulas count the s <= t triangle.
# 1.0895 at S 32, 1.0558 at 64, 0.9942 at 128.
SSM_STEP_RATIO = {32: 1.0895354645354645, 128: 0.9941886964448496}


@pytest.mark.parametrize("seq_len", sorted(SSM_STEP_RATIO))
def test_ssm_step_flops_match_the_reference_hlo(seq_len):
    """The smoke ``mamba2-1.3b`` learner step (2 layers, d_model 64, 8
    heads of P 16, N 16, chunk 32) at 2 documents: K5 and K5b counted by
    their formulas against the reference's HLO count of the same step."""
    data = {"seq_len": seq_len}
    want = jax_roofline.analyze_hlo_text(
        jax_learner.LMPlugin({"arch": "mamba2-1.3b"}).lowered_hlo(2, data),
        jax_roofline.KERNEL_SCOPES)["flops_per_device"]
    got = LMPlugin({"arch": "mamba2-1.3b"}, device="cpu").program_cost(
        2, data)
    assert got["flops_per_device"] / want == pytest.approx(
        SSM_STEP_RATIO[seq_len], rel=1e-9)
    assert got["hbm_bytes_per_device"] > 0


def test_mlp_step_flops_match_the_reference_hlo():
    fw = {"d_in": 16, "n_classes": 4}
    want = jax_roofline.analyze_hlo_text(
        jax_learner.MLPPlugin(fw).lowered_hlo(8, {}))["flops_per_device"]
    assert want == 45056
    got = MLPPlugin(fw, device="cpu").program_cost(8, {})
    assert abs(got["flops_per_device"] - want) <= MLP_FLOPS_RTOL * want


def _ready(perf, timeout=240):
    assert wait_until(lambda: perf.state in ("ready", "error"),
                      timeout=timeout), perf.state
    assert perf.state == "ready", perf.error
    return perf.analysis


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b"])
def test_decode_step_flops_match_the_reference_engine(arch):
    """One batched decode of 2 slots over a 64-position cache: the
    reference engine's ``perf`` analysis of its decode jit."""
    jeng = JaxEngine(jax_base.reduce_for_smoke(jax_get_arch(arch)),
                     capacity=2, max_seq=64)
    jeng.start()
    want = _ready(jeng.perf)["flops_per_device"]
    eng = InferenceEngine(base.reduce_for_smoke(get_arch(arch)),
                          capacity=2, max_seq=64, device="cpu")
    eng.start()
    got = _ready(eng.perf)["flops_per_device"]
    assert abs(got - want) <= DECODE_FLOPS_RTOL * want
    assert eng.perf.unit == "decode_step"
    jeng.release()
    eng.release()


def test_full_width_stablelm_counts_on_meta_in_seconds():
    """24 layers, d_model 2048: the learner step at 2 x 512 tokens and a
    decode step of 4 slots over 1,024 positions, each within
    MODEL_FLOPS_RANGE of ``model_flops`` and counted in seconds."""
    cfg = get_arch("stablelm-1.6b")
    t0 = time.perf_counter()
    train = LMPlugin({}, cfg=cfg, device="cpu").program_cost(
        2, {"seq_len": 512})
    t1 = time.perf_counter()
    eng = InferenceEngine(cfg, capacity=4, max_seq=1024, device="cpu")
    decode = eng._decode_cost(_meta_params(eng))()
    t2 = time.perf_counter()
    lo, hi = MODEL_FLOPS_RANGE
    for a, shape in ((train, base.ShapeSpec("t", 512, 2, "train")),
                     (decode, base.ShapeSpec("d", 1024, 4, "decode"))):
        ratio = a["flops_per_device"] / roofline.model_flops(cfg, shape)
        assert lo <= ratio <= hi, (shape, ratio)
    assert t1 - t0 < 30 and t2 - t1 < 30, (t1 - t0, t2 - t1)
    # the decode step reads at least its bf16 weights (all but the
    # embedding table, of which it gathers 4 rows)
    assert decode["hbm_bytes_per_device"] > 2 * (
        cfg.n_params() - cfg.vocab_size * cfg.d_model)


def _meta_params(eng):
    from repro_torch.models.layers import map_leaves
    return map_leaves(lambda _, d: torch.empty(
        d.shape, dtype=eng.model.dtype, device="meta"),
        eng.model.param_defs())


# ------------------------------------------------ chip_smoke's bounds
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


# PERF.md's table of TPU kernels, as chip_smoke.py printed it before
# its bounds came from kernel_cost: bound ms at each kernel's head shape,
# four to five significant digits
TABLE_BOUNDS = [
    ("ps_aggregate", dict(NL=2, F=256_913_920, solver="adam"), 2.4541),
    ("quantize_ef", dict(F=1_027_655_680, x_dtype="bfloat16"), 3.3792),
    ("dequantize", dict(F=1_027_655_680), 1.5386),
    ("attention", (1, 4096, 4096, 32, 32, 64, "bfloat16", True), 0.06950),
    ("attention", (2, 512, 512, 32, 32, 64, "bfloat16", True), 0.005008),
    ("attention", (1, 512, 512, 32, 32, 64, "bfloat16", True), 0.002504),
    ("flash_attention_bwd", dict(B=1, Sq=4096, Sk=4096, H=32, KV=32, hd=64,
                                 dtype="bfloat16", causal=True), 0.1738),
    ("ssd", (2, 2048, 64, 64, 1, 128, 256, "bfloat16"), 0.02222),
    # K5b's row, from kernel_cost since its first run
    ("ssd_scan_bwd", dict(B=1, S=2048, H=64, P=64, G=1, N=128, chunk=256,
                          dtype="bfloat16"), 0.024004),
]


@pytest.mark.parametrize("name,shape,want", TABLE_BOUNDS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(TABLE_BOUNDS)])
def test_chip_smoke_bounds_are_kernel_costs(name, shape, want):
    """The bound ``chip_smoke.py`` prints comes from ``kernel_cost`` and
    equals PERF.md's table to its printed digits."""
    cs = _chip_smoke()
    if name == "attention":
        got, by = cs.attention_bound_ms(*shape)
    elif name == "ssd":
        got, by = cs.ssd_bound_ms(*shape)
    else:
        got, by = cs.bound(name, **shape)
        cost = roofline.kernel_cost(name, **shape)
        assert (got, by) == (1e3 * cost.bound_s, cost.bound_by)
    assert got == pytest.approx(want, rel=5e-4)
    assert by in ("bytes", "operations")
    sys.modules.pop("chip_smoke_bounds", None)
