"""Tests of the port that need the card: the CUDA kernels (flash
attention and its backward, the PS update and the int8 wire, the SSD
scan and its backward) against their plain PyTorch versions, the
wrappers' checks, the serving engines and the dense and ssm learner
steps on CUDA against the same on the CPU, the platform and the
service (``DLaaSCore``) training and serving on CUDA, the moe
block and a moe engine on CUDA, the hybrid (jamba) family's kernel
shapes, engine and learner step on CUDA, K4/K4b at whisper-large-v3's
and qwen2-vl-2b's attention shapes with the two families' model-level
steps on CUDA, and the pjit distribution: a ``distribution: pjit``
manifest trained on CUDA against the CPU, and the sharded step on a
1-rank NCCL mesh against the mesh-less step; the PS solvers' server
updates (K1), int8 push (K2, K3) and means on a (4, F) stack, K4/K4b at
a zero3_sp rank's shapes (``q_offset`` > 0), and the zero3_sp step on a
1-rank NCCL mesh; K4 and K4b at kimi-k2's head dim 112 and at
granite-20b's 48 query heads on one KV head, and
the moe and hybrid families' expert-parallel steps on a 1-rank NCCL
mesh; the launch-shape tuner (``kernels/autotune.py``): every candidate
of K1-K4 gives the default's bits, a failing one raises, and its probes
leave the launch counts alone. The tuner's cache lives in a file of the
module's temporary directory.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is false (the kernel has no CPU mode). This file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, those of
tests/test_kernels.py:34, for attention; each other kernel's beside its
tests. TF32 is switched off so that the plain version's float32
products are full float32.
"""
import dataclasses
import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import reduce_for_smoke
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import InferenceEngine

# the port's models without remat, as the reference's tests build theirs
NO_REMAT = {"remat": "none"}

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _autotune_cache(tmp_path_factory):
    """The tuner's cache in a file of this module's own (no earlier
    run's records steer a test)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLAAS_AUTOTUNE_CACHE", str(
            tmp_path_factory.mktemp("autotune") / "cache.json"))
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc: the CUDA "
                    "kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, Sq, Sk, H, KV, hd, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", dtype)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _on_tensor_cores(q):
    """bf16 at head dim 64 or 128: the tensor-core instances of K4/K4b
    (also at 112, ``test_flash_kernel_at_head_dim_112`` and
    ``test_flash_bwd_kernel_at_head_dim_112``)."""
    return q.dtype == torch.bfloat16 and q.shape[3] in (64, 128)


def _check(q, k, v, causal, q_offset=0):
    before, before_tc = kfa.launches, kfa.launches_tc
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kfa.launches == before + 1
    assert kfa.launches_tc == before_tc + _on_tensor_cores(q)
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal", [
    (1, 512, 32, 32, 64, torch.bfloat16, True),     # StableLM-1.6B prefill
    (2, 256, 8, 2, 128, torch.float32, False),      # GQA
    (3, 37, 4, 2, 16, torch.float32, True),         # ragged
    (2, 33, 4, 1, 32, torch.bfloat16, True),        # MQA, ragged
])
def test_flash_kernel_vs_plain(cuda, B, S, H, KV, hd, dtype, causal):
    _check(*_qkv(B, S, S, H, KV, hd, dtype), causal)


@pytest.mark.parametrize("q_offset", [0, 9])
def test_flash_kernel_q_offset(cuda, q_offset):
    q, k, v = _qkv(2, 23, 41, 4, 2, 64, torch.float32, seed=1)
    _check(q, k, v, True, q_offset)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views into wider tensors: read through their strides."""
    q, k, v = _qkv(2, 40, 40, 8, 4, 64, torch.float32, seed=2)
    qkv = torch.cat([q, k, v], dim=2)          # (B, S, H + 2 KV, hd)
    qs, ks, vs = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    assert not qs.is_contiguous()
    _check(qs, ks, vs, True)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 8, 8, 2, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half(), causal=True)
    q48, k48, v48 = _qkv(1, 8, 8, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError):
        ops.flash_attention(q48, k48, v48, causal=True)
    with pytest.raises(ValueError):             # head_dim not contiguous
        ops.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                            k, v, causal=True)
    with pytest.raises(ValueError):             # CPU and CUDA mixed
        ops.flash_attention(q, k.cpu(), v, causal=True)


def test_engine_on_cuda_matches_cpu(cuda):
    """One flat vector served on the card (prefill through the kernel)
    and on the CPU (plain version): same greedy tokens (f32, 2 layers),
    and the kernel launched once per layer per prefill batch."""
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 8, 5, 11)]
    max_news = [3, 6, 4, 5]
    flat = rng.standard_normal(
        InferenceEngine(cfg, device="cpu").flat_size).astype(np.float32)
    flat *= 0.1

    def serve(device):
        eng = InferenceEngine(cfg, capacity=2, max_seq=32, device=device)
        eng.start(flat)
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
        ops.reset_launch_counts()
        t = threading.Thread(target=eng.run, daemon=True)
        t.start()
        for r in reqs:
            assert r.wait(120) and r.status == "DONE"
        launches = ops.launch_counts()[kfa.NAME]
        eng.drain()
        t.join(20)
        assert not t.is_alive()
        return [r.tokens for r in reqs], launches, eng.prefill_batches

    gpu_tokens, launches, batches = serve("cuda")
    cpu_tokens, cpu_launches, _ = serve("cpu")
    assert gpu_tokens == cpu_tokens
    assert launches == cfg.n_layers * batches and cpu_launches == 0


# ---------------------------------------------------------------------------
# The training slice: K4 with LSE, K4b, K1, K2, K3, and a training step
# ---------------------------------------------------------------------------

from repro_torch.core.software_ps import SoftwareParameterServer  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfab  # noqa: E402
from repro_torch.kernels import ps_aggregate as kagg  # noqa: E402
from repro_torch.kernels import quantize as kq  # noqa: E402
from repro_torch.runtime.learner import LMPlugin  # noqa: E402

BWD_TOL = 2e-3           # tests/test_kernels.py:139-162 (f32)
BWD_BF16_REL_L2 = 2e-2   # bf16: relative L2 per gradient


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal,q_offset", [
    (2, 512, 32, 32, 64, torch.bfloat16, True, 0),   # training shape
    (2, 256, 8, 2, 128, torch.float32, False, 0),    # GQA
    (3, 37, 4, 2, 16, torch.float32, True, 9),       # ragged, q_offset
    (2, 33, 4, 1, 32, torch.float32, True, 0),       # MQA, ragged
])
def test_flash_lse_and_bwd_kernels_vs_plain(cuda, B, S, H, KV, hd, dtype,
                                            causal, q_offset):
    q, k, v = _qkv(B, S, S, H, KV, hd, dtype, seed=4)
    do = _qkv(B, S, S, H, H, hd, dtype, seed=5)[0]
    o, lse = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                             q_offset=q_offset,
                                             return_lse=True)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    before, before_tc = kfab.launches, kfab.launches_tc
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  q_offset=q_offset)
    torch.cuda.synchronize()
    assert kfab.launches == before + 1
    assert kfab.launches_tc == before_tc + _on_tensor_cores(q)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       q_offset=q_offset)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
        else:
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            assert rel <= BWD_BF16_REL_L2, rel


@pytest.mark.parametrize("causal,q_offset", [(True, 9), (False, 0)])
def test_flash_bwd_kernel_other_lengths(cuda, causal, q_offset):
    """Sq != Sk, ragged tiles on both sides, GQA."""
    q, k, v = _qkv(2, 23, 41, 4, 2, 64, torch.float32, seed=6)
    do = _qkv(2, 23, 41, 4, 4, 64, torch.float32, seed=7)[0]
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


# the bf16 tensor-core instance (hd 64 and 128): forward with LSE and
# backward at shapes the training shape above does not reach
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,q_offset", [
    (2, 256, 256, 8, 2, 128, False, 0),     # hd 128, GQA
    (2, 256, 256, 8, 2, 128, True, 0),      # hd 128, GQA, causal
    (1, 300, 300, 4, 2, 64, True, 0),       # ragged tile tail
    (3, 37, 37, 4, 2, 64, True, 0),         # shorter than one tile
    (2, 23, 41, 4, 2, 64, True, 9),         # Sq != Sk, q_offset
    (2, 23, 41, 4, 2, 128, False, 0),       # Sq != Sk, hd 128
    (2, 33, 33, 4, 1, 128, True, 0),        # MQA
    (2, 200, 200, 8, 1, 64, True, 0),       # MQA, two key blocks
])
def test_flash_tensor_core_kernels_vs_plain(cuda, B, Sq, Sk, H, KV, hd,
                                            causal, q_offset):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=8)
    do = _qkv(B, Sq, Sq, H, H, hd, torch.bfloat16, seed=9)[0]
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= BWD_BF16_REL_L2, rel


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_tensor_core_kernels_are_deterministic(cuda, hd):
    """Two calls on one input give the same bits (no atomics)."""
    q, k, v = _qkv(2, 300, 300, 8, 2, hd, torch.bfloat16, seed=10)
    do = _qkv(2, 300, 300, 8, 8, hd, torch.bfloat16, seed=11)[0]
    o1, l1 = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    o2, l2 = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    g1 = ops.flash_attention_bwd(q, k, v, o1, l1, do, causal=True)
    g2 = ops.flash_attention_bwd(q, k, v, o1, l1, do, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# kimi-k2's head dim 112: the hd-128 tiles of either instance with
# columns 112..127 zero-filled on load; causal and not, ragged Sq / Sk
# (past one key tile), q_offset, GQA 8 as kimi's 64 / 8
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", [
    (2, 300, 300, 8, 1, True, 0),
    (1, 37, 37, 16, 2, True, 0),
    (2, 23, 141, 8, 1, False, 0),
    (2, 23, 41, 8, 2, True, 9),
])
def test_flash_kernel_at_head_dim_112(cuda, dtype, B, Sq, Sk, H, KV, causal,
                                      q_offset):
    q, k, v = _qkv(B, Sq, Sk, H, KV, 112, dtype, seed=13)
    before, before_tc = kfa.launches, kfa.launches_tc
    o, lse = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
    torch.cuda.synchronize()
    assert kfa.launches == before + 1
    assert kfa.launches_tc == before_tc + (dtype == torch.bfloat16)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                             q_offset=q_offset,
                                             return_lse=True)
    tol = TOL[dtype]
    assert o.shape == q.shape and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    again = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert torch.equal(o, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,q_offset", [
    (2, 300, 300, 8, 1, True, 0),
    (1, 37, 37, 16, 2, True, 0),
    (2, 23, 141, 8, 1, False, 0),
    (2, 23, 41, 8, 2, True, 9),
])
def test_flash_bwd_kernel_at_head_dim_112(cuda, dtype, B, Sq, Sk, H, KV,
                                          causal, q_offset):
    """K4b at kimi-k2's head dim 112 (the hd-128 tiles, columns 112..127
    zero-filled) against its plain version: bf16 within relative L2
    ``BWD_BF16_REL_L2`` per gradient, f32 within ``BWD_TOL``; one launch,
    on the tensor cores in bf16; two calls give the same bits."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    q, k, v = _qkv(B, Sq, Sk, H, KV, 112, dtype, seed=14)
    do = _qkv(B, Sq, Sq, H, H, 112, dtype, seed=15)[0]
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    before, before_tc = kfab.launches, kfab.launches_tc
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert kfab.launches == before + 1
    assert kfab.launches_tc == before_tc + (dtype == torch.bfloat16)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
        else:
            rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
            assert rel <= BWD_BF16_REL_L2, rel
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_kernels_at_granite_mqa(cuda):
    """K4 (with and without its LSE) and K4b at granite-20b's 48 query
    heads on one KV head, hd 128, bf16, causal, 300 rows (a ragged key
    block; the dk/dv kernel's one KV head walks all 48 heads) against
    their plain versions, on the tensor cores; two calls give the same
    bits."""
    q, k, v = _qkv(1, 300, 300, 48, 1, 128, torch.bfloat16, seed=32)
    do = _qkv(1, 300, 300, 48, 48, 128, torch.bfloat16, seed=33)[0]
    _check(q, k, v, True)
    o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=True,
                                             return_lse=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    before, before_tc = kfab.launches, kfab.launches_tc
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (kfab.launches, kfab.launches_tc) == (before + 1, before_tc + 1)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= BWD_BF16_REL_L2, rel
    o2, lse2 = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_tensor_core_kernels_reject_unaligned_rows(cuda):
    """bf16 at hd 64 reads 16-byte chunks: a view whose rows are not
    16-byte aligned raises (no silent copy); f32 reads it as it is."""
    q, k, v = _qkv(1, 16, 16, 2, 2, 64, torch.float32, seed=12)
    wide = torch.zeros(1, 16, 2, 68, device="cuda")
    wide[..., 4:] = q
    qv = wide[..., 4:]                      # rows start 8 bytes in (f32)
    _check(qv, k, v, True)                  # f32: CUDA-core instance
    wb = torch.zeros(1, 16, 2, 68, device="cuda", dtype=torch.bfloat16)
    wb[..., 4:] = q.to(torch.bfloat16)
    qb = wb[..., 4:]                        # rows start 8 bytes in
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attention(qb, kb, vb, causal=True)
    o, lse = ops.flash_attention(qb.contiguous(), kb, vb, causal=True,
                                 return_lse=True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(qb, kb, vb, o, lse, o, causal=True)


def _ties(n, seed):
    """x, err with exact ties: y = x + err = (k + 0.5) * scale at every
    even position (err = 0 there), each block's absmax 127 * scale."""
    rng = np.random.RandomState(seed)
    scale = np.float32(0.25)
    y = ((rng.randint(-126, 126, size=n) + 0.5) * scale).astype(np.float32)
    y[::256] = 127 * scale            # absmax of each block: scale exact
    err = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    err[::2] = 0.0
    return y - err, err


@pytest.mark.parametrize("n", [768, 4096, 1 << 20])   # 768: a partial CTA
@pytest.mark.parametrize("ties", [False, True])
def test_quantize_kernels_vs_plain(cuda, n, ties):
    if ties:
        x, e = _ties(n, 6)
    else:
        rng = np.random.RandomState(7)
        x = rng.standard_normal(n).astype(np.float32)
        e = (rng.standard_normal(n) * 0.1).astype(np.float32)
    xc, ec = torch.from_numpy(x).cuda(), torch.from_numpy(e).cuda()
    q, s, ne = ops.quantize_ef(xc, ec)
    qr, sr, er = ref.quantize_ref(xc, ec)
    torch.cuda.synchronize()
    assert torch.equal(q, qr)
    torch.testing.assert_close(s, sr, rtol=1e-6, atol=0)
    torch.testing.assert_close(ne, er, atol=1e-6, rtol=0)
    # in place over err, and from a bf16 input
    before = kq.QUANTIZE.launches
    q2, _, ne2 = ops.quantize_ef(xc, ec.clone(), out_err=ec)
    assert ne2.data_ptr() == ec.data_ptr() and torch.equal(q2, q)
    xb = xc.to(torch.bfloat16)
    qb, sb, eb = ops.quantize_ef(xb, er)
    qbr, sbr, ebr = ref.quantize_ref(xb, er)
    assert torch.equal(qb, qbr) and torch.equal(sb, sbr)
    torch.testing.assert_close(eb, ebr, atol=1e-6, rtol=0)
    assert kq.QUANTIZE.launches == before + 2
    # K3 into a slice of a wider buffer, exactly equal
    row = torch.full((2, n), 7.0, device="cuda")
    before = kq.DEQUANTIZE.launches
    out = ops.dequantize(q, s, out=row[1])
    torch.cuda.synchronize()
    assert kq.DEQUANTIZE.launches == before + 1
    assert out.data_ptr() == row[1].data_ptr()
    assert torch.equal(row[1], ref.dequantize_ref(q, s))
    assert (row[0] == 7.0).all()


@pytest.mark.parametrize("solver", ["sgd", "momentum", "adam",
                                    "easgd_center", "average"])
@pytest.mark.parametrize("nl,f", [(2, 2048), (8, 4096), (3, 9 * 256)])
def test_ps_aggregate_kernel_vs_plain(cuda, solver, nl, f):
    rng = np.random.RandomState(8)
    wide = torch.from_numpy(rng.standard_normal((nl, f + 512))
                            .astype(np.float32)).cuda()
    rows = wide[:, 256:256 + f]               # strided column slice
    state = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.standard_normal(f), rng.standard_normal(f) * 0.1,
        np.abs(rng.standard_normal(f)) * 0.1)]
    mine = [t.clone() for t in state]
    plain = [t.clone() for t in state]
    kw = dict(solver=solver, lr=0.01)
    before = kagg.launches
    for step in (1, 2, 3):
        ops.ps_aggregate(rows, *mine, step, **kw)
        ref.ps_aggregate_ref(rows, *plain, step, **kw)
    torch.cuda.synchronize()
    assert kagg.launches == before + 3
    torch.testing.assert_close(mine[0], plain[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mine[1], plain[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(mine[2], plain[2], atol=1e-6, rtol=0)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(300, device="cuda")
    with pytest.raises(ValueError):               # not a multiple of 256
        ops.quantize_ef(x, x)
    with pytest.raises(TypeError):
        ops.quantize_ef(torch.zeros(256, device="cuda").half(),
                        torch.zeros(256, device="cuda"))
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        ops.ps_aggregate(torch.zeros(2, 256, device="cuda"),
                         *(torch.zeros(256) for _ in range(3)), 1)
    with pytest.raises(ValueError):
        ops.ps_aggregate(torch.zeros(2, 256, device="cuda"),
                         *(torch.zeros(256, device="cuda")
                           for _ in range(3)), 1, solver="adagrad")


def test_training_step_on_cuda_matches_cpu(cuda):
    """One flat vector, one batch: ``LMPlugin.flat_loss_grad`` on the
    card (K4 with LSE, K4b) against the CPU (plain versions), f32 smoke
    width; then one int8 + adam PS round with 2 learners on both."""
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    rng = np.random.RandomState(9)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 2, 65)).astype(np.int32)
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    ops.reset_launch_counts()
    lg, gg = gpu.flat_loss_grad(flat.cuda(), batches[0])
    lc, gc = cpu.flat_loss_grad(flat, batches[0])
    counts = ops.launch_counts()
    assert counts[kfa.NAME] == cfg.n_layers
    assert counts[kfab.NAME] == cfg.n_layers
    assert abs(lg.item() - lc.item()) <= 1e-4
    torch.testing.assert_close(gg.cpu(), gc, atol=2e-3, rtol=2e-3)

    # the same two pushes on both devices: K2 -> K3 -> K1 on the card
    # against the plain versions on the CPU
    grads = [gc, cpu.flat_loss_grad(flat, batches[1])[1]]

    def ps_round(dev):
        ps = SoftwareParameterServer(flat, n_shards=2, n_learners=2,
                                     optimizer="adam", lr=1e-3,
                                     compression="int8", device=dev)
        clients = [ps.make_client(i) for i in range(2)]
        for i in range(2):
            ps.join(i)
        ts = [threading.Thread(target=clients[i].push,
                               args=(grads[i].to(dev),))
              for i in range(2)]
        [t.start() for t in ts]
        [t.join(60) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert ps.stats()["agg_rounds"] == 1
        return clients[0].pull().cpu()

    torch.testing.assert_close(ps_round("cuda"), ps_round("cpu"),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The ssm serving slice: K5 (SSD chunked scan) and the mamba2 engine
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssd_scan as kssd  # noqa: E402

SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}  # test_kernels.py:56


def _ssd_inputs(B, S, H, P, G, N, dtype, seed=0, a_log=None):
    """The inputs of tests/test_kernels.py:47-51, made with numpy."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))   # softplus
    b = rng.standard_normal((B, S, G, N)) * 0.3
    c = rng.standard_normal((B, S, G, N)) * 0.3
    al = np.zeros(H) if a_log is None else np.full(H, a_log)
    to = lambda a, dt_: torch.from_numpy(a.astype(np.float32)).to(
        "cuda", dt_)
    return (to(x, dtype), to(dt, torch.float32), to(al, torch.float32),
            to(b, dtype), to(c, dtype))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 128, 2, 16, 1, 16, 32),       # tests/test_kernels.py:41-45
    (2, 256, 4, 32, 2, 16, 64),       # G = 2
    (1, 128, 4, 64, 1, 32, 128),
    (1, 300, 4, 64, 1, 128, 256),     # ragged tail at chunk 256
    (2, 7, 2, 16, 1, 16, 32),         # shorter than a chunk
    (2, 512, 64, 64, 1, 128, 256),    # mamba2-1.3b widths
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_vs_plain(cuda, B, S, H, P, G, N, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, G, N, dtype)
    before = kssd.launches
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert kssd.launches == before + 1
    y_ref, state_ref = ref.ssd_scan_ref(*args, chunk=chunk)
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=tol, rtol=tol)


def test_ssd_scan_kernel_chunk_invariance(cuda):
    """tests/test_kernels.py:122: the state carries across 8 and 4
    chunks alike (slow decay couples far positions)."""
    x, dt, _, b, c = _ssd_inputs(1, 512, 1, 8, 1, 8, torch.float32, seed=2)
    dt = torch.full_like(dt, 0.5)
    a_log = torch.full((1,), -1.0, device="cuda")
    y64, s64 = ops.ssd_scan(x, dt, a_log, b, c, chunk=64)
    y128, s128 = ops.ssd_scan(x, dt, a_log, b, c, chunk=128)
    torch.testing.assert_close(y64, y128, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s64, s128, atol=1e-3, rtol=1e-3)


def test_ssd_scan_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a_log, b, c = _ssd_inputs(1, 64, 4, 16, 2, 16, torch.float32)
    with pytest.raises(TypeError):                # fp16
        ops.ssd_scan(x.half(), dt, a_log, b.half(), c.half(), chunk=32)
    with pytest.raises(TypeError):                # dt not f32
        ops.ssd_scan(x, dt.bfloat16(), a_log, b, c, chunk=32)
    with pytest.raises(ValueError):               # H % G != 0
        ops.ssd_scan(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(),
                     a_log[:3], b, c, chunk=32)
    with pytest.raises(ValueError):               # not contiguous
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                     a_log, b, c, chunk=32)
    with pytest.raises(ValueError):               # chunk past the kernel's
        ops.ssd_scan(*_ssd_inputs(1, 600, 2, 8, 1, 8, torch.float32),
                     chunk=512)
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        ops.ssd_scan(x, dt.cpu(), a_log, b, c, chunk=32)


# the bf16 tensor-core instance (P 64, N 64 or 128): ragged tails, G = 2,
# N 64 and 128, chunk 128 and 256, one chunk and several
TC_SSD_SHAPES = [
    (1, 300, 4, 64, 1, 128, 256),     # ragged tail at chunk 256
    (2, 700, 8, 64, 2, 128, 256),     # G = 2, three chunks, ragged
    (1, 33, 2, 64, 1, 64, 256),       # shorter than a chunk, N 64
    (2, 2, 4, 64, 1, 128, 256),       # two positions
    (2, 512, 4, 64, 1, 64, 128),      # four chunks of 128, N 64
    (1, 384, 4, 64, 2, 128, 128),     # G = 2, chunk 128
]


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", TC_SSD_SHAPES)
def test_ssd_scan_tensor_core_instance_vs_plain(cuda, B, S, H, P, G, N,
                                                chunk):
    args = _ssd_inputs(B, S, H, P, G, N, torch.bfloat16, seed=3,
                       a_log=-0.5)
    before, before_tc = kssd.launches, kssd.launches_tc
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (kssd.launches, kssd.launches_tc) == (before + 1, before_tc + 1)
    y_ref, state_ref = ref.ssd_scan_ref(*args, chunk=chunk)
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=tol, rtol=tol)
    # W, the scaled x and S_in are rounded to bf16: ~2e-3 expected
    assert _rel_l2(y, y_ref) < 1e-2 and _rel_l2(state, state_ref) < 1e-2


def test_ssd_scan_tensor_core_instance_is_deterministic(cuda):
    """Two calls on one input give the same bits (no atomics)."""
    args = _ssd_inputs(2, 700, 8, 64, 2, 128, torch.bfloat16, seed=4)
    y1, s1 = ops.ssd_scan(*args, chunk=256)
    y2, s2 = ops.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("dtype,P,N,tc", [
    (torch.bfloat16, 64, 128, True), (torch.bfloat16, 64, 64, True),
    (torch.float32, 64, 128, False), (torch.bfloat16, 16, 16, False),
    (torch.bfloat16, 64, 32, False)])
def test_ssd_scan_instance_by_dtype_and_width(cuda, dtype, P, N, tc):
    """bf16 at P 64 / N 64|128 takes the tensor-core instance; f32 and
    other widths the CUDA-core one, shown by the per-instance count."""
    args = _ssd_inputs(1, 130, 2, P, 1, N, dtype, seed=5)
    before, before_tc = kssd.launches, kssd.launches_tc
    y, state = ops.ssd_scan(*args, chunk=64)
    torch.cuda.synchronize()
    assert kssd.launches == before + 1
    assert kssd.launches_tc == before_tc + int(tc)
    y_ref, state_ref = ref.ssd_scan_ref(*args, chunk=64)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("P,N", [(64, 128), (16, 16)])
def test_ssd_scan_reads_bf16_a_log(cuda, P, N):
    """The model keeps A_log in its dtype: both instances read a bf16
    a_log as the f32 one of the same values (no cast launched)."""
    x, dt, _, b, c = _ssd_inputs(1, 300, 4, P, 1, N, torch.bfloat16, seed=7)
    a16 = torch.linspace(-1.0, 0.5, 4, device="cuda").to(torch.bfloat16)
    y16, s16 = ops.ssd_scan(x, dt, a16, b, c, chunk=256)
    y32, s32 = ops.ssd_scan(x, dt, a16.float(), b, c, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y16, y32) and torch.equal(s16, s32)


def test_ssd_scan_tensor_core_instance_rejects_unaligned_rows(cuda):
    """The tensor-core instance copies 16-byte chunks: a contiguous x
    that starts 8 bytes into its storage raises (no silent copy), while
    f32 reads it as it is."""
    x, dt, a_log, b, c = _ssd_inputs(1, 64, 2, 64, 1, 128, torch.bfloat16,
                                     seed=6)
    store = torch.zeros(x.numel() + 4, dtype=torch.bfloat16, device="cuda")
    xv = store[4:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 8
    before = kssd.launches
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(xv, dt, a_log, b, c, chunk=64)
    assert kssd.launches == before
    f32 = [t.float() for t in (x, b, c)]
    s32 = torch.zeros(x.numel() + 1, device="cuda")
    xf = s32[1:].view(x.shape)
    xf.copy_(f32[0])
    y, _ = ops.ssd_scan(xf, dt, a_log, f32[1], f32[2], chunk=64)
    torch.testing.assert_close(
        y, ref.ssd_scan_ref(xf, dt, a_log, f32[1], f32[2], chunk=64)[0],
        atol=1e-3, rtol=1e-3)


def test_mamba2_engine_on_cuda_matches_cpu(cuda):
    """One flat vector served by the mamba2 smoke model on the card (K5
    in the prefill) and on the CPU (plain scan): same greedy tokens, K5
    launched once per layer per prefill batch."""
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 40, 2, 33, 7)]
    max_news = [3, 6, 4, 5, 7]
    flat = rng.standard_normal(
        InferenceEngine(cfg, device="cpu").flat_size).astype(np.float32)
    flat *= 0.1

    def serve(device):
        eng = InferenceEngine(cfg, capacity=2, max_seq=64, device=device)
        eng.start(flat)
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
        ops.reset_launch_counts()
        t = threading.Thread(target=eng.run, daemon=True)
        t.start()
        for r in reqs:
            assert r.wait(120) and r.status == "DONE"
        launches = ops.launch_counts()[kssd.NAME]
        eng.drain()
        t.join(20)
        assert not t.is_alive()
        return [r.tokens for r in reqs], launches, eng.prefill_batches

    gpu_tokens, launches, batches = serve("cuda")
    cpu_tokens, cpu_launches, _ = serve("cpu")
    assert gpu_tokens == cpu_tokens
    assert launches == cfg.n_layers * batches and cpu_launches == 0


# ---------------------------------------------------------------------------
# The ssm training slice: K5b (the SSD scan backward) and the ssm step
# ---------------------------------------------------------------------------

from repro_torch.kernels import ssd_scan_bwd as kssdb  # noqa: E402

# K5b against the plain backward run in float64 on float64 copies of the
# same inputs (the exact gradient of the values the kernel reads), every
# gradient elementwise at atol = rtol. f32: SSD_TOL (1e-3; the kernel sums
# in f32). bf16: 2e-2, compared in f32: the kernel computes in f32 from
# the same values and rounds dx, db and dc to bf16 (2^-8 relative) at the
# end. bf16 at P 64 with N 64 or 128 runs the tensor-core instance,
# whose computed operands enter their products as bf16 pairs hi + lo.
K5B_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
K5B_SHAPES = [
    (2, 512, 64, 64, 1, 128, 256),    # the learner's 2 x 512, full width
    (1, 2048, 64, 64, 1, 128, 256),   # its 1 x 2,048: eight chunks
    (2, 64, 8, 16, 1, 16, 32),        # the smoke width
    (1, 300, 4, 64, 1, 128, 256),     # ragged tail at chunk 256
    (2, 7, 2, 16, 1, 16, 32),         # shorter than a chunk
    (2, 256, 4, 32, 2, 16, 64),       # G = 2
    (2, 512, 4, 64, 1, 64, 128),      # N 64, four chunks of 128
    (1, 700, 8, 64, 2, 128, 256),     # G = 2, three chunks, ragged
]


def _k5b_on_tensor_cores(x, b):
    return x.dtype == torch.bfloat16 and x.shape[3] == 64 and \
        b.shape[3] in (64, 128)


def _ssd_bwd_inputs(B, S, H, P, G, N, dtype, seed, dstate):
    args = _ssd_inputs(B, S, H, P, G, N, dtype, seed=seed, a_log=-0.5)
    rng = np.random.RandomState(seed + 100)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(
        np.float32)).to("cuda", dtype)
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)).cuda() if dstate else None
    return args, dy, ds


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", K5B_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dstate", [False, True],
                         ids=["dstate-none", "dstate"])
def test_ssd_scan_bwd_kernel_vs_plain(cuda, B, S, H, P, G, N, chunk, dtype,
                                      dstate):
    args, dy, ds = _ssd_bwd_inputs(B, S, H, P, G, N, dtype, 8, dstate)
    before, before_tc = kssdb.launches, kssdb.launches_tc
    got = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    again = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert kssdb.launches == before + 2
    assert kssdb.launches_tc == before_tc + 2 * _k5b_on_tensor_cores(
        args[0], args[3])
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                None if ds is None else ds.double(),
                                chunk=chunk)
    tol = K5B_TOL[dtype]
    for g, a, w, inp in zip(got, again, want, args):
        assert g.dtype == inp.dtype and g.shape == inp.shape
        assert torch.equal(g, a)                   # no atomics
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,P,N,tc", [
    (torch.bfloat16, 64, 128, True), (torch.bfloat16, 64, 64, True),
    (torch.float32, 64, 128, False), (torch.bfloat16, 16, 16, False),
    (torch.bfloat16, 64, 32, False)])
def test_ssd_scan_bwd_instance_by_dtype_and_width(cuda, dtype, P, N, tc):
    """bf16 at P 64 / N 64|128 takes K5b's tensor-core instance; f32 and
    other widths the CUDA-core one, shown by the per-instance count; each
    within K5B_TOL of the float64 plain version."""
    args, dy, ds = _ssd_bwd_inputs(1, 130, 2, P, 1, N, dtype, 12, True)
    before, before_tc = kssdb.launches, kssdb.launches_tc
    got = ops.ssd_scan_bwd(*args, dy, ds, chunk=64)
    torch.cuda.synchronize()
    assert kssdb.launches == before + 1
    assert kssdb.launches_tc == before_tc + int(tc)
    want = ref.ssd_scan_bwd_ref(*(t.double() for t in args), dy.double(),
                                ds.double(), chunk=64)
    tol = K5B_TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, atol=tol, rtol=tol)


def test_ssd_scan_bwd_tensor_core_instance_rejects_unaligned_rows(cuda):
    """K5b's tensor-core instance copies 16-byte chunks: a contiguous bf16
    x that starts 8 bytes into its storage raises before any launch (no
    silent copy, no other instance)."""
    args, dy, _ = _ssd_bwd_inputs(1, 64, 2, 64, 1, 128, torch.bfloat16, 13,
                                  False)
    x = args[0]
    store = torch.zeros(x.numel() + 4, dtype=torch.bfloat16, device="cuda")
    xv = store[4:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 8
    before, before_tc = kssdb.launches, kssdb.launches_tc
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan_bwd(xv, *args[1:], dy, chunk=64)
    assert (kssdb.launches, kssdb.launches_tc) == (before, before_tc)


def test_ssd_scan_bwd_kernel_reads_bf16_a_log(cuda):
    """A bf16 a_log gives its gradient in bf16: the f32 one's, rounded."""
    args, dy, _ = _ssd_bwd_inputs(1, 300, 4, 64, 1, 128, torch.bfloat16, 9,
                                  False)
    a16 = torch.linspace(-1.0, 0.5, 4, device="cuda").to(torch.bfloat16)
    g16 = ops.ssd_scan_bwd(args[0], args[1], a16, *args[3:], dy, chunk=256)
    g32 = ops.ssd_scan_bwd(args[0], args[1], a16.float(), *args[3:], dy,
                           chunk=256)
    torch.cuda.synchronize()
    assert g16[2].dtype == torch.bfloat16
    assert torch.equal(g16[2], g32[2].to(torch.bfloat16))
    for a, b in zip(g16[:2] + g16[3:], g32[:2] + g32[3:]):
        assert torch.equal(a, b)


def test_ssd_scan_bwd_kernel_rejects_what_it_does_not_take(cuda):
    args, dy, ds = _ssd_bwd_inputs(1, 64, 4, 16, 2, 16, torch.float32, 10,
                                   True)
    x, dt, a_log, b, c = args
    before = kssdb.launches
    with pytest.raises(TypeError):                # fp16
        ops.ssd_scan_bwd(x.half(), dt, a_log, b.half(), c.half(),
                         dy.half(), chunk=32)
    with pytest.raises(TypeError):                # dy of another dtype
        ops.ssd_scan_bwd(*args, dy.bfloat16(), chunk=32)
    with pytest.raises(TypeError):                # dstate not f32
        ops.ssd_scan_bwd(*args, dy, ds.bfloat16(), chunk=32)
    with pytest.raises(ValueError):               # dy not contiguous
        ops.ssd_scan_bwd(*args, dy.transpose(2, 3).contiguous()
                         .transpose(2, 3), chunk=32)
    with pytest.raises(ValueError):               # CPU and CUDA mixed
        ops.ssd_scan_bwd(*args, dy.cpu(), chunk=32)
    assert kssdb.launches == before


def test_mamba_block_backward_launches_k5b_not_the_plain(cuda, monkeypatch):
    """A backward through ``mamba_block`` on CUDA tensors runs K5 and K5b
    once each and never the plain scan or its backward; its gradients
    equal the CPU's (2e-3)."""
    from repro_torch.models import mamba as tm
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    model_params = LMPlugin({}, cfg=cfg, device="cpu").model.init(
        torch.Generator().manual_seed(0))
    from repro_torch.models.transformer import layer_params
    p_cpu = {k: v.detach().clone().requires_grad_() for k, v in
             layer_params(model_params["blocks"], 0)["mamba"].items()}
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (2, 50, cfg.d_model)).astype(np.float32))

    def grads(p, x):
        xg = x.clone().requires_grad_()
        out = tm.mamba_block(xg, p, cfg)[0]
        names = sorted(p)
        return torch.autograd.grad(out.square().sum(),
                                   [xg] + [p[k] for k in names])
    want = grads(p_cpu, x)
    p_gpu = {k: v.detach().cuda().requires_grad_() for k, v in p_cpu.items()}

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card's path")
    monkeypatch.setattr(ref, "ssd_scan_ref", plain)
    monkeypatch.setattr(ref, "ssd_scan_bwd_ref", plain)
    ops.reset_launch_counts()
    got = grads(p_gpu, x.cuda())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts[kssd.NAME] == 1 and counts[kssdb.NAME] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("seq", [64, 50])
def test_ssm_training_step_on_cuda_matches_cpu(cuda, seq):
    """``LMPlugin.flat_loss_grad`` of the mamba2 smoke model on the card
    (K5, K5b) against the CPU (plain versions), f32: loss 1e-4, flat
    gradient 2e-3; two chunks of 32, and a ragged tail."""
    cfg = reduce_for_smoke(get_arch("mamba2-1.3b"))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    toks = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launch_counts()
    lg, gg = gpu.flat_loss_grad(flat.cuda(), batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    lc, gc = cpu.flat_loss_grad(flat, batch)
    assert counts[kssd.NAME] == counts[kssdb.NAME] == cfg.n_layers
    assert abs(lg.item() - lc.item()) <= 1e-4
    torch.testing.assert_close(gg.cpu(), gc, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# The platform slice: the software-ps backend and a managed endpoint
# ---------------------------------------------------------------------------

from repro_torch.kernels import build  # noqa: E402
from util_platform import Platform  # noqa: E402


@pytest.mark.parametrize("arch,libs", [
    ("stablelm-1.6b", ("flash_attention", "flash_attention_bwd")),
    ("mamba2-1.3b", ("ssd_scan", "ssd_scan_bwd")),
    ("jamba-1.5-large-398b", ("flash_attention", "flash_attention_bwd",
                              "ssd_scan", "ssd_scan_bwd"))])
def test_warm_async_builds_the_step_kernels(cuda, arch, libs):
    """``LMPlugin.warm_async`` on the card builds and loads the step's
    kernel libraries (K4 and K4b; K5 and K5b for the ssm family; all
    four for the hybrid) in the background and then sets ``_warming``."""
    from repro_torch.runtime.learner import step_libraries
    plugin = LMPlugin({"arch": arch}, device="cuda")
    assert step_libraries(plugin.cfg) == libs
    plugin.warm_async(2, {})
    assert plugin._warming.wait(300)
    assert all(name in build._libs for name in libs)


def test_platform_trains_and_serves_on_cuda(cuda, tmp_path):
    """A repro-lm manifest planned by the software-ps backend with no
    device (CUDA) runs under the LCM and scheduler through K1-K4b; an
    endpoint deployed on its trained_model.npy goes READY, answers
    through K4 with the trained weights (the CPU engine's tokens on the
    same file) and drains to STOPPED with its engine released."""
    p = Platform("repro_torch", tmp_path)
    assert p.ctx.device.type == "cuda"
    manifest = {"name": "cuda-lm", "learners": 2, "steps": 4,
                "checkpoint_every": 2, "lr": 3e-4, "optimizer": "adam",
                "compression": "int8", "ps_shards": 2, "batch_docs": 2,
                "data": {"n_docs": 64, "seq_len": 32},
                "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}
    ops.reset_launch_counts()
    p.launch("job-1", manifest)
    assert p.drive("job-1", timeout=300) == "COMPLETED"
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    pushes = 2 * 4
    assert ops.launch_counts() == {
        "flash_attention": cfg.n_layers * pushes,
        "flash_attention_bwd": cfg.n_layers * pushes,
        "ps_aggregate": 4 * 2, "quantize_ef": pushes,
        "dequantize": pushes, "ssd_scan": 0, "ssd_scan_bwd": 0}
    ep = p.deploy("ep-1", source_training="job-1", capacity=2, max_new=4,
                  max_seq=32)
    p.drive_endpoint(ep, "READY", timeout=300)
    prompt = np.arange(1, 9, dtype=np.int32)
    req = ep.engine.submit(prompt, max_new=4)
    assert req.wait(120) and req.status == "DONE"
    cpu = InferenceEngine(cfg, capacity=2, max_seq=32, device="cpu")
    cpu.start(np.load(tmp_path / "results" / "job-1" / "trained_model.npy"))
    want = cpu.submit(prompt, max_new=4)
    t = threading.Thread(target=cpu.run, daemon=True)
    t.start()
    assert want.wait(120)
    cpu.drain()
    t.join(20)
    assert req.tokens == want.tokens
    ep.drain()
    assert p.drive_endpoint(ep, "STOPPED") == "STOPPED"
    assert ep.engine.released and ep.engine._cache is None


def test_ps_release_frees_its_device_memory(cuda):
    """``SoftwareParameterServer.release`` gives back the params, moments,
    receive rows, pull buffers and the clients' error-feedback buffers."""
    from repro_torch.core.software_ps import SoftwareParameterServer
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ps = SoftwareParameterServer(torch.zeros(1 << 20), n_shards=2,
                                 n_learners=2, optimizer="adam",
                                 compression="int8", device="cuda")
    clients = [ps.make_client(i) for i in range(2)]
    for i in range(2):
        ps.join(i)
    pushes = [threading.Thread(target=c.push,
                               args=(torch.ones(1 << 20, device="cuda"),))
              for c in clients]
    for t in pushes:
        t.start()
    for t in pushes:
        t.join(60)
        assert not t.is_alive()
    flat = clients[0].pull()
    del flat
    torch.cuda.synchronize()
    # params, m, v, 2 receive rows, a pull buffer, 2 error buffers
    assert torch.cuda.memory_allocated() - before >= 8 * 4 * (1 << 20)
    ps.release()
    assert torch.cuda.memory_allocated() - before < 1 << 20
    assert ps.stats()["agg_rounds"] == 1


def test_service_trains_releases_and_serves_on_cuda(cuda, tmp_path):
    """The port's ``DLaaSCore`` with no device (CUDA): a repro-lm training
    to COMPLETED whose PS is then freed with the core still up, and an
    endpoint on its trained_model.npy answering with the CPU engine's
    tokens on the same file."""
    from repro_torch.platform.cluster import Cluster, Node, Resources
    from repro_torch.service.core import DLaaSCore
    core = DLaaSCore(str(tmp_path), cluster=Cluster([Node(
        "node-0", Resources(cpus=16.0, gpus=4, memory_mb=65536))]))
    try:
        assert core.device.type == "cuda"
        # device tensors that earlier tests left in reference cycles
        # would otherwise be freed by a collection during the training
        # and read as memory this test released
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        mid = core.deploy_model(
            '{"name": "cuda-lm", "learners": 2, "steps": 4, '
            '"checkpoint_every": 2, "lr": 3e-4, "optimizer": "adam", '
            '"compression": "int8", "ps_shards": 2, "batch_docs": 2, '
            '"data": {"n_docs": 64, "seq_len": 32}, "framework": '
            '{"name": "repro-lm", "arch": "stablelm-1.6b"}}')["model_id"]
        tid = core.create_training(mid)["training_id"]
        plan = core.trainings[tid]["plan"]
        assert core.wait_for(tid, timeout=300) == "COMPLETED"
        deadline = time.time() + 10
        while plan.meta["ps"] is not None and time.time() < deadline:
            time.sleep(0.02)
        assert plan.meta["ps"] is None
        assert abs(torch.cuda.memory_allocated() - before) < 1 << 20
        assert core.training_status(tid)["data_plane"]["push_count"] == 8
        eid = core.deploy_endpoint(from_training=tid, capacity=2,
                                   max_seq=32)["endpoint_id"]
        deadline = time.time() + 300
        while core.endpoint_status(eid)["state"] != "READY":
            assert time.time() < deadline
            time.sleep(0.05)
        got = core.predict(eid, list(range(1, 9)), max_new=4)
        cpu = InferenceEngine(reduce_for_smoke(get_arch("stablelm-1.6b")),
                              capacity=2, max_seq=32, device="cpu")
        cpu.start(np.load(tmp_path / "results" / tid / "trained_model.npy"))
        want = cpu.submit(np.arange(1, 9, dtype=np.int32), max_new=4)
        t = threading.Thread(target=cpu.run, daemon=True)
        t.start()
        assert want.wait(120)
        cpu.drain()
        t.join(20)
        assert got["tokens"] == want.tokens
        core.stop_endpoint(eid)
        deadline = time.time() + 120
        while core.endpoint_status(eid)["state"] != "STOPPED":
            assert time.time() < deadline
            time.sleep(0.05)
        assert core.endpoints[eid].engine.released
    finally:
        core.close()


def test_estimates_touch_no_device_memory(cuda):
    """``status.perf``'s counts of a CUDA plugin's learner step and a CUDA
    engine's decode step run on the meta device: no allocation on the
    card, no launch, and the CPU plugin's count."""
    from repro_torch.runtime.learner import LMPlugin
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    eng = InferenceEngine(cfg, capacity=2, max_seq=64, device="cuda")
    eng.start()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    before = ops.launch_counts()
    train = LMPlugin({}, device="cuda").program_cost(2, {})
    decode = eng._decode_cost(eng.params)()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == mem
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    assert ops.launch_counts() == before
    assert train == LMPlugin({}, device="cpu").program_cost(2, {})
    assert decode["flops_per_device"] > 0
    eng.release()


# ---------------------------------------------------------------------------
# The moe family: the block and the engine on the card
# ---------------------------------------------------------------------------

from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,kind", [(2, "random"), (2, "drop"),
                                        (8, "random"), (8, "drop")])
def test_moe_block_on_cuda_matches_ref_and_cpu(cuda, dtype, top_k, kind):
    """``moe_block`` on the card (sort, scatter into the sentinel row,
    gather combine; no host sync) against ``moe_ref`` on the card and
    the block on the CPU: the same dropped pairs, 1e-5 in f32 and a
    relative L2 of 2e-2 in bf16; two calls on the card equal bit for
    bit (the combine sums each token's k contributions in order)."""
    cfg = dataclasses.replace(
        reduce_for_smoke(get_arch("kimi-k2-1t-a32b")), d_model=256,
        moe=MoEConfig(n_experts=16, top_k=top_k, d_ff_expert=512))
    gen = torch.Generator().manual_seed(top_k)
    params = init_params(tmoe.moe_param_defs(cfg), gen, dtype)
    x = torch.randn(2, 96, cfg.d_model, generator=gen)
    if kind == "drop":
        x = x[:1, :1] + 1e-3 * x
    x = x.to(dtype)
    gp = {k: v.cuda() for k, v in params.items()}
    with torch.no_grad():
        got = tmoe.moe_block(x.cuda(), gp, cfg)
        again = tmoe.moe_block(x.cuda(), gp, cfg)
        want, dropped = tmoe.moe_ref(x.cuda(), gp, cfg)
        cpu = tmoe.moe_block(x, params, cfg)
        _, cpu_dropped = tmoe.moe_ref(x, params, cfg)
    assert torch.equal(got, again)
    assert dropped == cpu_dropped and (dropped > 0 or kind == "random")
    for other in (want.cpu(), cpu):
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), other, atol=1e-5,
                                       rtol=1e-5)
        else:
            g, o = got.cpu().float(), other.float()
            assert ((g - o).norm() / o.norm()).item() < 2e-2


def test_grok_engine_on_cuda_matches_cpu(cuda):
    """One flat vector served by the grok-1 smoke model (moe family, f32)
    on the card and on the CPU: the same greedy tokens, K4 launched once
    per layer per prefill batch."""
    cfg = reduce_for_smoke(get_arch("grok-1-314b"))
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 40, 2, 33, 7)]
    max_news = [3, 6, 4, 5, 7]
    flat = rng.standard_normal(
        InferenceEngine(cfg, device="cpu").flat_size).astype(np.float32)
    flat *= 0.1

    def serve(device):
        eng = InferenceEngine(cfg, capacity=2, max_seq=64, device=device)
        eng.start(flat)
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
        ops.reset_launch_counts()
        t = threading.Thread(target=eng.run, daemon=True)
        t.start()
        for r in reqs:
            assert r.wait(120) and r.status == "DONE"
        launches = ops.launch_counts()[kfa.NAME]
        eng.drain()
        t.join(20)
        assert not t.is_alive()
        return [r.tokens for r in reqs], launches, eng.prefill_batches

    gpu_tokens, launches, batches = serve("cuda")
    cpu_tokens, cpu_launches, _ = serve("cpu")
    assert gpu_tokens == cpu_tokens
    assert launches == cfg.n_layers * batches and cpu_launches == 0


# ---------------------------------------------------------------------------
# The hybrid slice: jamba's kernel shapes, engine and learner step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(1, 300), (2, 33)])
def test_hybrid_flash_kernel_at_jamba_width(cuda, B, S):
    """K4's bf16 hd-128 tensor-core instance at jamba's 64 heads over 8
    KV heads (GQA 8), causal, ragged."""
    _check(*_qkv(B, S, S, 64, 8, 128, torch.bfloat16, seed=7), True)


@pytest.mark.parametrize("B,S", [(1, 300), (2, 512)])
def test_hybrid_ssd_scan_at_jamba_width(cuda, B, S):
    """K5's bf16 tensor-core instance at jamba's 256 heads (P 64, N 128,
    G 1, chunk 256) against the plain scan, ragged and whole chunks."""
    args = _ssd_inputs(B, S, 256, 64, 1, 128, torch.bfloat16, seed=8,
                       a_log=-0.5)
    before_tc = kssd.launches_tc
    y, state = ops.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert kssd.launches_tc == before_tc + 1
    y_ref, state_ref = ref.ssd_scan_ref(*args, chunk=256)
    assert _rel_l2(y, y_ref) < 1e-2 and _rel_l2(state, state_ref) < 1e-2


def test_jamba_engine_on_cuda_matches_cpu(cuda):
    """One flat vector served by the jamba smoke model (hybrid, f32) on
    the card and on the CPU: the same greedy tokens; per prefill batch K4
    launched once per period and K5 once per mamba layer."""
    cfg = reduce_for_smoke(get_arch("jamba-1.5-large-398b"))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 40, 2, 33, 7)]
    max_news = [3, 6, 4, 5, 7]
    flat = rng.standard_normal(
        InferenceEngine(cfg, device="cpu").flat_size).astype(np.float32)
    flat *= 0.1

    def serve(device):
        eng = InferenceEngine(cfg, capacity=2, max_seq=64, device=device)
        eng.start(flat)
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_news)]
        ops.reset_launch_counts()
        t = threading.Thread(target=eng.run, daemon=True)
        t.start()
        for r in reqs:
            assert r.wait(120) and r.status == "DONE"
        counts = ops.launch_counts()
        eng.drain()
        t.join(20)
        assert not t.is_alive()
        return ([r.tokens for r in reqs], counts[kfa.NAME],
                counts[kssd.NAME], eng.prefill_batches)

    gpu_tokens, k4, k5, batches = serve("cuda")
    cpu_tokens, cpu_k4, cpu_k5, _ = serve("cpu")
    assert gpu_tokens == cpu_tokens
    periods = cfg.n_layers // cfg.attn_period
    assert k4 == periods * batches
    assert k5 == periods * (cfg.attn_period - 1) * batches
    assert cpu_k4 == cpu_k5 == 0


@pytest.mark.parametrize("seq", [64, 50])
def test_hybrid_training_step_on_cuda_matches_cpu(cuda, seq):
    """``LMPlugin.flat_loss_grad`` of the jamba smoke model on the card
    (K4, K4b, K5, K5b) against the CPU (plain versions), f32: loss 1e-4,
    flat gradient 2e-3; two chunks of 32, and a ragged tail."""
    cfg = reduce_for_smoke(get_arch("jamba-1.5-large-398b"))
    gpu = LMPlugin({}, cfg=cfg, device="cuda")
    cpu = LMPlugin({}, cfg=cfg, device="cpu")
    flat = cpu.flat_state(0)
    toks = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launch_counts()
    lg, gg = gpu.flat_loss_grad(flat.cuda(), batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    lc, gc = cpu.flat_loss_grad(flat, batch)
    periods = cfg.n_layers // cfg.attn_period
    assert counts[kfa.NAME] == counts[kfab.NAME] == periods
    assert counts[kssd.NAME] == counts[kssdb.NAME] == \
        periods * (cfg.attn_period - 1)
    assert abs(lg.item() - lc.item()) <= 1e-4
    torch.testing.assert_close(gg.cpu(), gc, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# The stub-frontend families: whisper-large-v3 (encdec) and qwen2-vl-2b
# (vlm embeds) through the model-level steps
# ---------------------------------------------------------------------------

from repro_torch.distributed import steps  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.layers import iter_leaves, map_leaves  # noqa: E402


# K4 and K4b on the tensor cores at the full-width attention shapes of
# whisper-large-v3 (hd 64, MHA: encoder self over 1,500 frames, decoder
# self over 448 tokens, cross 448 against 1,500; the serve's prefill of a
# 4-token prompt: decoder self 4 causal, cross 4 against 1,500) and
# qwen2-vl-2b (hd 128, GQA 6, S 2,048)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (4, 1500, 1500, 20, 20, 64, False),
    (4, 448, 448, 20, 20, 64, True),
    (4, 448, 1500, 20, 20, 64, False),
    (4, 4, 4, 20, 20, 64, True),
    (4, 4, 1500, 20, 20, 64, False),
    (2, 2048, 2048, 12, 2, 128, True),
], ids=["whisper-enc", "whisper-dec", "whisper-cross", "whisper-dec-prompt",
        "whisper-cross-prompt", "qwen2-vl"])
def test_flash_kernels_at_whisper_and_qwen2_vl_shapes(cuda, B, Sq, Sk, H,
                                                      KV, hd, causal):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=20)
    do = _qkv(B, Sq, Sq, H, H, hd, torch.bfloat16, seed=21)[0]
    tc, tcb = kfa.launches_tc, kfab.launches_tc
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (kfa.launches_tc - tc, kfab.launches_tc - tcb) == (1, 1)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                             return_lse=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= BWD_BF16_REL_L2, rel


def _family_batch(cfg, device, seed, B=2, S=40):
    """A training batch of ``cfg``'s smoke model: encdec frames (B, 48,
    D) and tokens; vlm embeds with image-then-text M-RoPE positions."""
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        size=(B, S + 1))).to(device)
    b = {"labels": toks[:, 1:]}
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, 48, cfg.d_model)).astype(np.float32)).to(device)
        b["tokens"] = toks[:, :-1]
    else:
        b["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(device)
        n = 16
        img = torch.stack([torch.zeros(n), torch.arange(n) // 4,
                           torch.arange(n) % 4])
        text = (torch.arange(S - n) + 4).expand(3, -1)
        b["positions"] = torch.cat([img, text], 1).long()[:, None].expand(
            3, B, S).to(device)
    return b


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_family_training_step_on_cuda_matches_cpu(cuda, arch):
    """``steps.value_and_grad`` of the smoke model (f32, hd 16: K4 and
    K4b on the CUDA cores) on the card against the CPU: loss 1e-4,
    every gradient leaf 2e-3 (whisper: atol scaled, below); whisper
    launches K4 and K4b three times a layer (encoder self, decoder
    self, cross), qwen2-vl once."""
    cfg = reduce_for_smoke(get_arch(arch))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    gparams = map_leaves(lambda _p, t: t.cuda(), params)
    ops.reset_launch_counts()
    lg, gg = steps.value_and_grad(model, gparams,
                                  _family_batch(cfg, "cuda", 1))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    lc, gc = steps.value_and_grad(model, params, _family_batch(cfg, "cpu", 1))
    encdec = cfg.family == "encdec"
    assert counts[kfa.NAME] == counts[kfab.NAME] == \
        (3 if encdec else 1) * cfg.n_layers
    assert abs(lg.item() - lc.item()) <= 1e-4
    for (path, a), (_, b) in zip(iter_leaves(gg), iter_leaves(gc)):
        # whisper's smoke gradients are ill-conditioned in f32 (on the
        # CPU alone up to 1.1e-2 x (1 + |g|) from float64; stablelm's
        # 2.1e-4): atol 2e-3 of the leaf's largest magnitude there
        scale = max(1.0, b.abs().max().item()) if encdec else 1.0
        torch.testing.assert_close(a.cpu(), b, atol=2e-3 * scale,
                                   rtol=2e-3, msg=path)


def test_encdec_prefill_and_decode_on_cuda_match_cpu(cuda):
    """Whisper's smoke model: prefill (K4 three times a layer) into a
    padded cache and three greedy decode steps (plain attention) on the
    card against the CPU, f32: logits 1e-4 of their largest magnitude,
    equal tokens."""
    cfg = reduce_for_smoke(get_arch("whisper-large-v3"))
    model = make_model(cfg, opts=NO_REMAT)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        p = map_leaves(lambda _p, t: t.to(dev), params)
        b = _family_batch(cfg, dev, 2, S=12)
        b.pop("labels")
        ops.reset_launch_counts()
        logits, cache = steps.build_prefill_step(model)(
            p, b, cache=model.empty_cache(2, 16, dev, S_enc=48),
            slots=torch.arange(2, device=dev))
        seq = [logits]
        for _ in range(3):
            tok = seq[-1].argmax(-1)
            logits, cache = steps.build_decode_step(model)(
                p, cache, {"tokens": tok})
            seq.append(logits)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()[kfa.NAME] == 3 * cfg.n_layers
        out[dev] = [s.cpu() for s in seq]
    for a, b in zip(out["cuda"], out["cpu"]):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


# ---------------------------------------------------------------------------
# the pjit distribution (PjitBackend, Trainer, the sharded step)
# ---------------------------------------------------------------------------

# SGD: AdamW's normalised update would turn the card's and the CPU's
# rounding in near-zero gradients into steps of up to 2 lr
PJIT_SMOKE = {"name": "cuda-pjit", "learners": 1, "steps": 4,
              "checkpoint_every": 2, "lr": 1e-2, "optimizer": "sgd",
              "seed": 0, "batch_docs": 2, "distribution": "pjit",
              "data": {"n_docs": 64, "seq_len": 32},
              "framework": {"name": "repro-lm", "arch": "stablelm-1.6b"}}


def test_pjit_trains_on_cuda_like_the_cpu(cuda, tmp_path, monkeypatch):
    """The smoke manifest through ``PjitBackend`` with no device (CUDA):
    K4 and K4b once a layer a step, per-step losses within 1e-4 of the
    same manifest on the CPU, the uploaded models within 2e-3. A CUDA
    ``torch.Generator`` draws other numbers than a CPU one of the same
    seed, so both runs take the CPU generator's weights."""
    from repro_torch.models import model as model_mod
    draw = model_mod.Model.init
    monkeypatch.setattr(model_mod.Model, "init", lambda self, gen: map_leaves(
        lambda _p, t: t.to(gen.device),
        draw(self, torch.Generator().manual_seed(gen.initial_seed()))))
    out = {}
    for dev in ("cuda", "cpu"):
        p = Platform("repro_torch", tmp_path / dev,
                     **({"device": "cpu"} if dev == "cpu" else {}))
        ops.reset_launch_counts()
        p.launch("job-1", PJIT_SMOKE)
        assert p.drive("job-1", timeout=300) == "COMPLETED"
        counts = ops.launch_counts()
        out[dev] = (p.metrics.series("job-1", "loss").values, np.load(
            tmp_path / dev / "results" / "job-1" / "trained_model.npy"),
            counts)
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    n = cfg.n_layers * PJIT_SMOKE["steps"]
    assert out["cuda"][2][kfa.NAME] == out["cuda"][2][kfab.NAME] == n
    assert out["cpu"][2][kfa.NAME] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=2e-3,
                               rtol=2e-3)


def test_sharded_step_on_a_one_rank_nccl_mesh(cuda, tmp_path):
    """A 1-rank NCCL group and ``make_mesh(1, 1)`` on the card: the
    ``fsdp_tp`` step of a ``Trainer`` on the mesh equals the mesh-less
    trainer's, loss and every leaf, over 2 steps (AdamW and Adafactor);
    the params are DTensors and K4/K4b launch on the mesh step."""
    import torch.distributed as tdist
    from repro_torch.distributed.sharding import Dist, gather
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = reduce_for_smoke(get_arch("stablelm-1.6b"))
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(str(tmp_path / "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        assert mesh.device_type == "cuda"
        for name in ("adamw", "adafactor"):
            opt = OptConfig(name=name, lr=1e-3, min_dim_factored=32)
            runs = []
            for d in (Dist(), Dist(mesh=mesh)):
                tc = TrainerConfig(batch=2, seq=32,
                                   ckpt_dir=str(tmp_path / name))
                tr = Trainer(cfg, d, opt, tc).init(0)
                ops.reset_launch_counts()
                losses = [tr.step_once(tr._batch(s)) for s in range(2)]
                assert ops.launch_counts()[kfab.NAME] == 2 * cfg.n_layers
                runs.append((losses, {k: gather(v) for k, v in
                                      iter_leaves(tr.params)}))
            assert runs[0][0] == runs[1][0], name
            for k, v in runs[0][1].items():
                assert torch.equal(v, runs[1][1][k]), (name, k)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The paper's PS solvers (core/ps.py, core/solvers.py) and zero3_sp's
# sequence-parallel attention
# ---------------------------------------------------------------------------

SOLVER_F = 4 * 256 * 97               # a (4, F) stack, F % (256 * 4) == 0


@pytest.mark.parametrize("opt", [dict(name="sgd", lr=0.1),
                                 dict(name="momentum", lr=0.1),
                                 dict(name="adamw", lr=0.01)],
                         ids=lambda o: o["name"])
def test_solver_server_updates_vs_plain(cuda, opt):
    """``ps.push_update_pull`` and ``ps.downpour_round`` on a (4, F)
    stack: K1 on the card, its plain version on the CPU, the same
    numbers (K1's tolerances); one K1 launch a push, one an arrival."""
    from repro_torch.core import ps
    from repro_torch.optim.optimizers import OptConfig, flat_init
    rng = np.random.RandomState(30)
    stack = rng.standard_normal((4, SOLVER_F)).astype(np.float32)
    center = rng.standard_normal(SOLVER_F).astype(np.float32)
    ctx = ps.PSContext(mesh=None, n_learners=4)
    upd = ps.ServerUpdate(OptConfig(**opt))
    assert upd.uses_k1
    out = {}
    for dev in ("cuda", "cpu"):
        st = flat_init(OptConfig(**opt), SOLVER_F, dev)
        c = torch.from_numpy(center.copy()).to(dev)
        g = torch.from_numpy(stack).to(dev)
        before = kagg.launches
        ps.push_update_pull(g, c, st, upd, "ps", ctx)
        _, st, pre, _ = ps.downpour_round(g, c, st, upd, ctx)
        if dev == "cuda":
            assert kagg.launches == before + 1 + 4
        out[dev] = (c.cpu(), pre.cpu(), {k: v.cpu() for k, v in st.items()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-5,
                               rtol=1e-5)
    for k in out["cpu"][2]:
        torch.testing.assert_close(out["cuda"][2][k], out["cpu"][2][k],
                                   atol=1e-6, rtol=1e-6)


def test_solver_int8_push_and_means_vs_plain(cuda):
    """The int8 push of a (4, F) stack (K2 then K3 per row, the error
    feedback in place) and K1's ``average`` and ``easgd_center`` on it,
    against their plain versions on the CPU."""
    from repro_torch.core import ps
    from repro_torch.core.solvers import SolverConfig, make_solver
    from repro_torch.optim.optimizers import OptConfig
    rng = np.random.RandomState(31)
    stack = rng.standard_normal((4, SOLVER_F)).astype(np.float32)
    center = rng.standard_normal(SOLVER_F).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        s = make_solver(lambda p, b: p["w"].sum(), {"w": torch.zeros(
            SOLVER_F)}, OptConfig(name="sgd"), SolverConfig(compress=True),
            4, device=dev)
        state = {"err": torch.full((4, SOLVER_F), 0.01, device=dev)}
        before = (kq.QUANTIZE.launches, kq.DEQUANTIZE.launches)
        wire = s._maybe_compress(torch.from_numpy(stack).to(dev), state)
        if dev == "cuda":
            assert (kq.QUANTIZE.launches - before[0],
                    kq.DEQUANTIZE.launches - before[1]) == (4, 4)
        avg = ps.push_mean(wire, "ps", ps.PSContext(None, 4))
        c = torch.from_numpy(center.copy()).to(dev)
        ps._aggregate(wire, c, "easgd_center", 0.9)
        out[dev] = [t.cpu() for t in (wire, state["err"], avg, c)]
    for name, a, b in zip(("wire", "err", "average", "easgd_center"),
                          out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)


@pytest.mark.parametrize("q_offset", [512, 1024, 1536])
def test_flash_kernels_at_zero3_sp_rank_shapes(cuda, q_offset):
    """K4 with its LSE and K4b at a rank's slice of qwen2-vl-2b's 2 x
    2,048 batch on a 4-way "model" axis: 512 queries against the 2,048
    gathered keys at ``q_offset``, GQA 6, hd 128, causal, on the tensor
    cores, against their plain versions."""
    B, Sq, Sk, H, KV, hd = 2, 512, 2048, 12, 2, 128
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=32)
    do = _qkv(B, Sq, Sq, H, H, hd, torch.bfloat16, seed=33)[0]
    kw = dict(causal=True, q_offset=q_offset)
    tc, tcb = kfa.launches_tc, kfab.launches_tc
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (kfa.launches_tc - tc, kfab.launches_tc - tcb) == (1, 1)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= BWD_BF16_REL_L2, rel


def test_zero3_sp_step_on_a_one_rank_nccl_mesh(cuda, tmp_path):
    """The zero3_sp train step of the qwen2-vl smoke model (embeds and
    M-RoPE positions) on a 1-rank NCCL mesh: sequence-parallel, and its
    loss and every updated leaf equal the mesh-less step's."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import (Dist, P, Sharding,
                                                  distribute, gather)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_model
    from repro_torch.models.layers import iter_leaves, leaf_at, map_leaves
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    cfg = reduce_for_smoke(get_arch("qwen2-vl-2b"))
    b = _family_batch(cfg, "cuda", 34)
    B, S = b["labels"].shape
    opt = OptConfig(name="sgd", lr=0.1)
    params = make_model(cfg).init(torch.Generator(device="cuda")
                                  .manual_seed(0))
    mine = map_leaves(lambda _p, t: t.clone(), params)
    params, _, la = steps.build_train_step(
        make_model(cfg, opts=NO_REMAT), opt)(
        params, init_opt_state(opt, params), b)
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        d = Dist(mesh=make_mesh(1, 1), policy="zero3_sp").resolve_batch(B)
        model = make_model(cfg, d, NO_REMAT)
        psh = model.param_shardings()
        mp = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)), mine)
        shape = ShapeSpec("t", S, B, "train")
        assert steps.local_loss_and_grads(model, shape).seq_parallel(b)
        state = {"step": distribute(torch.zeros((), dtype=torch.int32,
                                                device="cuda"),
                                    Sharding(d.mesh, P()))}
        mp, _, lb = steps.jit_train_step(model, opt, shape)(mp, state, b)
        assert abs(lb.item() - la.item()) <= 1e-6
        for (k, x), (_, y) in zip(iter_leaves(params), iter_leaves(mp)):
            torch.testing.assert_close(gather(y), x, atol=1e-6, rtol=1e-6,
                                       msg=k)
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_expert_parallel_steps_on_a_one_rank_nccl_mesh(cuda, tmp_path,
                                                       arch):
    """The moe and hybrid smoke models' expert-parallel steps on a 1-rank
    NCCL mesh (``fsdp_tp``): an SGD train step (the all-to-all body and
    its backward), then prefill (all-to-all) and a decode step (local
    experts, all-reduce) equal the mesh-less steps on the card."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import steps
    from repro_torch.distributed.sharding import (Dist, P, Sharding,
                                                  distribute, gather)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_model
    from repro_torch.models.layers import iter_leaves, leaf_at, map_leaves
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    cfg = reduce_for_smoke(get_arch(arch))
    B, S = 2, 32
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device="cuda")
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = OptConfig(name="sgd", lr=0.1)
    params = make_model(cfg).init(torch.Generator(device="cuda")
                                  .manual_seed(0))
    mine = map_leaves(lambda _p, t: t.clone(), params)
    flat = make_model(cfg, opts=NO_REMAT)
    logits_a, cache_a = steps.build_prefill_step(flat)(
        mine, {"tokens": b["tokens"][:, :16]}, cache=flat.empty_cache(
            B, 17, "cuda"), slots=torch.arange(B, device="cuda"))
    step_a, cache_a = steps.build_decode_step(flat)(
        mine, cache_a, {"tokens": b["tokens"][:, 16:17]})
    params, _, la = steps.build_train_step(flat, opt)(
        params, init_opt_state(opt, params), b)
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        d = Dist(mesh=make_mesh(1, 1)).resolve_batch(B)
        model = make_model(cfg, d, NO_REMAT)
        psh = model.param_shardings()
        mp = map_leaves(lambda p, x: distribute(x, leaf_at(psh, p)), mine)
        pshape = ShapeSpec("p", 16, B, "prefill")
        csh = model.cache_shardings(B)
        cache = {k: distribute(v, csh[k]) for k, v in
                 model.empty_cache(B, 17, "cuda").items()}
        logits_b, cache = steps.jit_prefill_step(model, pshape)(
            mp, {"tokens": b["tokens"][:, :16]}, cache=cache)
        step_b, cache = steps.jit_decode_step(model, pshape)(
            mp, cache, {"tokens": b["tokens"][:, 16:17]})
        assert torch.equal(logits_b.full_tensor(), logits_a)
        assert torch.equal(step_b.full_tensor(), step_a)
        for k, v in cache.items():
            assert torch.equal(v.full_tensor(), cache_a[k]), k
        shape = ShapeSpec("t", S, B, "train")
        state = {"step": distribute(torch.zeros((), dtype=torch.int32,
                                                device="cuda"),
                                    Sharding(d.mesh, P()))}
        mp, _, lb = steps.jit_train_step(model, opt, shape)(mp, state, b)
        assert abs(lb.item() - la.item()) <= 1e-6
        for (k, x), (_, y) in zip(iter_leaves(params), iter_leaves(mp)):
            torch.testing.assert_close(gather(y), x, atol=1e-6, rtol=1e-6,
                                       msg=k)
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The launch-shape tuner: every candidate gives the default's bits
# ---------------------------------------------------------------------------

from repro_torch.kernels import autotune  # noqa: E402


def _same_bits(probe, blocks, default):
    want = probe.run(default)
    for c in blocks:
        assert probe.matches(c, want), c


@pytest.mark.parametrize("nl,f", [(2, 2304), (4, 1 << 20), (3, 1000),
                                  (2, 256 * 4920)])
def test_ps_aggregate_every_block_gives_the_default_bits(cuda, nl, f):
    """K1 at its candidates and at blocks that divide nothing (1, 300,
    2,000: masked tails), against the default, from one scratch state;
    probes move no launch count."""
    plan = autotune.ps_plan(nl, f)
    probe = plan.probe(cuda, limit=None)
    before, probes = kagg.launches, autotune.probe_launches
    blocks = list(plan.candidates) + [1, 300, 2000]
    _same_bits(probe, blocks, plan.default)
    assert kagg.launches == before
    assert autotune.probe_launches == probes + len(blocks) + 1


@pytest.mark.parametrize("f", [768, 256 * 21, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_quantize_every_block_gives_the_default_bits(cuda, f, dtype):
    """K2 (x f32 or bf16) and K3 (int8) at every multiple of 256 up to
    8,192, divisor of F or not, against the default."""
    plan = autotune.quantize_plan(f, 256, dtype)
    probe = plan.probe(cuda, limit=None)
    rec = kq.DEQUANTIZE if dtype == torch.int8 else kq.QUANTIZE
    before = rec.launches
    _same_bits(probe, range(256, 8192 + 1, 256), plan.default)
    assert rec.launches == before


@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("shape", [
    (2, 300, 300, 8, 2, True, 0), (1, 33, 33, 4, 4, True, 0),
    (2, 512, 2048, 12, 2, True, 1536), (2, 200, 1500, 4, 1, False, 0),
    (1, 130, 130, 2, 2, False, 0)])
@pytest.mark.parametrize("lse", [False, True])
def test_flash_block_q_64_gives_the_bits_of_128(cuda, hd, shape, lse):
    """K4's tensor-core instance at block_q 64 (one warpgroup) and 128
    (two), ragged Sq included: o and lse bit for bit."""
    B, Sq, Sk, H, KV, causal, q_offset = shape
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, seed=hd)
    before = (kfa.launches, kfa.launches_tc)
    outs = {}
    for bq, _ in kfa.TC_SHAPES:
        o = kfa.flash_attention_cuda(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=lse,
                                     block_q=bq, probe=True)
        outs[bq] = o if lse else (o,)
    torch.cuda.synchronize()
    assert (kfa.launches, kfa.launches_tc) == before
    for a, b in zip(outs[64], outs[128]):
        assert torch.equal(a, b)
    # and the tuner's own probe of the shape agrees
    plan = autotune.flash_plan(B * H, Sq, Sk, hd, torch.bfloat16,
                               heads=(H, KV), causal=causal,
                               q_offset=q_offset, lse=lse)
    _same_bits(plan.probe(cuda), plan.candidates, plan.default)


def test_a_failing_candidate_raises(cuda):
    """A launch shape a kernel does not take raises at the wrapper, and
    through the tuner; so does a candidate whose bits differ."""
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="block_q 96"):
        kfa.flash_attention_cuda(q, k, v, causal=True, block_q=96)
    x = torch.zeros(1024, device="cuda")
    with pytest.raises(ValueError, match="multiple of 256"):
        kq.quantize_ef_cuda(x, x, block=300)
    with pytest.raises(ValueError, match="multiple of 256"):
        kq.dequantize_cuda(x.to(torch.int8), x[:4], block=16384)
    for block in (0, kagg.MAX_BLOCK + 256):
        with pytest.raises(ValueError, match="1 to 2048"):
            kagg.ps_aggregate_cuda(x[None], x, x.clone(), x.clone(), 1,
                                   solver="sgd", lr=0.1, b1=0.9, b2=0.999,
                                   eps=1e-8, momentum=0.9, beta=0.9,
                                   block=block)
    plan = autotune.flash_plan(2, 64, 64, 64, torch.bfloat16, heads=(2, 2))
    bad = dataclasses.replace(plan, candidates=[(128, 64), (96, 64)],
                              predict_us=lambda c: 1.0, extra_key="shape")
    with pytest.raises(ValueError, match="block_q 96"):
        autotune._tuned(bad, cuda)

    def differing(device, limit=None):
        return autotune.Probe(lambda c: (torch.full((4,), float(c[0]),
                                                    device=device),), {})
    bad = dataclasses.replace(plan, probe=differing,
                              predict_us=lambda c: 1.0, extra_key="bits")
    with pytest.raises(RuntimeError, match="other bits"):
        autotune._tuned(bad, cuda)


def test_ops_tunes_a_new_shape_once_without_counting_probes(cuda):
    """The first ops call of a shape measures its candidates (probes, not
    launches); the second is a cache hit with no probe."""
    q, k, v = _qkv(3, 257, 257, 4, 2, 128, torch.bfloat16, seed=5)
    cache = autotune.get_cache()
    before = (kfa.launches, autotune.probe_launches, cache.misses,
              cache.hits)
    first = ops.flash_attention(q, k, v, causal=True)
    assert kfa.launches == before[0] + 1
    assert autotune.probe_launches > before[1]
    assert cache.misses == before[2] + 1
    probes = autotune.probe_launches
    again = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert kfa.launches == before[0] + 2
    assert autotune.probe_launches == probes
    assert cache.hits == before[3] + 1
    key = autotune.make_key("flash_attention", (12, 257, 257, 128),
                            torch.bfloat16, "h4kv2|causal1|off0|lse0")
    rec = json.loads(open(autotune.cache_path()).read())[key]
    assert rec["source"] == "measured"
    assert set(rec["measured_us"]) == {"(128, 64)", "(64, 64)"}
    assert key.split("|")[3] == f"cuda:{torch.cuda.get_device_name()}"
