"""Tests of the port that need the card: the CUDA kernels (flash
attention and its backward, the PS update and the int8 wire, the SSD
scan and its backward) against their plain PyTorch versions, the
wrappers' checks, the serving engines and the dense and ssm learner
steps on CUDA against the same on the CPU, and the platform and the
service (``DLaaSCore``) training and serving on CUDA.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is false (the kernel has no CPU mode). This file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, those of
tests/test_kernels.py:34, for attention; each other kernel's beside its
tests. TF32 is switched off so that the plain version's float32
products are full float32.
"""
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

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
    """bf16 at head dim 64 or 128: the tensor-core instances of K4/K4b."""
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
    ("mamba2-1.3b", ("ssd_scan", "ssd_scan_bwd"))])
def test_warm_async_builds_the_step_kernels(cuda, arch, libs):
    """``LMPlugin.warm_async`` on the card builds and loads the step's
    kernel libraries (K4 and K4b; K5 and K5b for the ssm family) in the
    background and then sets ``_warming``."""
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
