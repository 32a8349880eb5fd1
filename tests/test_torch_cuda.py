"""Tests of the port that need the card: the CUDA flash-attention kernel
against its plain PyTorch version, the wrapper's checks, and the serving
engine on CUDA against the same engine on the CPU.

They carry the ``cuda`` marker and skip where ``torch.cuda.is_available()``
is false (the kernel has no CPU mode). This file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, those of
tests/test_kernels.py:34. TF32 is switched off so that the plain
version's float32 products are full float32.
"""
import threading

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


def _check(q, k, v, causal, q_offset=0):
    before = kfa.launches
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert kfa.launches == before + 1
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
