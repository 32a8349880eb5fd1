"""The frozen counts against hand counts at small shapes."""
import pytest

from bench import cost
from bench.weights import Spec


def test_causal_pairs():
    assert cost.causal_pairs(4, 4) == 10
    assert cost.causal_pairs(1, 5) == 1
    assert cost.causal_pairs(3, 2) == 1 + 2 + 2


def test_flash_counts():
    # B 1, S 4, H 2, KV 1, hd 8: 10 pairs a head; QK^T and PV 2 * 8 each
    f = cost.flash_fwd(1, 4, 2, 1, 8)
    assert f.flops == 2 * 10 * 4 * 8
    assert f.bytes == (2 * 4 * 2 + 2 * 4 * 1) * 8 * 2
    assert cost.flash_fwd(1, 4, 2, 1, 8, lse=True).bytes == f.bytes + 4 * 2 * 4
    b = cost.flash_bwd(1, 4, 2, 1, 8)
    assert b.flops == 2 * 10 * 10 * 8
    assert b.bytes == (4 * 4 * 2 + 4 * 4 * 1) * 8 * 2 + 4 * 2 * 4


def test_ps_counts():
    assert cost.ps_aggregate(2, 1024).bytes == 8 * 4 * 1024
    assert cost.quantize_ef(512, 2).bytes == 512 * 11 + 8
    assert cost.dequantize(512).bytes == 512 * 5 + 8


def test_expert_bmm_and_bound():
    c = cost.expert_bmm(E=2, C=8, K=4, N=16, routed_rows=10)
    assert c.flops == 2 * 10 * 4 * 16
    assert c.bytes == (2 * 4 * 16 + 2 * 8 * 4 + 2 * 8 * 16) * 2
    assert c.seconds() == pytest.approx(max(c.flops / 989e12,
                                            c.bytes / 3.35e12))


def spec(family="dense"):
    return Spec(family=family, d=8, ff=16, heads=2, kv=1, hd=4, layers=3,
                vocab=32, experts=4 if family == "moe" else 0,
                top_k=2 if family == "moe" else 0)


def test_model_flops():
    s = spec()
    attn = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2
    per_layer = attn + 3 * 8 * 16
    assert cost.block_params_per_token(s) == 3 * per_layer
    n = 3 * per_layer + 8 * 32
    assert cost.train_flops_per_token(s, 10) == 6 * n + 6 * 3 * 2 * 4 * 10
    m = spec("moe")
    assert cost.block_params_per_token(m) == 3 * (attn + 2 * 3 * 8 * 16
                                                  + 8 * 4)
    assert cost.prefill_flops(s, 2, 4) == (2 * 3 * per_layer * 8
                                           + 4 * 3 * 2 * 4 * 2 * 10
                                           + 2 * 8 * 32 * 2)
    assert cost.decode_flops(s, 5) == 2 * (3 * per_layer + 8 * 32) * 5
