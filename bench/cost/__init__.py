"""Frozen operation and byte counts of the work the inputs need, and the
chip's published peaks. Copied from the formulas of the port's
``analysis/roofline.py`` (``kernel_cost``, ``model_flops``) at the time
the benchmark was defined, and never imported from the port: a change to
the program must not move its own yardstick.

Counts are of what the inputs need: each input byte read once and each
output byte written once, operations over the pairs causal attention
keeps, and for a model the matrix products of every token.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 data sheet, dense: bf16 tensor cores, HBM3
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Cost:
    flops: float
    bytes: float

    def seconds(self) -> float:
        """The least time on the chip: the larger of the two bounds."""
        return max(self.flops / PEAK_FLOPS_BF16,
                   self.bytes / HBM_BYTES_PER_S)


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs causal attention keeps: query i sees keys
    j <= i."""
    t = min(max(sk - 1, 0), sq)
    return t * (t + 1) // 2 + (sq - t) * sk


def flash_fwd(B, S, H, KV, hd, esize=2, lse=False) -> Cost:
    """K4, causal self-attention over S: q, o, k, v once (and the f32
    LSE); QK^T and PV over the kept pairs."""
    nbytes = (2 * B * S * H + 2 * B * S * KV) * hd * esize
    if lse:
        nbytes += 4 * B * H * S
    return Cost(4 * B * H * hd * causal_pairs(S, S), nbytes)


def flash_bwd(B, S, H, KV, hd, esize=2) -> Cost:
    """K4b: q, o, dO, the LSE, k, v read; dq, dk, dv written; five
    products over the kept pairs."""
    nbytes = (4 * B * S * H + 4 * B * S * KV) * hd * esize + 4 * B * H * S
    return Cost(10 * B * H * hd * causal_pairs(S, S), nbytes)


def ps_aggregate(n_learners: int, n: int, state: int = 6) -> Cost:
    """K1 over n values: the learners' f32 rows read, params, m, v read
    and written (Adam: 6 passes of f32 state)."""
    return Cost(0.0, (n_learners + state) * 4 * n)


def quantize_ef(n: int, x_esize: int) -> Cost:
    """K2 over n values: x and the f32 error read; int8 q, the new error
    and one f32 scale a 256-block written."""
    return Cost(0.0, n * (x_esize + 4 + 1 + 4) + 4 * (n // 256))


def dequantize(n: int) -> Cost:
    """K3 over n values: int8 q and the scales read, f32 written."""
    return Cost(0.0, n * (1 + 4) + 4 * (n // 256))


def expert_bmm(E: int, C: int, K: int, N: int, routed_rows: int,
               esize: int = 2) -> Cost:
    """One of the moe block's three batched products, (E, C, K) x (E, K,
    N): the products of the ``routed_rows`` (token, expert) pairs the
    router sent, each expert's weights and the buffer's rows once."""
    return Cost(2.0 * routed_rows * K * N,
                (E * K * N + E * C * K + E * C * N) * esize)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def block_params_per_token(spec) -> float:
    """Weights of the blocks a token multiplies by (moe: its top-k
    experts and the router)."""
    d, hd = spec.d, spec.hd
    attn = d * spec.heads * hd * 2 + d * spec.kv * hd * 2
    if spec.family == "moe":
        ffn = spec.top_k * 3 * d * spec.ff + d * spec.experts
    else:
        ffn = 3 * d * spec.ff
    return spec.layers * (attn + ffn)


def train_flops_per_token(spec, seq: int) -> float:
    """6 N (blocks and head; the embedding lookup is no product) plus
    causal attention, forward and backward: 3 x 2 S H hd per layer per
    token at the sequence's mean causal context S/2 each way."""
    n = block_params_per_token(spec) + spec.d * spec.vocab
    attn = 6.0 * spec.layers * spec.heads * spec.hd * seq
    return 6.0 * n + attn


def prefill_flops(spec, batch: int, plen: int) -> float:
    """A prefill of ``batch`` prompts of ``plen``: the blocks for every
    token, causal attention over the pairs, the head for the last token."""
    blocks = 2.0 * block_params_per_token(spec) * batch * plen
    attn = 4.0 * spec.layers * spec.heads * spec.hd * batch \
        * causal_pairs(plen, plen)
    return blocks + attn + 2.0 * spec.d * spec.vocab * batch


def decode_flops(spec, tokens: int) -> float:
    """``tokens`` decoded tokens: the blocks and the head each (the
    attention scores over the cache, under 2% of it at these contexts,
    are not counted, so the count errs low)."""
    return 2.0 * (block_params_per_token(spec) + spec.d * spec.vocab) \
        * tokens
