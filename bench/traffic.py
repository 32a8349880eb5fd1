"""The one traffic generator: it reads a mix file's parameters and makes
the inputs of a run from ``--seed``.

Every seed gets the same multiset of sizes and of gaps between
arrivals, in another order, so runs of different seeds do the same work:
a length is the lognormal's quantile at (i + 1/2) / n, clipped, and a gap
the exponential's; the seed permutes them and draws the token ids.

Serving mixes (``"kind": "serve"``) give ``rate_per_s``, ``prompt`` and
``output`` (``median``, ``sigma``, ``min``, ``max``); training mixes
(``"kind": "train"``) give ``learners``, ``batch_docs`` and ``seq_len``.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A Philox stream keyed by the seed (any size) and a stream id."""
    key = [int(seed) & 0xFFFFFFFFFFFFFFFF, 0]
    for s in stream:
        key[1] = (key[1] * 1_000_003 + int(s) + 1) & 0xFFFFFFFFFFFFFFFF
    return np.random.Generator(np.random.Philox(key=key))


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


@dataclass
class Request:
    due: float              # seconds after the block's start
    prompt: np.ndarray      # int64 token ids
    max_new: int


def serve_block(mix: dict, vocab: int, seed: int, block: int,
                seconds: float) -> List[Request]:
    """The requests of ``seconds`` of open-loop arrivals at the mix's
    rate: ``round(rate * seconds)`` of them, block ``block`` of the run
    (0 lead-in, 1 the measured window, 2 the tail that keeps the load on
    while the window's requests finish)."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    p, o = mix["prompt"], mix["output"]
    plen = lognormal_quantiles(n, p["median"], p["sigma"], p["min"],
                               p["max"])
    olen = lognormal_quantiles(n, o["median"], o["sigma"], o["min"],
                               o["max"])
    gaps = exponential_gaps(n, mix["rate_per_s"])
    g = rng(seed, block)
    plen, olen, gaps = (x[g.permutation(n)] for x in (plen, olen, gaps))
    # the first request is due at the block's start
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [Request(float(due[i]),
                    g.integers(0, vocab, size=int(plen[i]), dtype=np.int64),
                    int(olen[i])) for i in range(n)]


def train_batch(mix: dict, vocab: int, seed: int, learner: int,
                step: int) -> dict:
    """Learner ``learner``'s rows at ``step``: ``batch_docs`` documents of
    ``seq_len + 1`` uniform token ids, as tokens and next-token labels.
    Every (learner, step) draws its own rows."""
    g = rng(seed, 1_000 + learner, step)
    doc = g.integers(0, vocab, size=(mix["batch_docs"], mix["seq_len"] + 1),
                     dtype=np.int64)
    return {"tokens": doc[:, :-1], "labels": doc[:, 1:]}
