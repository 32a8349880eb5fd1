"""Data pipeline: deterministic synthetic corpus + global-cursor sharding
+ background prefetch.

The corpus is index-addressable (token i of document d is a pure function
of (d, i)), so *any* chunking produced by the global cursor yields the
same data — learners claiming disjoint chunks see disjoint, reproducible
samples no matter the interleaving, and a restarted learner re-reading a
chunk gets identical bytes (required for checkpoint-restart determinism).

Copied from ``repro/data/pipeline.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.cursor import Chunk, GlobalCursor


@dataclass(frozen=True)
class DatasetSpec:
    n_docs: int
    seq_len: int
    vocab_size: int
    seed: int = 0


class SyntheticCorpus:
    """Deterministic 'documents': token[d, i] = h(seed, d, i) mod V, with a
    short-range structure so tiny LMs can actually reduce loss."""

    def __init__(self, spec: DatasetSpec):
        self.spec = spec

    def doc_tokens(self, doc: int) -> np.ndarray:
        s = self.spec
        rng = np.random.Generator(np.random.Philox(key=s.seed + doc))
        base = rng.integers(0, s.vocab_size, size=s.seq_len + 1,
                            dtype=np.int64)
        # inject learnable structure: every odd position repeats its
        # predecessor (a bigram rule a tiny model can pick up)
        base[1::2] = base[0::2][: len(base[1::2])]
        return base.astype(np.int32)

    def batch_for(self, chunks: List[Chunk]) -> Dict[str, np.ndarray]:
        docs = []
        for ch in chunks:
            docs.extend(range(ch.start, ch.end))
        toks = np.stack([self.doc_tokens(d) for d in docs])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class CursorLoader:
    """Cursor-driven loader with background prefetch (double buffering)."""

    def __init__(self, corpus: SyntheticCorpus, cursor: GlobalCursor,
                 batch_docs: int, prefetch: int = 2):
        self.corpus = corpus
        self.cursor = cursor
        self.batch_docs = batch_docs
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            chunks = self.cursor.next_chunk(self.batch_docs)
            batch = self.corpus.batch_for(chunks)
            batch["_epoch"] = np.int32(chunks[0].epoch)
            try:
                self._q.put(batch, timeout=5.0)
            except queue.Full:
                if self._stop.is_set():
                    return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
