"""Global cursor work allocation (paper §Global Cursor and Work Allocation).

Learners self-assign mutually exclusive data chunks by atomically
incrementing a shared counter: chunk = [prior, prior + size). The counter
lives in the (simulated) ZooKeeper; exclusivity is by construction of
fetch-and-add — the counter only ever moves forward, so no two claims can
overlap regardless of interleaving (hypothesis-tested in
tests/test_cursor.py).

The cursor value encodes the epoch implicitly: ``epoch = value // N``,
``offset = value % N``. A claim that straddles the dataset boundary is
returned as (at most two) per-epoch segments; it is never "given back"
(a decrement would race with a concurrent claim and create overlap).

Copied from ``repro/core/cursor.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Chunk:
    epoch: int
    start: int          # offset within the epoch
    end: int            # exclusive

    @property
    def size(self) -> int:
        return self.end - self.start


class GlobalCursor:
    def __init__(self, kv, path: str, dataset_size: int):
        assert dataset_size > 0
        self.kv = kv
        self.path = path
        self.dataset_size = dataset_size

    def next_chunk(self, size: int) -> List[Chunk]:
        """Atomically claim ``size`` items; returns 1–2 per-epoch segments.

        Mutually exclusive with every other claim by construction
        (fetch-and-add; the cursor never moves backwards)."""
        assert 0 < size <= self.dataset_size
        ds = self.dataset_size
        prior = self.kv.increment(self.path, size)
        out: List[Chunk] = []
        pos = prior
        remaining = size
        while remaining > 0:
            epoch, start = divmod(pos, ds)
            take = min(remaining, ds - start)
            out.append(Chunk(epoch=epoch, start=start, end=start + take))
            pos += take
            remaining -= take
        return out

    def position(self) -> Tuple[int, int]:
        """(epoch, offset) of the cursor right now."""
        v = self.kv.increment(self.path, 0)
        return divmod(v, self.dataset_size)

    def restore(self, epoch: int, offset: int):
        """Reset after checkpoint-restart (paper: jobs resume mid-pass).
        Only ever moves the cursor FORWARD (monotonicity invariant)."""
        cur = self.kv.increment(self.path, 0)
        target = epoch * self.dataset_size + offset
        if target > cur:
            self.kv.increment(self.path, target - cur)
