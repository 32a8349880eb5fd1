"""Shared grid-sizing helper for the port's 1-D CUDA kernels (K1
``ps_aggregate``, K2 ``quantize_ef``, K3 ``dequantize``): the default and
fallback launch shape of ``kernels/autotune.py``.

The PS shard layout guarantees lengths that are multiples of the
quantization block (256); ``fit_block`` gives the largest block <= the
requested one that divides the full length (and, where scales are
per-block, is itself a multiple of that quantization block). On the card
a block is the values one thread block (CTA) handles; the kernels mask
any tail, so a block that does not divide F is never a fault, only a
wasted launch.

For awkward sizes (F divisible only by small powers of two) the halving
search can land on a tiny block, and the grid is then many CTAs of
little work each: the kernel spends its time on dispatch, not bytes.
Each distinct (f, requested, chosen) signature below SMALL_BLOCK_FLOOR
logs one warning and notifies registered observers (``DLaaSCore`` wires
these into its MetricsService as the ``kernels_small_block_total``
counter).

Copied from ``repro/kernels/grid.py`` unchanged apart from the logger's
name (under ``"repro_torch"``, as ``observability/log.py`` names the
port's loggers). The port imports nothing of ``repro``.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, List, Tuple

log = logging.getLogger("repro_torch.kernels.grid")

SMALL_BLOCK_FLOOR = 256

_lock = threading.Lock()
_warned: set = set()
_events: List[Tuple[int, int, int]] = []     # (f, requested, chosen)
_observers: List[Callable[[int, int, int], None]] = []


def on_small_block(cb: Callable[[int, int, int], None]) -> None:
    """Register ``cb(f, requested, chosen)`` to fire on every small-block
    degradation (used to surface a metric without a module-level
    MetricsService dependency)."""
    with _lock:
        _observers.append(cb)


def small_block_events() -> List[Tuple[int, int, int]]:
    with _lock:
        return list(_events)


def _note_small_block(f: int, requested: int, chosen: int) -> None:
    with _lock:
        _events.append((f, requested, chosen))
        observers = list(_observers)
        first = (f, requested, chosen) not in _warned
        _warned.add((f, requested, chosen))
    if first:
        log.warning(
            "fit_block degraded to block=%d (< %d) for f=%d "
            "(requested %d): grid is dispatch-bound; consider padding "
            "the buffer to a friendlier multiple", chosen,
            SMALL_BLOCK_FLOOR, f, requested)
    for cb in observers:
        cb(f, requested, chosen)


def fit_block(f: int, block: int, multiple: int = 1) -> int:
    """Largest usable grid block: <= ``block``, divides ``f``, and is a
    multiple of ``multiple``. ``f`` must itself be a multiple of
    ``multiple`` (asserted) so halving toward it always terminates."""
    assert multiple >= 1 and f % multiple == 0, (f, multiple)
    requested = block
    block = max(multiple, min(block, f))
    while f % block or block % multiple:
        block = max(multiple, block // 2)
    if block < SMALL_BLOCK_FLOOR <= f and block < requested:
        _note_small_block(f, requested, block)
    return block
