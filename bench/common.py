"""Shared pieces of the benchmark: where things are, how the files of a
cell are found by name, the statistics every reader uses, and the guard
against the JAX package.

Nothing here imports the program under test (``repro_torch``), JAX or
the JAX package ``repro``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that may not be loaded in a benchmark process,
# compared whole: the port's own name begins with "repro"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

# build and kernel caches of the program, at fixed paths inside the
# checkout (git ignores build/), so only a checkout's first run builds,
# compiles or tunes
CACHE_DIR = ROOT / "build" / "bench"


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what
    this process has loaded)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def cache_env() -> Dict[str, str]:
    """The environment the program runs under: its caches inside the
    checkout, and no JAX pulled in by a library."""
    return {
        "DLAAS_AUTOTUNE_CACHE": str(CACHE_DIR / "autotune-cache.json"),
        "TRITON_CACHE_DIR": str(CACHE_DIR / "triton"),
        "CUDA_CACHE_PATH": str(CACHE_DIR / "nv"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(workload entry, its configuration file's contents, its mix file's
    contents), found by name."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    return w, load_json(ROOT / c["file"]), load_json(
        BENCH / "mixes" / f"{w['traffic']}.json")


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (names of metric
    files carry dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank ``p``-th percentile of all ``values`` (``inf`` stands
    for a request that never came back)."""
    if not values:
        raise ValueError("percentile of nothing")
    v = sorted(values)
    k = max(0, int(math.ceil(p / 100.0 * len(v))) - 1)
    return v[k]


def union_seconds(intervals: Iterable[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, longest first."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])
