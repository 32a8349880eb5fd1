"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

The libraries go to ``build/kernels/`` at the root of the checkout (git
ignores ``build/``). The file name carries a hash of the source, the
headers beside it and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. Sources that need building are compiled
in parallel, one ``nvcc`` each. No PyTorch header is included: a build
takes seconds, where ``torch.utils.cpp_extension.load`` takes minutes.

Nothing here runs at import time; the first ``load(name)`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    name: str
    library: Path
    seconds: float        # 0.0 when an up-to-date library was reused
    log: str              # nvcc's output (ptxas register/smem report)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are built with nvcc at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, BuildResult]:
    """Build every source (or those named) that has no up-to-date library,
    all ``nvcc`` processes started together. Raises on a failed build with
    the compiler's output."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    missing = set(names or ()) - {s.stem for s in srcs}
    if missing:
        raise FileNotFoundError(f"no kernel source for {sorted(missing)} "
                                f"in {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    nvcc = None
    for src in srcs:
        lib = _library_path(src)
        if lib.exists():
            results[src.stem] = BuildResult(src.stem, lib, 0.0, "")
            continue
        nvcc = nvcc or find_nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc, time.perf_counter()))
    failures = []
    for src, lib, tmp, proc, t0 in running:
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)          # atomic: concurrent builds agree
        results[src.stem] = BuildResult(src.stem, lib, secs, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            built = build_all([name])[name]
            lib = ctypes.CDLL(str(built.library))
            _libs[name] = lib
        return lib
