"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

The libraries go to ``build/kernels/`` at the root of the checkout (git
ignores ``build/``). The file name carries a hash of the source, the
headers beside it and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. nvcc's output (the ``ptxas`` report of
registers, shared memory and spills per kernel) is kept beside each
library as ``<name>-<hash>.log``, so a reused library still has its
report (``ptxas_report``). ``sass_counts`` counts instructions by opcode
in a library's machine code (``cuobjdump -sass``), e.g. the tensor-core
``HGMMA``. Sources that need building are compiled in parallel, one
``nvcc`` each. No PyTorch header is included: a build takes seconds,
where ``torch.utils.cpp_extension.load`` takes minutes.

Nothing here runs at import time; the first ``load(name)`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    log: str              # nvcc's output (ptxas register/smem report),
                          # kept beside the library and read back on reuse


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
            log = lib.with_suffix(".log")
            results[src.stem] = BuildResult(
                src.stem, lib, 0.0, log.read_text() if log.exists() else "")
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
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)          # atomic: concurrent builds agree
        results[src.stem] = BuildResult(src.stem, lib, secs, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return results


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per compiled kernel (mangled name) of an nvcc ``-Xptxas -v`` log:
    registers, static shared-memory bytes, spill store and load bytes."""
    report: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {"registers": 0, "smem": 0,
                                   "spill_stores": 0, "spill_loads": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            report[fn]["smem"] = int(s.group(1)) if s else 0
    return report


def sass_counts(library: Path, opcodes=("HGMMA", "HMMA")
                ) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a built library: how many SASS
    instructions start with each opcode, from ``cuobjdump -sass``."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {op: 0 for op in opcodes}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if fn is not None and m:
            for op in opcodes:
                if m.group(1) == op or m.group(1).startswith(op + "_"):
                    counts[fn][op] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            built = build_all([name])[name]
            lib = ctypes.CDLL(str(built.library))
            _libs[name] = lib
        return lib
