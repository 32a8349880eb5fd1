"""Fault-tolerant checkpointing in the on-disk layout of
``repro/checkpoint/checkpoint.py``, in numpy only, so a checkpoint
written by one package restores in the other:

  * ``<dir>/step_%010d/`` published atomically (write ``.tmp``, rename);
    ``DLAAS_FSYNC=1`` also fsyncs every leaf and the directory entry;
  * one ``<leaf>.npy`` per leaf, the leaf path with ``/`` -> ``__``
    (paths from ``models.layers.iter_leaves``: dict keys sorted, joined
    with ``/``, as ``jax.tree_util`` key paths of nested dicts);
  * ``manifest.json`` with ``step``, ``ts``, ``extra``, ``leaves``
    (shape, dtype) and per-leaf ``crcs`` (crc32 of the ``.npy`` bytes),
    verified by ``latest_valid``;
  * async save on a background thread, one outstanding; keep-last-k GC;
  * an optional object-store mirror ``(StorageManager, store, prefix)``.

Leaves may be numpy arrays or tensors on any device; ``save`` snapshots
them to host memory on the caller's thread. ``restore`` returns numpy
arrays in the template's nesting (the JAX package re-lays them out on a
mesh; the port has no mesh).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.models.layers import iter_leaves, map_leaves
from repro_torch.platform.journal import fsync_enabled


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a numpy array or a tensor (any device). The
    caller may overwrite a tensor once ``save`` returns (a learner's PS
    pull buffer is reused in place), and ``.cpu()`` of a CPU tensor is
    the tensor itself, so a CPU tensor is copied here."""
    if hasattr(leaf, "detach"):
        t = leaf.detach()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.array(leaf)


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True,
                 mirror: Optional[Tuple] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.fsync = fsync_enabled()
        # (StorageManager, store_id, container-prefix) or None
        self.mirror = mirror
        self._thread: Optional[threading.Thread] = None

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             block: bool = False):
        """Snapshot on the caller thread, serialize on a worker thread."""
        self.wait()
        # snapshot to host memory now (values may be mutated later)
        host = {k: _host(v) for k, v in iter_leaves(tree)}
        meta = {"step": int(step), "ts": time.time(),
                "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape),
                               "dtype": str(v.dtype)}
                           for k, v in host.items()}}
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: Dict):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        crcs = {}
        blobs = {}
        for k, v in host.items():
            buf = io.BytesIO()
            np.save(buf, v, allow_pickle=False)
            data = buf.getbuffer()      # no second host copy of the leaf
            crcs[k] = zlib.crc32(data)
            (tmp / _file(k)).write_bytes(data)
            if self.mirror is not None:
                blobs[_file(k)] = bytes(data)
        meta["crcs"] = crcs
        manifest = json.dumps(meta)
        (tmp / "manifest.json").write_text(manifest)
        if self.fsync:
            for f in tmp.iterdir():
                fd = os.open(f, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        if self.fsync:
            # fsync the parent dir so the rename itself is durable
            fd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        if self.mirror is not None:
            # every put goes through StorageManager.upload's with_backoff
            storage, store_id, prefix = self.mirror
            container = f"{prefix}/step_{step:010d}"
            for name, data in blobs.items():
                storage.upload(store_id, container, name, data)
            storage.upload(store_id, container, "manifest.json",
                           manifest.encode())
        self._gc()

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for c in ckpts[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(c, ignore_errors=True)

    # ---- discovery ---------------------------------------------------------
    def steps(self):
        out = []
        for c in sorted(self.dir.glob("step_*")):
            if c.name.endswith(".tmp"):
                continue
            try:
                out.append(int(c.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return out

    def _valid(self, path: Path) -> bool:
        mf = path / "manifest.json"
        if not mf.exists():
            return False
        try:
            meta = json.loads(mf.read_text())
            for k, crc in meta.get("crcs", {}).items():
                fp = path / _file(k)
                if not fp.exists():
                    return False
                if zlib.crc32(fp.read_bytes()) != crc:
                    return False
            return True
        except (json.JSONDecodeError, OSError):
            return False

    def latest_valid(self) -> Optional[int]:
        """Newest checkpoint that passes integrity checks (corrupt ones —
        e.g. from a crash or bitrot — are skipped)."""
        for step in reversed(self.steps()):
            if self._valid(self.dir / f"step_{step:010d}"):
                return step
        return None

    # ---- restore ------------------------------------------------------------
    def restore(self, step: int, template):
        """(tree, extra): the leaves of checkpoint ``step`` as numpy
        arrays, nested as ``template`` (whose leaf values are ignored)."""
        path = self.dir / f"step_{step:010d}"
        meta = json.loads((path / "manifest.json").read_text())

        def load(key, _leaf):
            fp = path / _file(key)
            if not fp.exists():
                raise FileNotFoundError(f"checkpoint missing leaf {key}")
            return np.load(io.BytesIO(fp.read_bytes()), allow_pickle=False)

        return map_leaves(load, template), meta.get("extra", {})
