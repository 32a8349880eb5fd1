"""Fault-tolerant checkpointing in the on-disk layout of
``repro/checkpoint/checkpoint.py``, in numpy only, so a checkpoint of
numpy-typed leaves (float32, int) written by one package restores in
the other:

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
them to host memory on the caller's thread. A bfloat16 tensor, which
numpy cannot hold, is written as its bit pattern in a structured array
of one uint16 field named ``bfloat16`` (``dtype`` ``"bfloat16"`` in the
manifest) and read back widened to float32 (exactly). The JAX package
cannot read such a leaf: its restore raises ``TypeError`` (JAX takes no
structured array) rather than load the bits as integers. ``restore``
returns numpy arrays in the template's nesting.

Sharded trees (the pjit trainer on a ``torch.distributed`` mesh): ``save``
of a tree with DTensor leaves gathers every leaf whole on every rank (a
collective: every rank of the mesh calls it) and the rank at the mesh's
first coordinate writes it, so the files are those of an unsharded tree. ``restore(step, template,
shardings)`` gives each leaf with a ``Sharding`` as a DTensor holding
this rank's slice, in the template leaf's dtype on the mesh's device:
the reference's re-layout through ``device_put`` (elastic restore onto
another mesh).
"""
from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import iter_leaves, map_leaves
from repro_torch.platform.journal import fsync_enabled

log = logging.getLogger("repro_torch.checkpoint")

# a bfloat16 leaf on disk: its bits, in a dtype that JAX refuses
BF16_BITS = np.dtype([("bfloat16", "<u2")])


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host numpy copy, its dtype name) of a numpy array or a tensor
    (any device; a DTensor is gathered whole first). The caller may
    overwrite a tensor once ``save`` returns (a learner's PS pull buffer
    is reused in place), and ``.cpu()`` of a CPU tensor is the tensor
    itself, so a CPU tensor is copied here. bfloat16 goes as its bits
    (``BF16_BITS``)."""
    if hasattr(leaf, "detach"):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        name = str(t.dtype).removeprefix("torch.")
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.uint16)
        host = t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
        return (host.view(BF16_BITS) if bf16 else host), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _writer(tree) -> bool:
    """Whether this rank writes ``tree``: any tree without DTensor
    leaves, else the rank at the first coordinate of their mesh."""
    for _, v in iter_leaves(tree):
        if hasattr(v, "device_mesh"):
            return not any(v.device_mesh.get_coordinate())
    return True


def _widen(arr: np.ndarray) -> np.ndarray:
    """A leaf as numpy holds it: a bfloat16 leaf widened to float32."""
    if arr.dtype == BF16_BITS:
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(
            np.float32)
    return arr


def _tensor(arr: np.ndarray, dtype, device):
    """A leaf as a tensor of ``dtype`` on ``device``; a bfloat16 leaf's
    bits go to a bfloat16 tensor as they are (widening 1e9 of them to
    float32 on the host took most of a full-width restore)."""
    if arr.dtype == BF16_BITS and dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(_widen(arr))
    return t.to(device, dtype)


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _npy(arr: np.ndarray) -> Tuple[bytes, memoryview]:
    """``np.save``'s bytes of ``arr`` as (its header, a view of the
    array's own memory)."""
    from numpy.lib import format as npy
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    buf = io.BytesIO()
    d = npy.header_data_from_array_1_0(arr)
    try:
        npy.write_array_header_1_0(buf, d)
    except ValueError:              # a header too long for format 1.0
        buf = io.BytesIO()
        npy.write_array_header_2_0(buf, d)
    return buf.getvalue(), memoryview(arr.reshape(-1).view(np.uint8))


def _crc32(fp: Path, chunk: int = 1 << 26) -> int:
    """crc32 of a file, read in chunks: a full-width leaf is gigabytes,
    and a whole-file read would hold all of it in host memory at once."""
    crc = 0
    with open(fp, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                return crc
            crc = zlib.crc32(data, crc)


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
        """Snapshot on the caller thread, serialize on a worker thread.
        A tree with DTensor leaves is gathered on every rank of its mesh
        and written by the rank at the mesh's first coordinate only."""
        self.wait()
        # snapshot to host memory now (values may be mutated later)
        snap = {k: _host(v) for k, v in iter_leaves(tree)}
        if not _writer(tree):
            return
        host = {k: v for k, (v, _) in snap.items()}
        meta = {"step": int(step), "ts": time.time(),
                "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape), "dtype": name}
                           for k, (v, name) in snap.items()}}
        del snap
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
            # the bytes np.save writes, from the snapshot itself: no
            # host copy of the leaf on the way to the file
            header, data = _npy(v)
            crcs[k] = zlib.crc32(data, zlib.crc32(header))
            with open(tmp / _file(k), "wb") as f:
                f.write(header)
                f.write(data)
            if self.mirror is not None:
                blobs[_file(k)] = header + data.tobytes()
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
            self._upload(step, blobs, manifest.encode())
        self._gc()

    def _upload(self, step: int, blobs: Dict[str, bytes], manifest: bytes):
        # every put goes through StorageManager.upload's with_backoff
        storage, store_id, prefix = self.mirror
        container = f"{prefix}/step_{step:010d}"
        for name, data in blobs.items():
            storage.upload(store_id, container, name, data)
        storage.upload(store_id, container, "manifest.json", manifest)

    def wait_published(self, timeout: float, poll_s: float = 0.02) -> bool:
        """Wait until no checkpoint of this directory is being written
        (no ``step_*.tmp``), by this manager or another (a learner 0
        that has not published yet); False if one still is after
        ``timeout`` seconds (e.g. a write cut by a kill)."""
        deadline = time.time() + timeout
        while any(self.dir.glob("step_*.tmp")):
            if time.time() > deadline:
                return False
            time.sleep(poll_s)
        return True

    def pending(self) -> bool:
        """Whether an async write is still in flight."""
        return self._thread is not None and self._thread.is_alive()

    def publish(self, step: int) -> bool:
        """Upload checkpoint ``step`` as it stands on disk (written by
        another process) to the mirror, as ``save`` would have; False
        where it is no longer there (collected) or not valid."""
        path = self.dir / f"step_{step:010d}"
        if self.mirror is None or not self._valid(path):
            return False
        try:
            manifest = (path / "manifest.json").read_bytes()
            blobs = {_file(k): (path / _file(k)).read_bytes()
                     for k in json.loads(manifest)["crcs"]}
        except OSError:             # collected while it was read
            return False
        self._upload(step, blobs, manifest)
        return True

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
                    log.warning("checkpoint %s lacks leaf %s", path, k)
                    return False
                if _crc32(fp) != crc:
                    log.warning("checkpoint %s: leaf %s fails its crc",
                                path, k)
                    return False
            return True
        except (json.JSONDecodeError, OSError) as e:
            log.warning("checkpoint %s unreadable: %s: %s", path,
                        type(e).__name__, e)
            return False

    def latest_valid(self) -> Optional[int]:
        """Newest checkpoint that passes integrity checks (corrupt ones —
        e.g. from a crash or bitrot — are skipped)."""
        for step in reversed(self.steps()):
            if self._valid(self.dir / f"step_{step:010d}"):
                return step
        return None

    def extra(self, step: int) -> Dict:
        """The ``extra`` dict saved with checkpoint ``step`` (a learner
        that restores no leaf reads its step and cursor here)."""
        path = self.dir / f"step_{step:010d}" / "manifest.json"
        return json.loads(path.read_text()).get("extra", {})

    # ---- restore ------------------------------------------------------------
    def restore(self, step: int, template, shardings=None, device=None):
        """(tree, extra): the leaves of checkpoint ``step``, nested as
        ``template`` (whose leaf values are ignored but for their dtype
        where a tensor comes back): numpy arrays, or tensors in the
        template's dtypes on ``device`` when it is given, or, for each
        leaf whose entry in ``shardings`` (same nesting,
        ``distributed.sharding.Sharding`` leaves) is set, a DTensor of
        this rank's slice on the mesh."""
        path = self.dir / f"step_{step:010d}"
        meta = json.loads((path / "manifest.json").read_text())
        flat_s = dict(iter_leaves(shardings)) if shardings is not None \
            else {}

        def load(key, leaf):
            fp = path / _file(key)
            if not fp.exists():
                raise FileNotFoundError(f"checkpoint missing leaf {key}")
            arr = np.load(fp, allow_pickle=False)
            sh = flat_s.get(key)
            if sh is not None:
                from repro_torch.distributed.sharding import distribute
                return distribute(_tensor(arr, leaf.dtype,
                                          sh.mesh.device_type), sh)
            if device is not None:
                return _tensor(arr, leaf.dtype, device)
            return _widen(arr)

        return map_leaves(load, template), meta.get("extra", {})
