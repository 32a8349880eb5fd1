"""Write-ahead journal for the control plane (the durability layer the
paper's resiliency pillar assumes: "stateless services over durable
metadata" — FfDL keeps all job state in etcd/MongoDB for exactly this).

A ``Journal`` persists an append-only JSONL log of mutations plus a
periodic atomic snapshot:

  * every record is one line, ``<crc32-hex8> <json>\\n`` — the crc covers
    the JSON payload, so a torn tail (crash mid-append) or bitrot is
    detected and dropped instead of corrupting replay;
  * records carry a monotonic ``seq``; the snapshot stores the last
    sequence it folded in, so replay after a crash between
    snapshot-publish and log-truncation never double-applies;
  * ``snapshot()`` writes atomically (tmp + rename) and truncates the
    log — compaction, triggered every ``compact_every`` appends;
  * opt-in true crash durability: ``DLAAS_FSYNC=1`` fsyncs the log on
    every append and the snapshot on publish (off by default — the sim's
    crash model is process death, not power loss).

The owner (``platform/zookeeper.py``) decides WHAT to journal; this
module only guarantees that what was appended before a crash is what
``load()`` returns after it.

Copied from ``repro/platform/journal.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple


def fsync_enabled() -> bool:
    return os.environ.get("DLAAS_FSYNC", "0") == "1"


class Journal:
    def __init__(self, directory: str, *, compact_every: int = 512,
                 fsync: Optional[bool] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.dir / "wal.jsonl"
        self.snap_path = self.dir / "snapshot.json"
        self.compact_every = compact_every
        self.fsync = fsync_enabled() if fsync is None else fsync
        self._fh = None
        self._since_snapshot = 0
        self.compactions = 0        # snapshots published by this process

    # ---- append --------------------------------------------------------
    def append(self, record: Dict):
        """Durably append one mutation record. The caller must include a
        monotonic ``seq`` so replay can skip records already folded into
        a snapshot."""
        payload = json.dumps(record, sort_keys=True,
                             separators=(",", ":"))
        line = f"{zlib.crc32(payload.encode()):08x} {payload}\n"
        if self._fh is None:
            self._fh = open(self.log_path, "a", encoding="utf-8")
        self._fh.write(line)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._since_snapshot += 1

    def maybe_compact(self, state_fn: Callable[[], Dict]):
        """Fold the log into a fresh snapshot once ``compact_every``
        records have accumulated. ``state_fn`` must return the full
        serialized state INCLUDING ``last_seq``."""
        if self._since_snapshot >= self.compact_every:
            self.snapshot(state_fn())

    def snapshot(self, state: Dict):
        """Atomically publish a snapshot, then truncate the log. A crash
        between the two leaves a log whose records are all <= the
        snapshot's ``last_seq`` — replay skips them (no double-apply)."""
        payload = json.dumps(state, sort_keys=True, separators=(",", ":"))
        body = json.dumps({"crc": zlib.crc32(payload.encode()),
                           "state": payload})
        tmp = self.snap_path.with_suffix(".json.tmp")
        tmp.write_text(body)
        if self.fsync:
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        tmp.rename(self.snap_path)
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.log_path, "w", encoding="utf-8")
        self._since_snapshot = 0
        self.compactions += 1

    # ---- recovery ------------------------------------------------------
    def load(self) -> Tuple[Optional[Dict], List[Dict], int]:
        """Read back (snapshot_state | None, records, dropped). Records
        are returned in append order; the first corrupt/torn record ends
        the scan (everything after it is unreachable) and the file is
        truncated back to the last good byte so future appends stay
        readable. Records whose ``seq`` the snapshot already covers are
        filtered out here."""
        snap = None
        last_seq = -1
        if self.snap_path.exists():
            try:
                wrap = json.loads(self.snap_path.read_text())
                payload = wrap["state"]
                if zlib.crc32(payload.encode()) == wrap["crc"]:
                    snap = json.loads(payload)
                    last_seq = int(snap.get("last_seq", -1))
            except (json.JSONDecodeError, KeyError, OSError,
                    ValueError, TypeError):
                snap = None
        records: List[Dict] = []
        dropped = 0
        good_end = 0
        if self.log_path.exists():
            raw = self.log_path.read_bytes()
            pos = 0
            while pos < len(raw):
                nl = raw.find(b"\n", pos)
                if nl < 0:
                    dropped += 1          # torn tail: no newline landed
                    break
                line = raw[pos:nl]
                try:
                    crc_hex, payload = line.split(b" ", 1)
                    if int(crc_hex, 16) != zlib.crc32(payload):
                        raise ValueError("crc mismatch")
                    rec = json.loads(payload)
                except (ValueError, json.JSONDecodeError):
                    # corrupt record: everything after it is unordered
                    # relative to the mutation stream — stop here
                    dropped += 1
                    break
                if int(rec.get("seq", -1)) > last_seq:
                    records.append(rec)
                pos = nl + 1
                good_end = pos
            if dropped and good_end < len(raw):
                with open(self.log_path, "r+b") as fh:
                    fh.truncate(good_end)
        return snap, records, dropped

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
