"""In-process ZooKeeper simulation.

Implements the coordination contract DLaaS depends on (paper §Fault-
Tolerance): a replicated, atomic KV tree with ephemeral znodes bound to
sessions, sequential znodes, watches, and atomic counters (the global
cursor). Replication is modelled as a liveness quorum — operations fail
with ``ConnectionLoss`` when a majority of replicas are down, matching the
paper's "unless a majority of the nodes fail" availability claim.

Thread-safe: the LCM, watchdogs and learner threads all talk to one
instance concurrently.

Durability: pass ``journal=`` (a ``platform.journal.Journal`` or a
directory path) and every non-ephemeral mutation is written ahead to an
append-only crc32-framed log before the call returns; a new ``ZooKeeper``
over the same journal replays snapshot + log back to the pre-crash tree.
Ephemeral znodes are deliberately NOT journaled — they exist to die with
their session, and after a process crash every session is gone.

Copied from ``repro/platform/zookeeper.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.

Its logger is named under the port's own ``"repro_torch"`` tree (see
``observability/log.py``), so in a process that loads both packages the
reference's log hubs receive none of the port's records.
"""
from __future__ import annotations

import base64
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .journal import Journal

log = logging.getLogger("repro_torch.zk")


class ZKError(Exception):
    pass


class NoNodeError(ZKError):
    pass


class NodeExistsError(ZKError):
    pass


class BadVersionError(ZKError):
    pass


class ConnectionLoss(ZKError):
    """Raised when a majority of replicas are down (no quorum)."""


def zk_retry(fn, *, retries: int = 7, base_delay: float = 0.01,
             sleep=time.sleep):
    """Run ``fn()`` retrying ``ConnectionLoss`` with bounded exponential
    backoff — a quorum outage shorter than ~1.3s (default budget) is
    invisible to callers; a longer one re-raises the final error."""
    delay = base_delay
    for attempt in range(retries):
        try:
            return fn()
        except ConnectionLoss:
            if attempt == retries - 1:
                raise
            sleep(delay)
            delay *= 2


@dataclass
class ZNode:
    data: bytes = b""
    version: int = 0
    ephemeral_owner: Optional[int] = None       # session id
    children: Dict[str, "ZNode"] = field(default_factory=dict)
    seq_counter: int = 0
    ctime: float = field(default_factory=time.time)


def _split(path: str) -> List[str]:
    parts = [p for p in path.strip("/").split("/") if p]
    if not parts:
        raise ZKError(f"bad path {path!r}")
    return parts


def _enc(data: bytes) -> Tuple[str, bool]:
    """Encode znode data for JSON journaling (utf-8 when it is text —
    the overwhelmingly common case — base64 otherwise)."""
    try:
        return data.decode("utf-8"), False
    except UnicodeDecodeError:
        return base64.b64encode(data).decode("ascii"), True


def _dec(text: str, b64: bool) -> bytes:
    return base64.b64decode(text) if b64 else text.encode("utf-8")


def _tree_to_dict(node: "ZNode") -> Dict:
    """Serialize a znode subtree for snapshotting. Ephemeral nodes (and
    anything under them) are skipped — they die with their sessions, and
    a recovered process has no sessions."""
    out = {"data": None, "version": node.version,
           "seqc": node.seq_counter, "children": {}}
    text, b64 = _enc(node.data)
    out["data"] = text
    if b64:
        out["b64"] = True
    for name, ch in node.children.items():
        if ch.ephemeral_owner is not None:
            continue
        out["children"][name] = _tree_to_dict(ch)
    return out


def _tree_from_dict(d: Dict) -> "ZNode":
    node = ZNode(data=_dec(d["data"], d.get("b64", False)),
                 version=int(d.get("version", 0)),
                 seq_counter=int(d.get("seqc", 0)))
    for name, ch in d.get("children", {}).items():
        node.children[name] = _tree_from_dict(ch)
    return node


class Session:
    """A client session; closing (or expiring) it deletes its ephemerals."""

    _next_id = [1]

    def __init__(self, zk: "ZooKeeper"):
        self.zk = zk
        self.id = Session._next_id[0]
        Session._next_id[0] += 1
        self.alive = True

    def close(self):
        if self.alive:
            self.alive = False
            self.zk._expire_session(self.id)

    # paper terminology: a crashed container's session *expires*
    expire = close

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ZooKeeper:
    def __init__(self, replicas: int = 3,
                 journal: Optional[object] = None):
        self._root = ZNode()
        self._lock = threading.RLock()
        self._watches: Dict[str, List[Callable[[str, str], None]]] = {}
        self._replicas_alive = [True] * replicas
        self._journal: Optional[Journal] = None
        self._seq = 0
        self.journal_stats: Dict[str, int] = {}
        if journal is not None:
            j = journal if isinstance(journal, Journal) else \
                Journal(str(journal))
            self._replay(j)
            self._journal = j

    # ---- write-ahead journal ---------------------------------------------
    def _replay(self, j: Journal):
        """Rebuild the tree from snapshot + log. Runs before the journal
        is attached, so replay never re-journals."""
        snap, records, dropped = j.load()
        if snap is not None:
            self._root = _tree_from_dict(snap["tree"])
            self._seq = int(snap.get("last_seq", -1)) + 1
        for rec in records:
            self._apply(rec)
            self._seq = int(rec["seq"]) + 1
        self.journal_stats = {
            "snapshot": int(snap is not None),
            "records": len(records),
            "dropped": dropped,
        }

    def _apply(self, rec: Dict):
        """Apply one journal record straight to the tree — no quorum
        check, no watches, no re-journaling. Tolerant of records whose
        effect is already present (snapshot/log overlap after a crash
        between snapshot-publish and truncate is filtered by seq, but we
        stay defensive)."""
        op = rec["op"]
        if op == "delete":
            try:
                self._delete_locked(rec["path"], fire=False)
            except NoNodeError:
                pass
            return
        parts = _split(rec["path"])
        node = self._root
        for part in parts[:-1]:
            node = node.children.setdefault(part, ZNode())
        name = parts[-1]
        if op == "create":
            node.children[name] = ZNode(
                data=_dec(rec["data"], rec.get("b64", False)))
            if rec.get("seqc") is not None:
                node.seq_counter = max(node.seq_counter, int(rec["seqc"]))
        elif op == "set":
            ch = node.children.setdefault(name, ZNode())
            ch.data = _dec(rec["data"], rec.get("b64", False))
            ch.version += 1

    def _journal_op(self, rec: Dict):
        """Caller holds self._lock and has already mutated the tree."""
        if self._journal is None:
            return
        rec["seq"] = self._seq
        self._seq += 1
        self._journal.append(rec)
        self._journal.maybe_compact(self._snapshot_state)

    def _snapshot_state(self) -> Dict:
        return {"last_seq": self._seq - 1,
                "tree": _tree_to_dict(self._root)}

    def snapshot(self):
        """Force a snapshot + log compaction now (normally automatic
        every ``compact_every`` mutations)."""
        with self._lock:
            if self._journal is not None:
                self._journal.snapshot(self._snapshot_state())

    def journal_live_stats(self) -> Dict:
        """Exporter view of the durability layer: replay stats from the
        last recovery plus live append/compaction counters."""
        with self._lock:
            j = self._journal
            out = {"seq": self._seq,
                   "snapshot": self.journal_stats.get("snapshot", 0),
                   "records_replayed": self.journal_stats.get(
                       "records", 0),
                   "dropped": self.journal_stats.get("dropped", 0),
                   "since_compact": 0, "compactions_total": 0,
                   "attached": int(j is not None)}
            if j is not None:
                out["since_compact"] = j._since_snapshot
                out["compactions_total"] = j.compactions
            return out

    def detach_journal(self):
        """Stop journaling — nothing after this call is durable. Used by
        the SIGKILL-equivalent core crash: the dying incarnation's
        threads may keep mutating the old tree, but the journal now
        belongs to the recovering incarnation."""
        with self._lock:
            j, self._journal = self._journal, None
            if j is not None:
                j.close()

    # ---- replication / quorum --------------------------------------------
    def kill_replica(self, i: int):
        with self._lock:
            self._replicas_alive[i] = False

    def restore_replica(self, i: int):
        with self._lock:
            self._replicas_alive[i] = True

    def has_quorum(self) -> bool:
        n = len(self._replicas_alive)
        return sum(self._replicas_alive) * 2 > n

    def _check_quorum(self):
        if not self.has_quorum():
            raise ConnectionLoss("no ZK quorum")

    # ---- sessions ----------------------------------------------------------
    def session(self) -> Session:
        return Session(self)

    def _expire_session(self, sid: int):
        with self._lock:
            doomed: List[str] = []

            def walk(node: ZNode, path: str):
                for name, ch in list(node.children.items()):
                    p = f"{path}/{name}"
                    if ch.ephemeral_owner == sid:
                        doomed.append(p)
                    else:
                        walk(ch, p)
            walk(self._root, "")
            for p in doomed:
                try:
                    self._delete_locked(p)
                except NoNodeError:
                    pass

    # ---- tree ops ----------------------------------------------------------
    def _get_node(self, path: str) -> ZNode:
        node = self._root
        for part in _split(path):
            if part not in node.children:
                raise NoNodeError(path)
            node = node.children[part]
        return node

    def create(self, path: str, data: bytes = b"", *,
               ephemeral: bool = False, sequential: bool = False,
               session: Optional[Session] = None,
               makepath: bool = False) -> str:
        if ephemeral and session is None:
            raise ZKError("ephemeral znode requires a session")
        with self._lock:
            self._check_quorum()
            parts = _split(path)
            node = self._root
            for part in parts[:-1]:
                if part not in node.children:
                    if not makepath:
                        raise NoNodeError(path)
                    node.children[part] = ZNode()
                node = node.children[part]
            name = parts[-1]
            if sequential:
                name = f"{name}{node.seq_counter:010d}"
                node.seq_counter += 1
            if name in node.children:
                raise NodeExistsError(path)
            node.children[name] = ZNode(
                data=data,
                ephemeral_owner=session.id if ephemeral else None)
            full = "/" + "/".join(parts[:-1] + [name]) if len(parts) > 1 \
                else "/" + name
            if not ephemeral:
                text, b64 = _enc(data)
                rec = {"op": "create", "path": full, "data": text}
                if b64:
                    rec["b64"] = True
                if sequential:
                    rec["seqc"] = node.seq_counter
                self._journal_op(rec)
            self._fire(full, "created")
            parent = "/" + "/".join(parts[:-1]) if len(parts) > 1 else "/"
            self._fire(parent, "children")
            return full

    def get(self, path: str) -> Tuple[bytes, int]:
        with self._lock:
            self._check_quorum()
            n = self._get_node(path)
            return n.data, n.version

    def set(self, path: str, data: bytes, version: int = -1) -> int:
        with self._lock:
            self._check_quorum()
            n = self._get_node(path)
            if version != -1 and version != n.version:
                raise BadVersionError(path)
            n.data = data
            n.version += 1
            if n.ephemeral_owner is None:
                text, b64 = _enc(data)
                rec = {"op": "set", "path": path, "data": text}
                if b64:
                    rec["b64"] = True
                self._journal_op(rec)
            self._fire(path, "changed")
            return n.version

    def exists(self, path: str) -> bool:
        with self._lock:
            try:
                self._get_node(path)
                return True
            except NoNodeError:
                return False

    def children(self, path: str) -> List[str]:
        with self._lock:
            self._check_quorum()
            return sorted(self._get_node(path).children)

    def _delete_locked(self, path: str, fire: bool = True):
        parts = _split(path)
        node = self._root
        for part in parts[:-1]:
            if part not in node.children:
                raise NoNodeError(path)
            node = node.children[part]
        if parts[-1] not in node.children:
            raise NoNodeError(path)
        doomed = node.children.pop(parts[-1])
        if not fire:
            return
        if doomed.ephemeral_owner is None:
            self._journal_op({"op": "delete", "path": path})
        self._fire(path, "deleted")
        parent = "/" + "/".join(parts[:-1]) if len(parts) > 1 else "/"
        self._fire(parent, "children")

    def delete(self, path: str):
        with self._lock:
            self._check_quorum()
            self._delete_locked(path)

    def ensure(self, path: str):
        with self._lock:
            if not self.exists(path):
                self.create(path, makepath=True)

    # ---- atomic counter (global cursor substrate) ---------------------------
    def increment(self, path: str, by: int = 1) -> int:
        """Atomic add; returns the PRIOR value (fetch-and-add)."""
        with self._lock:
            self._check_quorum()
            if not self.exists(path):
                self.create(path, b"0", makepath=True)
            n = self._get_node(path)
            prior = int(n.data or b"0")
            n.data = str(prior + by).encode()
            n.version += 1
            # journaled as the resulting absolute value, so replay is a
            # plain set regardless of interleaving
            self._journal_op({"op": "set", "path": path,
                              "data": str(prior + by)})
            self._fire(path, "changed")
            return prior

    # ---- watches -------------------------------------------------------------
    def watch(self, path: str, cb: Callable[[str, str], None]):
        """cb(path, event) with event in created|changed|deleted|children."""
        with self._lock:
            self._watches.setdefault(path, []).append(cb)

    def _fire(self, path: str, event: str):
        for cb in self._watches.get(path, []):
            try:
                cb(path, event)
            except Exception as e:
                log.warning("watch callback for %s failed: %s: %s",
                            path, type(e).__name__, e)
