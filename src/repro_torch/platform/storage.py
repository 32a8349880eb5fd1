"""Pluggable storage (paper §Integration of Storage).

DLaaS "abstracts access to the external storage service through a
pluggable storage component": here a ``StorageManager`` registry over
``Store`` implementations (local FS, and an object store with credential
checking that models Swift/COS semantics). DLaaS microservices "perform
exponential backoffs and re-tries for failures associated with ... access
[to] dependent services such as temporary failures in access to Object
Store" — ``with_backoff`` implements that and the object store supports
fault injection to test it.

Copied from ``repro/platform/storage.py`` unchanged apart from import paths:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional


class StorageError(Exception):
    pass


class AuthError(StorageError):
    pass


class TransientError(StorageError):
    """Temporary failure — callers should retry with backoff."""


def with_backoff(fn: Callable, *, retries: int = 5, base_delay: float = 0.01,
                 sleep=time.sleep):
    """Exponential backoff on TransientError (paper §Fault-Tolerance)."""
    attempt = 0
    while True:
        try:
            return fn()
        except TransientError:
            attempt += 1
            if attempt > retries:
                raise
            sleep(base_delay * (2 ** (attempt - 1)))


class Store:
    def put(self, container: str, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, container: str, name: str) -> bytes:
        raise NotImplementedError

    def list(self, container: str) -> List[str]:
        raise NotImplementedError

    def delete(self, container: str, name: str) -> None:
        raise NotImplementedError

    def exists(self, container: str, name: str) -> bool:
        raise NotImplementedError


class LocalFSStore(Store):
    """NFS-style store (paper: 'or Network File System')."""

    def __init__(self, base: str):
        self.base = Path(base)
        self.base.mkdir(parents=True, exist_ok=True)

    def _p(self, container: str, name: str = "") -> Path:
        p = (self.base / container / name) if name else self.base / container
        return p

    def put(self, container, name, data):
        p = self._p(container, name)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.rename(p)                      # atomic publish

    def get(self, container, name):
        p = self._p(container, name)
        if not p.exists():
            raise StorageError(f"{container}/{name} not found")
        return p.read_bytes()

    def list(self, container):
        p = self._p(container)
        if not p.exists():
            return []
        return sorted(str(f.relative_to(p)) for f in p.rglob("*")
                      if f.is_file())

    def delete(self, container, name):
        p = self._p(container, name)
        if p.exists():
            p.unlink()

    def exists(self, container, name):
        return self._p(container, name).exists()


class ObjectStore(Store):
    """Swift/COS-style object store with credentials + fault injection."""

    def __init__(self, base: str, credentials: Optional[Dict[str, str]] = None):
        self._fs = LocalFSStore(base)
        self._creds = credentials or {}
        self._lock = threading.Lock()
        self._fail_next = 0                # inject N transient failures
        self._auth: Optional[str] = None

    # ---- auth (paper: auth_url/user_name/password in manifest) ----------
    def authenticate(self, user: str, password: str) -> str:
        if self._creds and self._creds.get(user) != password:
            raise AuthError(f"bad credentials for {user}")
        self._auth = f"token-{user}-{zlib.crc32(password.encode()):x}"
        return self._auth

    def _check(self):
        if self._creds and self._auth is None:
            raise AuthError("not authenticated")
        with self._lock:
            if self._fail_next > 0:
                self._fail_next -= 1
                raise TransientError("injected object-store failure")

    def inject_failures(self, n: int):
        with self._lock:
            self._fail_next = n

    def put(self, container, name, data):
        self._check()
        self._fs.put(container, name, data)

    def get(self, container, name):
        self._check()
        return self._fs.get(container, name)

    def list(self, container):
        self._check()
        return self._fs.list(container)

    def delete(self, container, name):
        self._check()
        self._fs.delete(container, name)

    def exists(self, container, name):
        self._check()
        return self._fs.exists(container, name)


class StorageManager:
    """The Storage Manager microservice: 'reliable connectivity with
    internal and external storage systems'."""

    def __init__(self):
        self._stores: Dict[str, Store] = {}

    def register(self, store_id: str, store: Store):
        self._stores[store_id] = store

    def get_store(self, store_id: str) -> Store:
        if store_id not in self._stores:
            raise StorageError(f"unknown data store {store_id!r}; "
                               f"registered: {sorted(self._stores)}")
        return self._stores[store_id]

    # load.sh / store.sh analogues ----------------------------------------
    def download(self, store_id: str, container: str, name: str) -> bytes:
        st = self.get_store(store_id)
        return with_backoff(lambda: st.get(container, name))

    def upload(self, store_id: str, container: str, name: str, data: bytes):
        st = self.get_store(store_id)
        with_backoff(lambda: st.put(container, name, data))
