"""KV storage backends: bucketed key/value stores for catalog + segments (carried over from
knoxdb_tpu/store/kv.py).

Abstraction mirrors the reference store layer (pkg/store/
iface.go:15-90 DB/Tx/Bucket + driver registry driver.go:34) reduced to
what the engine persists: the catalog (schemas, object state), sealed
encoded segments, and secondary index payloads. Backends:

- MemStore: in-process dicts (reference pkg/store/memdb)
- FileStore: directory-per-bucket, file-per-key with atomic tmp+rename
  writes (replaces bbolt; segment blobs are large and immutable, so a
  B+tree buys nothing on the engine's access pattern)

Register new backends with `register_driver` (reference RegisterDriver).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator

__all__ = ["Store", "MemStore", "FileStore", "register_driver", "open_store",
           "create_store"]


class Bucket:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, key: bytes, val: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def keys(self) -> Iterator[bytes]:
        raise NotImplementedError

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        for k in self.keys():
            yield k, self.get(k)


class Store:
    def bucket(self, name: str, create: bool = True) -> Bucket:
        raise NotImplementedError

    def drop_bucket(self, name: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def sync(self) -> None:
        pass


# ------------------------------------------------------------------ mem ---

class _MemBucket(Bucket):
    def __init__(self):
        self.d: dict[bytes, bytes] = {}

    def get(self, key):
        return self.d.get(key)

    def put(self, key, val):
        self.d[key] = bytes(val)

    def delete(self, key):
        self.d.pop(key, None)

    def keys(self):
        return iter(sorted(self.d.keys()))


class MemStore(Store):
    def __init__(self, path=None):
        self._buckets: dict[str, _MemBucket] = {}

    def bucket(self, name, create=True):
        b = self._buckets.get(name)
        if b is None:
            if not create:
                raise KeyError(name)
            b = self._buckets[name] = _MemBucket()
        return b

    def drop_bucket(self, name):
        self._buckets.pop(name, None)


# ----------------------------------------------------------------- file ---

def _esc(key: bytes) -> str:
    return key.hex()


class _FileBucket(Bucket):
    def __init__(self, path: Path):
        self.path = path
        path.mkdir(parents=True, exist_ok=True)

    def get(self, key):
        p = self.path / _esc(key)
        try:
            return p.read_bytes()
        except FileNotFoundError:
            return None

    def put(self, key, val):
        p = self.path / _esc(key)
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(val)
        os.replace(tmp, p)

    def delete(self, key):
        (self.path / _esc(key)).unlink(missing_ok=True)

    def keys(self):
        names = sorted(p.name for p in self.path.iterdir()
                       if not p.name.endswith(".tmp"))
        return (bytes.fromhex(n) for n in names)


class FileStore(Store):
    def __init__(self, path: str | Path):
        self.root = Path(path)
        self.root.mkdir(parents=True, exist_ok=True)

    def bucket(self, name, create=True):
        p = self.root / name
        if not p.exists() and not create:
            raise KeyError(name)
        return _FileBucket(p)

    def drop_bucket(self, name):
        import shutil
        shutil.rmtree(self.root / name, ignore_errors=True)

    def sync(self):
        pass


# -------------------------------------------------------------- drivers ---

_DRIVERS = {"mem": MemStore, "file": FileStore}


def register_driver(name: str, cls) -> None:
    _DRIVERS[name] = cls


def create_store(driver: str, path=None) -> Store:
    return _DRIVERS[driver](path)


def open_store(driver: str, path=None) -> Store:
    return _DRIVERS[driver](path)
