"""Local-filesystem object store: keys are paths under a root directory.

The port's copy of the reference store's byte-blob contract
(`get_bytes`/`put_bytes`/`get_json`/`put_json`) for plain paths and ``file://`` URIs.
"""

from __future__ import annotations

import json
import os
import secrets
from pathlib import Path


class StoreKeyError(ValueError):
    """The key is absolute or escapes the store's root."""


class ObjectStore:
    """Byte-blob store over a local directory.

    >>> store = ObjectStore("artifacts")
    >>> store.put_bytes("a/b.txt", b"hi")
    >>> store.get_bytes("a/b.txt")
    b'hi'
    """

    def __init__(self, uri: str):
        if uri.startswith("s3://"):
            raise ValueError("the port's store reads local paths only, not s3://")
        self.uri = uri
        self.root = Path(uri[len("file://") :] if uri.startswith("file://") else uri)

    def _path(self, key: str) -> Path:
        if key.startswith(("/", "\\")) or ".." in key.replace("\\", "/").split("/"):
            raise StoreKeyError(f"key {key!r} is absolute or escapes the store root")
        p = (self.root / key).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise StoreKeyError(f"key {key!r} escapes store root {self.root}")
        return p

    def put_bytes(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        # Unique temp name per writer, then an atomic rename.
        tmp = p.with_name(f"{p.name}.{os.getpid():x}.{secrets.token_hex(4)}.tmp")
        try:
            tmp.write_bytes(data)
            tmp.replace(p)
        finally:
            tmp.unlink(missing_ok=True)

    def get_bytes(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def get_json(self, key: str):
        return json.loads(self.get_bytes(key).decode())

    def put_json(self, key: str, obj) -> None:
        self.put_bytes(key, json.dumps(obj, indent=2, sort_keys=True).encode())
