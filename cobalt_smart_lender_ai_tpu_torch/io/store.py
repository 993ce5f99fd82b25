"""Local-filesystem object store: keys are paths under a root directory.

The port's copy of the reference store's contract for plain paths and
``file://`` URIs: the byte-blob primitives (`put_bytes`, `get_bytes`,
`exists`, `delete`, `list`), local files (`put_file`, `get_file`), JSON, frames as CSV (`save_frame` writes with
`io.frames`, `load_frame` reads with the native reader, `native.read_csv`,
or the codec where it cannot be built), ndarrays as ``.npy``/``.npz``, and
content-addressed pointers (`write_pointer`, `verify_pointer`: md5 and size
in ``<key>.ptr.json``, the reference's JSON byte for byte).
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import secrets
import shutil
from pathlib import Path
from typing import Iterator

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
from cobalt_smart_lender_ai_tpu_torch.io.frames import frame_to_csv

#: Suffix of content-addressed pointer objects (`write_pointer`).
PTR_SUFFIX = ".ptr.json"


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

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> None:
        p = self._path(key)
        if p.is_dir():
            shutil.rmtree(p)
        elif p.exists():
            p.unlink()

    def list(self, prefix: str = "") -> Iterator[str]:
        """Keys that start with ``prefix`` (a string prefix, not a
        directory), sorted."""
        base = self.root.resolve()
        if not base.exists():
            return
        for p in sorted(base.rglob("*")):
            if p.is_file():
                key = str(p.relative_to(base))
                if key.startswith(prefix):
                    yield key

    # -- conveniences over the primitives ---------------------------------------
    def put_file(self, key: str, path: str | Path) -> None:
        """Store a local file's bytes under ``key``."""
        self.put_bytes(key, Path(path).read_bytes())

    def get_file(self, key: str, path: str | Path) -> Path:
        """Write ``key``'s bytes to the local ``path`` (its directory made
        first); returns the path."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(self.get_bytes(key))
        return p

    def get_json(self, key: str):
        return json.loads(self.get_bytes(key).decode())

    def put_json(self, key: str, obj) -> None:
        self.put_bytes(key, json.dumps(obj, indent=2, sort_keys=True).encode())

    def save_frame(self, key: str, frame: RawFrame) -> None:
        """The frame as a CSV object (`io.frames.frame_to_csv`)."""
        self.put_bytes(key, frame_to_csv(frame))

    def load_frame(self, key: str) -> RawFrame:
        """A CSV object as a `RawFrame`: the native reader's
        (`native.read_csv`), which equals `io.frames.csv_to_frame`'s, or the
        codec's where the reader cannot be built."""
        from cobalt_smart_lender_ai_tpu_torch.native import read_csv

        return read_csv(self.get_bytes(key), engine="auto")

    def save_array(self, key: str, arr: np.ndarray) -> None:
        buf = _io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        self.put_bytes(key, buf.getvalue())

    def load_array(self, key: str) -> np.ndarray:
        return np.load(_io.BytesIO(self.get_bytes(key)), allow_pickle=False)

    def save_arrays(self, key: str, arrays: dict) -> None:
        """A dict of ndarrays as one uncompressed ``.npz`` object."""
        buf = _io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        self.put_bytes(key, buf.getvalue())

    def load_arrays(self, key: str) -> dict:
        z = np.load(_io.BytesIO(self.get_bytes(key)), allow_pickle=False)
        return {k: z[k] for k in z.files}

    def write_pointer(self, key: str) -> dict:
        """Pin ``key``'s current content by md5 and size in
        ``<key>.ptr.json``."""
        data = self.get_bytes(key)
        ptr = {"key": key, "md5": hashlib.md5(data).hexdigest(), "size": len(data)}
        self.put_json(key + PTR_SUFFIX, ptr)
        return ptr

    def verify_pointer(self, key: str) -> bool:
        """Whether ``key``'s content still matches its pointer; False (never
        an exception) when either is missing or unreadable."""
        try:
            ptr = self.get_json(key + PTR_SUFFIX)
            data = self.get_bytes(key)
        except Exception:
            return False
        if not isinstance(ptr, dict):
            return False
        return hashlib.md5(data).hexdigest() == ptr.get("md5") and len(data) == ptr.get("size")
