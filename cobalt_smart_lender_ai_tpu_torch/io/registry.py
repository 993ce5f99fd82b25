"""Dataset versioning: content-addressed md5 + size pins over the object
store, the port's copy of the reference's ``io/registry.py`` (its stand-in
for the DVC pointers that pin the raw LendingClub tables).

- blobs live content-addressed under ``<prefix>/cache/md5[:2]/md5[2:]``
  (DVC's remote layout), so identical data is stored once whatever names
  point at it;
- a pin is a JSON pointer ``<prefix>/pins/<name>.json`` with the fields of a
  ``.dvc`` ``outs`` entry: ``md5``, ``size``, ``hash``, ``path``;
- `DatasetRegistry.pull` verifies md5 and size on the way out: a corrupted
  or swapped blob is an error, never silently other training data.

The layout and the JSON are the reference's, so a pin written by either
package verifies in the other.
"""

from __future__ import annotations

import hashlib
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterator

from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore

__all__ = ["REFERENCE_RAW_PINS", "DatasetPin", "DatasetRegistry"]


@dataclass(frozen=True)
class DatasetPin:
    """One pinned dataset version: the fields of a DVC pointer's ``outs``
    entry."""

    path: str
    md5: str
    size: int
    hash: str = "md5"


#: The reference's two raw-data pins, from its ``.dvc`` pointer files: a
#: locally supplied copy of either table verifies against these digests.
REFERENCE_RAW_PINS = (
    DatasetPin(
        path="Loan_status_2007-2020Q3-100ksample.csv",
        md5="4e01f7e3ef869a35b65c400d3edda715",
        size=73_991_891,
    ),
    DatasetPin(
        path="Loan_status_2007-2020Q3.gzip",
        md5="65adade308f21d60b7213088a88e684d",
        size=1_773_470_505,
    ),
)


def _md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class DatasetRegistry:
    """Named, md5-pinned datasets over a content-addressed store cache."""

    def __init__(self, store: ObjectStore, prefix: str = "dataset"):
        self.store = store
        self.prefix = prefix.rstrip("/")

    def _cache_key(self, md5: str) -> str:
        return f"{self.prefix}/cache/{md5[:2]}/{md5[2:]}"

    def _pin_key(self, name: str) -> str:
        return f"{self.prefix}/pins/{name}.json"

    def add(self, name: str, data: bytes | str | Path) -> DatasetPin:
        """Pin ``name`` to the given content (bytes or a local file) and put
        the blob in the cache (``dvc add`` and ``dvc push`` in one step)."""
        blob = data if isinstance(data, bytes) else Path(data).read_bytes()
        pin = DatasetPin(path=name, md5=_md5(blob), size=len(blob))
        cache_key = self._cache_key(pin.md5)
        if not self.store.exists(cache_key):  # content stored once
            self.store.put_bytes(cache_key, blob)
        self.store.put_json(self._pin_key(name), asdict(pin))
        return pin

    def pin(self, name: str) -> DatasetPin:
        return DatasetPin(**self.store.get_json(self._pin_key(name)))

    def pull(self, name: str, dest: str | Path | None = None) -> bytes:
        """``name``'s pinned content, verified against md5 and size (``dvc
        pull``); also written to ``dest`` when given."""
        pin = self.pin(name)
        blob = self.store.get_bytes(self._cache_key(pin.md5))
        if _md5(blob) != pin.md5 or len(blob) != pin.size:
            raise ValueError(
                f"dataset {name!r} failed verification: cache blob does not "
                f"match pin md5={pin.md5} size={pin.size}"
            )
        if dest is not None:
            p = Path(dest)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(blob)
        return blob

    def verify(self, name: str) -> bool:
        """Whether the cached blob still matches the pin (``dvc status``)."""
        try:
            self.pull(name)
            return True
        except (ValueError, FileNotFoundError):
            return False

    def verify_local(self, name: str, path: str | Path) -> bool:
        """Check a local file against the pin without touching the cache."""
        pin = self.pin(name)
        blob = Path(path).read_bytes()
        return _md5(blob) == pin.md5 and len(blob) == pin.size

    def names(self) -> Iterator[str]:
        plen = len(f"{self.prefix}/pins/")
        for key in self.store.list(f"{self.prefix}/pins/"):
            if key.endswith(".json"):
                yield key[plen : -len(".json")]

    def import_reference_pins(self) -> None:
        """Record `REFERENCE_RAW_PINS` as named pins, before any blob is
        supplied."""
        for pin in REFERENCE_RAW_PINS:
            self.store.put_json(self._pin_key(pin.path), asdict(pin))
