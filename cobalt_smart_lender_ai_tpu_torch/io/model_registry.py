"""Versioned model registry: the publishing half of the continuous-training
loop, the reference's ``io/model_registry.py``. Keys, version records and
channel pointers keep its layout byte for byte, so a registry written by
either package is served by the other.

`io.registry.DatasetRegistry` already versions *datasets* the DVC way:
content-addressed blobs plus small JSON pins written atomically by
`_LocalStore.put_bytes` (unique temp name + rename). This module applies the
same machinery to *models*:

- every publish mints an immutable versioned key ``models/<name>/v<N>``
  holding the artifact npz (plus its ``.features.json`` sidecar and a
  ``.ptr.json`` content pin so `ResilientStore` verified reads cover model
  restores too);
- an immutable *record* ``registry/models/<name>/v<N>.json`` carries the
  provenance an incident review needs: blob md5/size, dataset fingerprint,
  pipeline config hash, train metrics, parent version;
- mutable *channel pointers* ``registry/channels/<name>/{latest,canary,
  previous}.json`` name which version each channel serves. A pointer is one
  small JSON object replaced atomically, so a crashed publish or promote can
  leave a *stale* pointer but never a torn one.

Channel semantics (README "Continuous training"):

========== ==================================================================
latest     the champion — what `ScorerService.from_store` restores
canary     a candidate under shadow evaluation; never serves callers directly
previous   the demoted champion — the automatic-rollback target
========== ==================================================================

The retrain driver (`tools.retrain`) only ever publishes to ``canary``;
only `promote()` moves a version into ``latest`` (and the old champion into
``previous``), and only `rollback()` moves ``previous`` back. Callers that
need fault tolerance wrap the store in `ResilientStore` before constructing
the registry — every operation here is plain store I/O, so retries and
verified reads compose from the outside exactly as they do for datasets.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Mapping

from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore

CHANNELS = ("latest", "canary", "previous")

_VERSION_RE = re.compile(r"v(\d+)\.json$")


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One immutable published model version (the record, deserialized)."""

    name: str
    version: int
    key: str  # bare artifact key: `<Artifact>.load(store, key)` restores it
    md5: str
    size: int
    kind: str  # artifact class name, e.g. "GBDTArtifact"
    parent_version: int | None = None
    metrics: dict = dataclasses.field(default_factory=dict)
    provenance: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "ModelVersion":
        return cls(**{f.name: obj[f.name] for f in dataclasses.fields(cls)
                      if f.name in obj})


class ModelRegistry:
    """Versioned model keys + provenance records + channel pointers over any
    `ObjectStore` (wrap in `ResilientStore` for retry + verified reads)."""

    def __init__(
        self,
        store: ObjectStore,
        prefix: str = "registry",
        models_prefix: str = "models",
    ):
        self.store = store
        self.prefix = prefix.rstrip("/")
        self.models_prefix = models_prefix.rstrip("/")

    # -- key layout -----------------------------------------------------------

    def artifact_key(self, name: str, version: int) -> str:
        return f"{self.models_prefix}/{name}/v{version}"

    def _record_key(self, name: str, version: int) -> str:
        return f"{self.prefix}/models/{name}/v{version}.json"

    def _channel_key(self, name: str, channel: str) -> str:
        if channel not in CHANNELS:
            raise ValueError(f"unknown channel {channel!r}; one of {CHANNELS}")
        return f"{self.prefix}/channels/{name}/{channel}.json"

    # -- publish --------------------------------------------------------------

    def publish(
        self,
        name: str,
        artifact: Any,
        *,
        provenance: Mapping[str, Any] | None = None,
        channel: str | None = "canary",
    ) -> ModelVersion:
        """Mint the next version of ``name`` from an artifact (anything with
        ``to_bytes()`` and ``feature_names`` — `GBDTArtifact`), write its
        immutable record, and (by default) point the ``canary`` channel at
        it. Pass ``channel=None`` to publish without touching any pointer.
        The record is write-once: versions are never overwritten.

        The ``.npz`` and its ``.features.json`` sidecar are the objects
        ``artifact.save`` writes, but from ONE ``to_bytes()`` call: an
        ``.npz`` carries its zip entries' write times (2 s resolution), so
        a second serialization may differ from the bytes the record's md5
        pins."""
        latest = self.channel(name, "latest")
        version = self._next_version(name)
        key = self.artifact_key(name, version)
        record_key = self._record_key(name, version)
        if self.store.exists(record_key):  # registry invariant, not a race fix
            raise FileExistsError(f"model version already published: {record_key}")
        blob = artifact.to_bytes()
        self.store.put_bytes(key + ".npz", blob)
        self.store.put_json(key + ".features.json", list(artifact.feature_names))
        # Content pin on the npz: ResilientStore verified reads now cover
        # model restores the same way they cover dataset pulls.
        self.store.write_pointer(key + ".npz")
        mv = ModelVersion(
            name=name,
            version=version,
            key=key,
            md5=hashlib.md5(blob).hexdigest(),
            size=len(blob),
            kind=type(artifact).__name__,
            parent_version=None if latest is None else int(latest["version"]),
            metrics=dict(getattr(artifact, "metrics", {}) or {}),
            provenance=dict(provenance or {}),
        )
        self.store.put_json(record_key, mv.to_json())
        if channel is not None:
            self.set_channel(name, channel, version)
        return mv

    def _next_version(self, name: str) -> int:
        versions = self.versions(name)
        return (max(versions) + 1) if versions else 1

    # -- reads ----------------------------------------------------------------

    def names(self) -> list[str]:
        prefix = f"{self.prefix}/models/"
        seen = {k[len(prefix):].split("/", 1)[0]
                for k in self.store.list(prefix) if k.endswith(".json")}
        return sorted(seen)

    def versions(self, name: str) -> list[int]:
        out = []
        for k in self.store.list(f"{self.prefix}/models/{name}/"):
            m = _VERSION_RE.search(k)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def record(self, name: str, version: int) -> ModelVersion:
        return ModelVersion.from_json(
            self.store.get_json(self._record_key(name, version))
        )

    def channel(self, name: str, channel: str) -> dict | None:
        """The channel pointer record, or None when the channel is unset."""
        key = self._channel_key(name, channel)
        if not self.store.exists(key):
            return None
        return self.store.get_json(key)

    def resolve(self, name: str, channel: str) -> str | None:
        """Channel -> the bare artifact key `reload_from_store` accepts."""
        ptr = self.channel(name, channel)
        return None if ptr is None else ptr["key"]

    def channel_record(self, name: str, channel: str) -> ModelVersion | None:
        """Channel pointer -> the full immutable version record, provenance
        included — what batch consumers (a portfolio scorer) stamp into
        their reports. None when the channel is unset."""
        ptr = self.channel(name, channel)
        if ptr is None:
            return None
        return self.record(name, int(ptr["version"]))

    def verify(self, name: str, version: int) -> bool:
        """Does the stored npz still hash to the record's md5?"""
        mv = self.record(name, version)
        blob = self.store.get_bytes(mv.key + ".npz")
        return hashlib.md5(blob).hexdigest() == mv.md5 and len(blob) == mv.size

    # -- channel pointer writes (each one atomic) -----------------------------

    def set_channel(
        self,
        name: str,
        channel: str,
        version: int,
        extra: Mapping[str, Any] | None = None,
    ) -> dict:
        """Point ``channel`` at ``version`` — one atomic JSON replace. The
        version's record must already exist: a pointer may be stale after a
        crash, never dangling by construction."""
        record_key = self._record_key(name, version)
        if not self.store.exists(record_key):
            raise FileNotFoundError(f"no such model version: {record_key}")
        mv = self.record(name, version)
        ptr = {
            "name": name,
            "channel": channel,
            "version": version,
            "key": mv.key,
            "md5": mv.md5,
            **dict(extra or {}),
        }
        self.store.put_json(self._channel_key(name, channel), ptr)
        return ptr

    def clear_channel(self, name: str, channel: str) -> None:
        self.store.delete(self._channel_key(name, channel))

    def promote(self, name: str) -> dict:
        """Flip ``canary`` into ``latest`` (old ``latest`` -> ``previous``).

        Three single-pointer writes, each atomic, ordered so any crash point
        leaves a servable state: ``previous`` first (worst case: updated
        ``previous``, unchanged ``latest``), then ``latest``, then the
        ``canary`` pointer is cleared (worst case: promoted ``latest`` with a
        stale canary pointer — re-promoting is a no-op flip to the same
        version, never a tear)."""
        canary = self.channel(name, "canary")
        if canary is None:
            raise LookupError(f"no canary published for model {name!r}")
        latest = self.channel(name, "latest")
        if latest is not None:
            self.set_channel(name, "previous", int(latest["version"]))
        self.set_channel(name, "latest", int(canary["version"]))
        self.clear_channel(name, "canary")
        return {
            "name": name,
            "promoted_version": int(canary["version"]),
            "previous_version": None if latest is None else int(latest["version"]),
            "key": canary["key"],
        }

    def rollback(self, name: str, *, reason: str | None = None) -> dict:
        """Demote ``latest`` back to ``previous`` (the automatic-rollback
        path). The demoted champion becomes the new ``previous`` so forensics
        can still restore it deliberately."""
        prev = self.channel(name, "previous")
        if prev is None:
            raise LookupError(f"no previous version to roll back to for {name!r}")
        latest = self.channel(name, "latest")
        demoted = None if latest is None else int(latest["version"])
        self.set_channel(
            name, "latest", int(prev["version"]),
            extra={"rolled_back_from": demoted, "reason": reason or "manual"},
        )
        if demoted is not None:
            self.set_channel(name, "previous", demoted)
        return {
            "name": name,
            "restored_version": int(prev["version"]),
            "demoted_version": demoted,
            "reason": reason or "manual",
            "key": prev["key"],
        }

    # -- garbage collection ---------------------------------------------------

    def gc(self, *, keep_last: int = 2, dry_run: bool = True) -> dict:
        """Sweep versions unreachable from any channel pointer, keeping the
        newest ``keep_last`` per model regardless. Deletes the record, the
        artifact npz, its content pin, and the features sidecar. With
        ``dry_run`` (the default) nothing is deleted — the report shows what
        an ``--apply`` run would remove (`tools.registry_gc`)."""
        report: dict[str, dict] = {}
        for name in self.names():
            versions = self.versions(name)
            pinned = {
                int(ptr["version"])
                for ch in CHANNELS
                if (ptr := self.channel(name, ch)) is not None
            }
            keep = pinned | set(versions[-keep_last:] if keep_last > 0 else [])
            doomed = [v for v in versions if v not in keep]
            if not dry_run:
                for v in doomed:
                    key = self.artifact_key(name, v)
                    for obj in (
                        self._record_key(name, v),
                        key + ".npz",
                        key + ".npz.ptr.json",
                        key + ".features.json",
                    ):
                        self.store.delete(obj)
            report[name] = {"kept": sorted(keep & set(versions)),
                            "deleted": doomed}
        return {"dry_run": dry_run, "keep_last": keep_last, "models": report}


__all__ = ["CHANNELS", "ModelRegistry", "ModelVersion"]
