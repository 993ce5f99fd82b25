"""Pipeline stage manifests, for `run_pipeline`'s checkpoints and resume: the
port's copy of the reference's ``reliability/checkpoint.py``, whose
manifests it writes byte for byte.

After each stage the pipeline writes ``<prefix><stage>.json`` to the object
store: the stage's output keys with md5+size pointers, a fingerprint of the
config slice the stage depends on, and a small ``extra`` payload for stages
whose result is data rather than store objects (RFE's selected features,
the search's best params). On ``--resume`` a stage is skipped iff its
manifest exists, the fingerprint still matches, and every output object's
bytes still hash to the pinned md5 — so a crash mid-RFE or mid-search
restarts from the last good stage instead of from raw data, and a config
change invalidates exactly the stages that depend on it.

Manifest format (``"format": 1``)::

    {
      "format": 1,
      "stage": "engineer",
      "fingerprint": "9f3a...",
      "outputs": ["dataset/2-intermediate/cleaned_02_tree.csv", ...],
      "pointers": {"<key>": {"key": ..., "md5": ..., "size": ...}, ...},
      "extra": {...},
      "progress": {...}          # optional: partial-stage position
    }

Whole-stage manifests (the pipeline) never emit ``progress``; long streaming
stages (the portfolio scorer) call `advance` after every chunk so a kill can
resume mid-stage — the payload carries whatever position the owner needs
(chunk index, rows done, content fingerprint). Manifests written before this
field existed load unchanged: ``progress`` is simply absent and `progress()`
returns None.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from typing import Any, Mapping, Sequence

from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore

logger = logging.getLogger(__name__)

MANIFEST_FORMAT = 1


def config_fingerprint(*parts: Any) -> str:
    """Stable hex digest of config dataclasses / plain JSON-able values.

    Dataclasses are flattened with `dataclasses.asdict`; anything JSON can't
    serialize falls back to ``str`` — the goal is change *detection*, not a
    canonical encoding."""
    norm = [
        dataclasses.asdict(p) if dataclasses.is_dataclass(p) else p for p in parts
    ]
    payload = json.dumps(norm, sort_keys=True, default=str).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


class PipelineCheckpoint:
    """Read/write/validate per-stage manifests in an object store."""

    def __init__(self, store: ObjectStore, prefix: str = "checkpoints/"):
        self.store = store
        self.prefix = prefix

    def manifest_key(self, stage: str) -> str:
        return f"{self.prefix}{stage}.json"

    def write(
        self,
        stage: str,
        *,
        fingerprint: str,
        outputs: Sequence[str] = (),
        extra: Mapping[str, Any] | None = None,
        progress: Mapping[str, Any] | None = None,
    ) -> dict:
        """Pin each output's current content (also writing its
        ``<key>.ptr.json`` so `ResilientStore` verifies later reads) and
        persist the stage manifest. ``progress`` (optional) marks a
        partially complete stage; when None the key is omitted entirely so
        whole-stage manifests stay byte-identical to format-1 files written
        before the field existed."""
        pointers = {key: self.store.write_pointer(key) for key in outputs}
        manifest = {
            "format": MANIFEST_FORMAT,
            "stage": stage,
            "fingerprint": fingerprint,
            "outputs": list(outputs),
            "pointers": pointers,
            "extra": dict(extra or {}),
        }
        if progress is not None:
            manifest["progress"] = dict(progress)
        self.store.put_json(self.manifest_key(stage), manifest)
        return manifest

    def advance(
        self,
        stage: str,
        *,
        fingerprint: str,
        new_outputs: Sequence[str] = (),
        progress: Mapping[str, Any] | None = None,
        extra: Mapping[str, Any] | None = None,
    ) -> dict:
        """Append partial progress to a stage without re-pinning history.

        Loads the existing manifest (when its fingerprint still matches —
        a config change discards stale progress and starts over), pins only
        ``new_outputs``, and replaces the ``progress`` payload. A streaming
        stage calling this after every chunk pays O(chunk) per call instead
        of `write`'s O(all outputs so far) re-hash."""
        manifest = self.load(stage)
        if manifest is None or manifest.get("fingerprint") != fingerprint:
            manifest = {
                "format": MANIFEST_FORMAT,
                "stage": stage,
                "fingerprint": fingerprint,
                "outputs": [],
                "pointers": {},
                "extra": dict(extra or {}),
            }
        elif extra is not None:
            manifest["extra"] = dict(extra)
        for key in new_outputs:
            manifest["pointers"][key] = self.store.write_pointer(key)
            if key not in manifest["outputs"]:
                manifest["outputs"].append(key)
        if progress is not None:
            manifest["progress"] = dict(progress)
        self.store.put_json(self.manifest_key(stage), manifest)
        return manifest

    def progress(
        self, stage: str, fingerprint: str | None = None
    ) -> dict | None:
        """The stage's partial-progress payload, or None when the stage has
        none (including every pre-progress manifest). With ``fingerprint``,
        progress recorded under a different config reads as None — resuming
        code treats it exactly like a fresh start."""
        manifest = self.load(stage)
        if manifest is None:
            return None
        if (
            fingerprint is not None
            and manifest.get("fingerprint") != fingerprint
        ):
            return None
        progress = manifest.get("progress")
        return dict(progress) if isinstance(progress, dict) else None

    def load(self, stage: str) -> dict | None:
        """The stage's manifest, or None when missing/unreadable/foreign."""
        try:
            manifest = self.store.get_json(self.manifest_key(stage))
        except Exception:
            return None
        if (
            not isinstance(manifest, dict)
            or manifest.get("format") != MANIFEST_FORMAT
        ):
            return None
        return manifest

    def valid(self, stage: str, fingerprint: str) -> bool:
        """True iff the stage can be skipped: manifest present, config slice
        unchanged, and every pinned output still hashes to its manifest md5
        (checked against the manifest itself, not the mutable ``.ptr.json``,
        so a rewritten pointer cannot launder drifted bytes)."""
        manifest = self.load(stage)
        if manifest is None or manifest.get("fingerprint") != fingerprint:
            return False
        for key in manifest.get("outputs", []):
            ptr = manifest.get("pointers", {}).get(key)
            if not ptr:
                return False
            try:
                data = self.store.get_bytes(key)
            except Exception:
                return False
            if (
                hashlib.md5(data).hexdigest() != ptr.get("md5")
                or len(data) != ptr.get("size")
            ):
                logger.info("checkpoint %s: output %s drifted", stage, key)
                return False
        return True

    def invalidate(self, stage: str) -> None:
        self.store.delete(self.manifest_key(stage))
