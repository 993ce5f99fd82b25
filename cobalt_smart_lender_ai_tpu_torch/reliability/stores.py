"""`ResilientStore` — retrying, read-verifying wrapper over any `ObjectStore`:
the port's copy of the reference's ``reliability/stores.py``.

Every pipeline/serving store access funnels through the five byte-blob
primitives, so wrapping those five with `call_with_retry` makes the whole
I/O surface (frames, artifacts, metrics, manifests — the conveniences are
inherited and compose over the wrapped primitives) survive transient
backend failures. Reads additionally verify against the content-addressed
``<key>.ptr.json`` pointer when one exists: a corrupted read raises
`CorruptObjectError`, which the retry policy treats as transient (a re-read
can return clean bytes), so corruption is healed when it is transient and
surfaced when it is not.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Callable, Iterator

from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability.retry import RetryPolicy, call_with_retry


class CorruptObjectError(RuntimeError):
    """Read bytes do not match the object's content-addressed pointer."""


class ResilientStore(ObjectStore):
    """Retry + verify wrapper; same `ObjectStore` contract as the backend it
    wraps. ``retries`` counts backoff sleeps actually taken — observable so
    fault-injection tests assert recovery happened *via retries* rather than
    by luck.
    """

    def __new__(cls, *args, **kwargs):  # bypass ObjectStore's URI dispatch
        return object.__new__(cls)

    def __init__(
        self,
        inner: ObjectStore,
        policy: RetryPolicy | None = None,
        *,
        verify_reads: bool = True,
        sleep: Callable[[float], None] = time.sleep,
        monotonic: Callable[[], float] = time.monotonic,
        rng: random.Random | None = None,
    ):
        self.inner = inner
        self.uri = inner.uri
        self.policy = policy or RetryPolicy()
        self.verify_reads = verify_reads
        self._sleep = sleep
        self._monotonic = monotonic
        self._rng = rng or random.Random(0)
        self.retries = 0

    def _call(self, fn):
        def count(_attempt, _exc):
            self.retries += 1

        return call_with_retry(
            fn,
            self.policy,
            sleep=self._sleep,
            monotonic=self._monotonic,
            rng=self._rng,
            on_retry=count,
        )

    # -- byte-blob contract, each primitive retried as a unit -----------------
    def put_bytes(self, key: str, data: bytes) -> None:
        self._call(lambda: self.inner.put_bytes(key, data))

    def get_bytes(self, key: str) -> bytes:
        return self._call(lambda: self._verified_get(key))

    def exists(self, key: str) -> bool:
        return self._call(lambda: self.inner.exists(key))

    def delete(self, key: str) -> None:
        self._call(lambda: self.inner.delete(key))

    def list(self, prefix: str = "") -> Iterator[str]:
        # Materialize inside the retried attempt: a generator that dies
        # mid-iteration cannot be resumed, a list can be re-fetched whole.
        return iter(self._call(lambda: list(self.inner.list(prefix))))

    # -- read verification ----------------------------------------------------
    def _verified_get(self, key: str) -> bytes:
        # Each backend call carries its own retry budget (three calls inside
        # one retried unit would compound per-call failure odds); the outer
        # `_call` in `get_bytes` then re-runs the whole read when the bytes
        # fail verification.
        data = self._call(lambda: self.inner.get_bytes(key))
        if not self.verify_reads or key.endswith(PTR_SUFFIX):
            return data
        ptr_key = key + PTR_SUFFIX
        if not self._call(lambda: self.inner.exists(ptr_key)):
            return data  # unpinned object: nothing to verify against
        try:
            ptr = json.loads(self._call(lambda: self.inner.get_bytes(ptr_key)).decode())
        except (ValueError, UnicodeDecodeError) as exc:
            # A corrupted pointer blob is as transient as a corrupted object:
            # re-read rather than dying on the JSON parse.
            raise CorruptObjectError(f"pointer for {key!r} unreadable: {exc}")
        if (
            hashlib.md5(data).hexdigest() != ptr.get("md5")
            or len(data) != ptr.get("size")
        ):
            raise CorruptObjectError(
                f"object {key!r} does not match its content pointer "
                f"(got {len(data)} bytes, pinned {ptr.get('size')})"
            )
        return data
