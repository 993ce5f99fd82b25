"""The port's stage checkpoints and retrying store against the JAX package's,
on the CPU.

- `config_fingerprint` equals the reference's for the same plain values.
- Manifests written by both packages' `PipelineCheckpoint` against one
  store directory are byte-equal (the manifest and each output's
  ``.ptr.json``), each package's `valid` accepts the other's manifest, and
  both reject it after one byte of an output is flipped, or under another
  fingerprint; `invalidate` removes it for both.
- `call_with_retry` sleeps the reference's backoff schedule on a fake clock
  (jitter from the same seeded generator), stops at the deadline and never
  retries a missing object; `ResilientStore` retries transient faults
  (counted in ``retries``), heals a transient corrupt read against the
  content pointer and raises `CorruptObjectError` on persistent corruption,
  as ``tests/test_reliability.py`` holds the reference's.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.reliability import PipelineCheckpoint as JaxCheckpoint
from cobalt_smart_lender_ai_tpu.reliability import RetryPolicy as JaxRetryPolicy
from cobalt_smart_lender_ai_tpu.reliability import call_with_retry as jax_call_with_retry
from cobalt_smart_lender_ai_tpu.reliability import config_fingerprint as jax_fingerprint
from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability import (
    MANIFEST_FORMAT,
    CorruptObjectError,
    PipelineCheckpoint,
    ResilientStore,
    RetryPolicy,
    call_with_retry,
    config_fingerprint,
    is_transient_store_error,
    policy_from_config,
)


@dataclasses.dataclass(frozen=True)
class _Slice:
    n: int = 3
    name: str = "x"
    ratio: float | None = 0.5


PLAIN_VALUES = [
    ("clean", {"raw_key": "dataset/1-raw/raw.csv", "test_fraction": 0.2, "split_seed": 22}),
    ("rfe", {"n_select": 20, "step": 1}, {"k": [1, 2, 3], "none": None, "nested": {"b": 1, "a": 2}}),
    ("search", 1, 2.5, "s", None, True, [0.01, 0.05], (3, 5)),
    ("dc", _Slice(), _Slice(n=4, ratio=None)),
]


@pytest.mark.parametrize("parts", PLAIN_VALUES, ids=lambda p: p[0])
def test_config_fingerprint_matches_jax(parts):
    assert config_fingerprint(*parts) == jax_fingerprint(*parts)
    assert len(config_fingerprint(*parts)) == 16
    assert config_fingerprint(*parts) != config_fingerprint(*parts, "more")


def _write(ckpt, store, fp):
    return ckpt.write(
        "engineer",
        fingerprint=fp,
        outputs=["dataset/tree.csv", "dataset/nn.csv"],
        extra={"plan": {"asof": "2026-08-01", "medians": {"a": 0.5}}, "n": 3},
    )


def test_manifests_are_byte_equal_and_validate_across_packages(tmp_path):
    port, ref = ObjectStore(str(tmp_path)), JaxStore(str(tmp_path))
    port.put_bytes("dataset/tree.csv", b"a,b\n1,2\n")
    port.put_bytes("dataset/nn.csv", b"a\n0.5\n")
    fp = config_fingerprint("engineer", {"k": 1})
    pc, jc = PipelineCheckpoint(port), JaxCheckpoint(ref)
    keys = ["checkpoints/engineer.json", "dataset/tree.csv.ptr.json", "dataset/nn.csv.ptr.json"]

    assert _write(pc, port, fp) == _write(jc, ref, fp) == pc.load("engineer")
    by_ref = {k: port.get_bytes(k) for k in keys}
    _write(pc, port, fp)
    assert {k: port.get_bytes(k) for k in keys} == by_ref
    assert pc.load("engineer")["format"] == MANIFEST_FORMAT == 1

    assert pc.valid("engineer", fp) and jc.valid("engineer", fp)
    other = config_fingerprint("engineer", {"k": 2})
    assert not pc.valid("engineer", other) and not jc.valid("engineer", other)
    data = bytearray(port.get_bytes("dataset/nn.csv"))
    data[2] ^= 1
    port.put_bytes("dataset/nn.csv", bytes(data))
    assert not pc.valid("engineer", fp) and not jc.valid("engineer", fp)
    pc.invalidate("engineer")
    assert pc.load("engineer") is None and jc.load("engineer") is None


def test_progress_and_advance_match_jax(tmp_path):
    port, ref = ObjectStore(str(tmp_path / "p")), JaxStore(str(tmp_path / "j"))
    for s in (port, ref):
        s.put_bytes("chunk/0.npy", b"zero")
        s.put_bytes("chunk/1.npy", b"one")
    fp = config_fingerprint("score", {"rows": 10})
    for ck, s in ((PipelineCheckpoint(port), port), (JaxCheckpoint(ref), ref)):
        ck.advance("score", fingerprint=fp, new_outputs=["chunk/0.npy"], progress={"chunk": 0})
        ck.advance("score", fingerprint=fp, new_outputs=["chunk/1.npy"], progress={"chunk": 1})
    assert port.get_bytes("checkpoints/score.json") == ref.get_bytes("checkpoints/score.json")
    assert PipelineCheckpoint(port).progress("score", fp) == {"chunk": 1}
    assert PipelineCheckpoint(port).progress("score", "stale") is None


class FakeClock:
    """sleep advances monotonic."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.now += s

    def monotonic(self) -> float:
        return self.now


def _flaky(n_fail: int, exc=ConnectionError):
    state = {"calls": 0}

    def fn():
        state["calls"] += 1
        if state["calls"] <= n_fail:
            raise exc("down")
        return "ok"

    return fn, state


@pytest.mark.parametrize("jitter", [0.0, 0.1, 0.5])
def test_backoff_schedule_matches_jax(jitter):
    kw = dict(max_attempts=6, base_delay_s=0.5, max_delay_s=3.0, multiplier=2.0, jitter=jitter)
    schedules = []
    for policy, call in ((RetryPolicy(**kw), call_with_retry), (JaxRetryPolicy(**kw), jax_call_with_retry)):
        clock = FakeClock()
        fn, state = _flaky(10)
        with pytest.raises(ConnectionError):
            call(fn, policy, sleep=clock.sleep, monotonic=clock.monotonic, rng=random.Random(7))
        assert state["calls"] == 6
        schedules.append(clock.sleeps)
    assert schedules[0] == schedules[1]
    if jitter == 0.0:
        assert schedules[0] == [0.5, 1.0, 2.0, 3.0, 3.0]


def test_retry_stops_at_the_deadline_and_skips_deterministic_failures():
    clock = FakeClock()
    fn, state = _flaky(10)
    policy = RetryPolicy(max_attempts=10, base_delay_s=1.0, jitter=0.0, deadline_s=2.5)
    with pytest.raises(ConnectionError):
        call_with_retry(fn, policy, sleep=clock.sleep, monotonic=clock.monotonic)
    assert clock.sleeps == [1.0] and state["calls"] == 2  # a 2 s sleep would pass 2.5 s
    fn, state = _flaky(10, FileNotFoundError)
    with pytest.raises(FileNotFoundError):
        call_with_retry(fn, policy, sleep=clock.sleep, monotonic=clock.monotonic)
    assert state["calls"] == 1
    assert is_transient_store_error(TimeoutError()) and is_transient_store_error(CorruptObjectError())
    assert not is_transient_store_error(PermissionError()) and not is_transient_store_error(ValueError())
    rel = ReliabilityConfig(max_attempts=7, base_delay_s=0.2, backoff_multiplier=3.0, deadline_s=9.0)
    p = policy_from_config(rel)
    assert (p.max_attempts, p.base_delay_s, p.multiplier, p.deadline_s) == (7, 0.2, 3.0, 9.0)


class _FlakyStore(ObjectStore):
    """Fails the first ``n_fail`` reads of each key with a dropped
    connection, and returns flipped bytes on the first ``n_corrupt``."""

    def __init__(self, root, n_fail=0, n_corrupt=0):
        super().__init__(root)
        self.n_fail, self.n_corrupt = n_fail, n_corrupt
        self.reads: dict[str, int] = {}

    def get_bytes(self, key):
        i = self.reads[key] = self.reads.get(key, 0) + 1
        data = super().get_bytes(key)
        if key.endswith(".ptr.json"):
            return data
        if i <= self.n_fail:
            raise ConnectionError("connection reset")
        if i <= self.n_fail + self.n_corrupt:
            return bytes([data[0] ^ 1]) + data[1:]
        return data


def test_resilient_store_retries_on_a_fake_clock(tmp_path):
    clock = FakeClock()
    inner = _FlakyStore(str(tmp_path), n_fail=2)
    store = ResilientStore(
        inner, RetryPolicy(max_attempts=4, base_delay_s=0.1, jitter=0.0),
        sleep=clock.sleep, monotonic=clock.monotonic,
    )
    store.put_bytes("obj", b"payload")
    assert store.get_bytes("obj") == b"payload"
    assert store.retries == 2 and clock.sleeps == [0.1, 0.2]
    with pytest.raises(FileNotFoundError):
        store.get_bytes("missing")
    assert store.retries == 2 and inner.reads["missing"] == 1


def test_resilient_store_verifies_reads_against_pointers(tmp_path):
    inner = _FlakyStore(str(tmp_path), n_corrupt=2)
    inner.put_bytes("data.bin", b"payload")
    ObjectStore(str(tmp_path)).write_pointer("data.bin")
    clock = FakeClock()
    store = ResilientStore(
        inner, RetryPolicy(max_attempts=6, base_delay_s=0.0, jitter=0.0),
        sleep=clock.sleep, monotonic=clock.monotonic,
    )
    assert store.get_bytes("data.bin") == b"payload"  # two corrupt reads, then clean
    assert store.retries == 2
    inner.put_bytes("data.bin", b"tampered")  # rewritten without a new pointer
    with pytest.raises(CorruptObjectError):
        store.get_bytes("data.bin")
    assert ResilientStore(inner, verify_reads=False).get_bytes("data.bin") == b"tampered"
    store = ResilientStore(ObjectStore(str(tmp_path)))
    store.put_json("m.json", {"a": 1})  # the conveniences compose over the primitives
    assert store.get_json("m.json") == {"a": 1} and store.exists("m.json")
    assert "m.json" in list(store.list("")) and store.uri == inner.uri
    store.delete("m.json")
    assert not store.exists("m.json")
