"""The kernel-build cache (`compilecache`) against the reference's compile cache.

The port's counterpart of XLA's persistent compile cache is its build cache:
the nvcc libraries (`ops._build`) and the g++ CSV reader (`native`). Here the
reader's real g++ build runs in fresh processes over a ``tmp_path`` cache
directory: the first process misses and compiles once, the second hits,
compiles nothing and counts the first build's seconds as saved;
``COBALT_COMPILE_CACHE=0`` compiles in every process; an unwritable
directory falls back to a private one (None) and still builds; a build under
``COBALT_COMPILE_CACHE_MIN_SECS`` is not kept; a library that another
compiler built is not a hit (the key covers the compiler's identity). `compile_stats` has the
reference's keys, `bootstrap_compile_cache` its precedence and idempotence,
and the run ledger's ``compile`` block carries both key sets.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cobalt_smart_lender_ai_tpu_torch import compilecache, native
from cobalt_smart_lender_ai_tpu_torch.config import CompileCacheConfig, PipelineConfig
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry, RunLedger

ROOT = Path(__file__).resolve().parent.parent
REF_KEYS = ("backend_compiles", "backend_compile_seconds", "cache_hits", "cache_misses",
            "cache_saved_seconds")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="the reader's build needs g++")

_PROBE = """
import json, sys
from cobalt_smart_lender_ai_tpu_torch import native
from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache, compile_stats
from cobalt_smart_lender_ai_tpu_torch.config import CompileCacheConfig
cache = bootstrap_compile_cache(CompileCacheConfig(cache_dir=sys.argv[1]))
ok = native.native_available()
print(json.dumps({"cache": cache, "ok": ok, "library": str(native._build()), **compile_stats()}))
"""


_FAKE_GXX = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "g++ (another toolchain) 0.0"; exit 0; fi
exec {gxx} "$@"
"""


def _probe(cache_dir, **env) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(cache_dir)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, **env},
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@needs_gxx
def test_second_process_hits_and_compiles_nothing(tmp_path):
    cache = tmp_path / "cache"
    first = _probe(cache)
    assert first["cache"] == str(cache) and first["ok"]
    assert (first["cache_misses"], first["backend_compiles"], first["cache_hits"]) == (1, 1, 0)
    assert first["backend_compile_seconds"] > 0 and first["cache_saved_seconds"] == 0
    library = Path(first["library"])
    assert library.parent == cache and library.exists()
    assert _build.recorded_seconds(library) == pytest.approx(first["backend_compile_seconds"])
    second = _probe(cache)
    assert (second["cache_misses"], second["backend_compiles"], second["cache_hits"]) == (0, 0, 1)
    assert second["backend_compile_seconds"] == 0
    assert second["cache_saved_seconds"] == pytest.approx(first["backend_compile_seconds"])
    assert second["library"] == first["library"]


@needs_gxx
def test_another_compilers_library_is_rebuilt(tmp_path):
    """A library planted in the cache by another g++ (a wrapper that reports
    another ``--version``) is a miss for this g++, which builds its own; the
    planted one stays a hit for its own compiler."""
    cache, fake = tmp_path / "cache", tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text(_FAKE_GXX.format(gxx=shutil.which("g++")))
    (fake / "g++").chmod(0o755)
    other_path = f"{fake}{os.pathsep}{os.environ['PATH']}"
    planted = _probe(cache, PATH=other_path)
    assert (planted["cache_misses"], planted["backend_compiles"], planted["cache_hits"]) == (1, 1, 0)
    ours = _probe(cache)
    assert ours["ok"] and ours["library"] != planted["library"]
    assert (ours["cache_misses"], ours["backend_compiles"], ours["cache_hits"]) == (1, 1, 0)
    again = _probe(cache, PATH=other_path)
    assert (again["cache_misses"], again["backend_compiles"], again["cache_hits"]) == (0, 0, 1)
    assert again["library"] == planted["library"]
    assert len(list(cache.glob("csv_reader-*.so"))) == 2


def test_kernel_keys_cover_nvccs_identity(monkeypatch):
    key = _build.library_path("score_forest")
    monkeypatch.setattr(_build, "compiler_identity", lambda compiler: "nvcc 0.0 (another toolkit)")
    other = _build.library_path("score_forest")
    assert other.parent == key.parent and other.name != key.name
    assert other.name.startswith("score_forest-") and other.suffix == ".so"


@needs_gxx
@pytest.mark.parametrize("value", ["0", "off"])
def test_disabled_cache_compiles_in_every_process(tmp_path, value):
    cache = tmp_path / "cache"
    runs = [_probe(cache, COBALT_COMPILE_CACHE=value) for _ in range(2)]
    for run in runs:
        assert run["cache"] is None and run["ok"]
        assert (run["cache_misses"], run["backend_compiles"], run["cache_hits"]) == (1, 1, 0)
        assert not Path(run["library"]).is_relative_to(cache)
    assert runs[0]["library"] != runs[1]["library"]  # each process its own directory
    assert not cache.exists() or not any(cache.iterdir())


@needs_gxx
def test_unwritable_directory_falls_back_and_still_builds(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    run = _probe(blocker / "cache")
    assert run["cache"] is None and run["ok"]
    assert (run["cache_misses"], run["backend_compiles"]) == (1, 1)
    assert not Path(run["library"]).is_relative_to(tmp_path)


@needs_gxx
def test_builds_under_the_threshold_are_not_kept(tmp_path):
    cache = tmp_path / "cache"
    runs = [_probe(cache, COBALT_COMPILE_CACHE_MIN_SECS="3600") for _ in range(2)]
    for run in runs:
        assert run["cache"] == str(cache) and run["ok"]
        assert (run["cache_misses"], run["backend_compiles"], run["cache_hits"]) == (1, 1, 0)
        assert not Path(run["library"]).is_relative_to(cache)
    assert not list(cache.glob("*.so"))


def test_compile_stats_has_the_reference_keys():
    from cobalt_smart_lender_ai_tpu.compilecache import compile_stats as ref_stats

    assert tuple(compilecache.compile_stats()) == tuple(ref_stats()) == REF_KEYS


def test_config_has_the_reference_fields_and_the_ports_threshold():
    from cobalt_smart_lender_ai_tpu.config import CompileCacheConfig as RefConfig
    from cobalt_smart_lender_ai_tpu.config import PipelineConfig as RefPipeline

    names = [f.name for f in CompileCacheConfig.__dataclass_fields__.values()]
    assert names == [f.name for f in RefConfig.__dataclass_fields__.values()]
    assert CompileCacheConfig().enabled and CompileCacheConfig().cache_dir is None
    assert CompileCacheConfig().min_compile_time_secs == 0.0  # the reference's 5 s would rebuild g++
    assert isinstance(PipelineConfig().compile_cache, CompileCacheConfig)
    assert isinstance(RefPipeline().compile_cache, RefConfig)


@pytest.fixture
def fresh_bootstrap(monkeypatch):
    """A process that has not bootstrapped yet; every global is restored."""
    monkeypatch.setattr(compilecache, "_bootstrap_done", False)
    monkeypatch.setattr(compilecache, "_bootstrapped", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "min_cache_seconds", _build.min_cache_seconds)
    monkeypatch.delenv("COBALT_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("COBALT_COMPILE_CACHE_MIN_SECS", raising=False)
    return monkeypatch


def test_default_keeps_the_package_build_directory(fresh_bootstrap):
    assert compilecache.bootstrap_compile_cache() == str(_build.PACKAGE_BUILD_DIR)
    assert _build.BUILD_DIR == _build.PACKAGE_BUILD_DIR
    assert _build.library_path("score_forest").parent == _build.PACKAGE_BUILD_DIR
    assert native.library_path().parent == _build.PACKAGE_BUILD_DIR


def test_bootstrap_is_idempotent_first_call_wins(fresh_bootstrap, tmp_path):
    first = compilecache.bootstrap_compile_cache(
        CompileCacheConfig(cache_dir=str(tmp_path / "a"), min_compile_time_secs=2.5)
    )
    assert first == str(tmp_path / "a")
    assert compilecache.bootstrap_compile_cache(CompileCacheConfig(cache_dir=str(tmp_path / "b"))) == first
    assert compilecache.bootstrap_compile_cache(CompileCacheConfig(enabled=False)) == first
    assert _build.BUILD_DIR == native.library_path().parent == tmp_path / "a"
    assert _build.min_cache_seconds == 2.5 and not (tmp_path / "b").exists()


@pytest.mark.parametrize("value", ["0", "false", "OFF", " no "])
def test_env_disable_beats_the_config(fresh_bootstrap, tmp_path, value):
    fresh_bootstrap.setenv("COBALT_COMPILE_CACHE", value)
    assert compilecache.bootstrap_compile_cache(CompileCacheConfig(cache_dir=str(tmp_path / "a"))) is None
    assert _build.BUILD_DIR == native.library_path().parent == _build.private_dir()
    assert not (tmp_path / "a").exists()


def test_config_disable_and_env_threshold(fresh_bootstrap, tmp_path):
    assert compilecache.bootstrap_compile_cache(CompileCacheConfig(enabled=False)) is None
    assert _build.BUILD_DIR == _build.private_dir()
    fresh_bootstrap.setattr(compilecache, "_bootstrap_done", False)
    fresh_bootstrap.setenv("COBALT_COMPILE_CACHE_MIN_SECS", "7.5")
    cfg = CompileCacheConfig(cache_dir=str(tmp_path), min_compile_time_secs=1.0)
    assert compilecache.bootstrap_compile_cache(cfg) == str(tmp_path)
    assert _build.min_cache_seconds == 7.5
    fresh_bootstrap.setattr(compilecache, "_bootstrap_done", False)
    fresh_bootstrap.setenv("COBALT_COMPILE_CACHE_MIN_SECS", "not a number")
    compilecache.bootstrap_compile_cache(cfg)
    assert _build.min_cache_seconds == 1.0


def test_reference_bootstrap_has_the_same_precedence(monkeypatch, tmp_path):
    """The reference's env and config rules, which the port's tests above
    hold the port to, on the reference's own bootstrap."""
    from cobalt_smart_lender_ai_tpu import compilecache as ref
    from cobalt_smart_lender_ai_tpu.config import CompileCacheConfig as RefConfig

    monkeypatch.setattr(ref, "_bootstrap_done", False)
    monkeypatch.setattr(ref, "_bootstrapped", None)
    monkeypatch.setenv("COBALT_COMPILE_CACHE", "off")
    assert ref.bootstrap_compile_cache(RefConfig(cache_dir=str(tmp_path))) is None
    assert ref.bootstrap_compile_cache(RefConfig(cache_dir=str(tmp_path))) is None  # idempotent
    monkeypatch.setattr(ref, "_bootstrap_done", False)
    monkeypatch.delenv("COBALT_COMPILE_CACHE")
    assert ref.bootstrap_compile_cache(RefConfig(enabled=False)) is None


def test_resolutions_reach_the_counters_once_a_process(monkeypatch, tmp_path):
    compilecache.install_compile_telemetry()
    registry = MetricsRegistry()
    monkeypatch.setattr(compilecache, "default_registry", lambda: registry)
    monkeypatch.setattr(_build, "_RESOLVED", {})
    built = []

    def compile_to(tmp: Path) -> None:
        built.append(tmp)
        tmp.write_bytes(b"library")

    out = tmp_path / "lib-0123.so"
    assert _build.resolve_library("demo", out, compile_to) == out
    assert _build.resolve_library("demo", out, compile_to) == out  # memoized: no second report
    stats = compilecache.compile_stats()
    assert (stats["cache_misses"], stats["backend_compiles"], stats["cache_hits"]) == (1, 1, 0)
    assert len(built) == 1 and out.read_bytes() == b"library"
    monkeypatch.setattr(_build, "_RESOLVED", {})  # a new process
    _build.resolve_library("demo", out, compile_to)
    stats = compilecache.compile_stats()
    assert (stats["cache_misses"], stats["backend_compiles"], stats["cache_hits"]) == (1, 1, 1)
    assert stats["cache_saved_seconds"] == pytest.approx(_build.recorded_seconds(out))


def test_build_stats_count_the_kernels_among_the_same_resolutions(monkeypatch, tmp_path):
    """`build_stats` reads the seconds `resolve_library` measured, the same
    resolutions the counters see: the nvcc kernels only, not the reader."""
    compilecache.install_compile_telemetry()
    registry = MetricsRegistry()
    monkeypatch.setattr(compilecache, "default_registry", lambda: registry)
    monkeypatch.setattr(_build, "_RESOLVED", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    for name in ("score_forest", "csv_reader"):
        _build.resolve_library(name, tmp_path / f"{name}.so", lambda tmp: tmp.write_bytes(b"lib"))
    stats, built = compilecache.compile_stats(), _build.build_stats()
    assert stats["backend_compiles"] == 2 and built["kernel_builds"] == 1
    assert built["kernel_build_seconds"] == round(_build.build_seconds["score_forest"], 6)
    assert stats["backend_compile_seconds"] == pytest.approx(sum(_build.build_seconds.values()))
    assert _build.recorded_seconds(tmp_path / "score_forest.so") == _build.build_seconds["score_forest"]


def test_failed_build_leaves_no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_RESOLVED", {})

    def broken(tmp: Path) -> None:
        tmp.write_bytes(b"half")
        raise RuntimeError("compiler failed")

    with pytest.raises(RuntimeError, match="compiler failed"):
        _build.resolve_library("demo", tmp_path / "lib.so", broken)
    assert list(tmp_path.iterdir()) == []


def test_ledger_compile_block_carries_both_key_sets(tmp_path):
    doc = RunLedger("pipeline").write(str(tmp_path / "ledger.json"), registry=MetricsRegistry())
    assert set(doc["compile"]) == {"kernel_builds", "kernel_build_seconds", "kernels_loaded", *REF_KEYS}


def test_a_services_registry_shows_the_compile_families():
    registry = MetricsRegistry()
    compilecache.publish_compile_metrics(registry)
    text = registry.render()
    for name in ("cobalt_compile_total", "cobalt_compile_seconds", "cobalt_compile_cache_hits_total",
                 "cobalt_compile_cache_misses_total", "cobalt_compile_cache_saved_seconds_total"):
        assert f"# TYPE {name} " in text
    compilecache.publish_compile_metrics(registry)  # twice is harmless
    assert registry.render() == text
