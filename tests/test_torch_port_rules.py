"""Rules the PyTorch port keeps.

- The port package and ``chip_smoke.py`` import neither JAX nor anything of
  the JAX package (``cobalt_smart_lender_ai_tpu``); importing the port's
  serving stack in a fresh interpreter leaves ``jax`` unloaded.
- Its entry points run on the CUDA device unless the caller asks for the
  CPU: with CUDA unavailable, the default-device service constructors raise
  instead of scoring on the CPU, and ``chip_smoke.py`` exits non-zero
  without printing a result.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve import __main__ as cli
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService, resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cobalt_smart_lender_ai_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods: set[str] = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "cobalt_smart_lender_ai_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_import_no_jax_and_no_reference_package(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.name} imports {bad}"
    text = path.read_text()
    assert "import jax" not in text
    assert "cobalt_smart_lender_ai_tpu." not in text.replace("cobalt_smart_lender_ai_tpu_torch", "")


def test_importing_the_serving_stack_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import cobalt_smart_lender_ai_tpu_torch.serve.__main__\n"
        "import cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio\n"
        "import cobalt_smart_lender_ai_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cobalt_smart_lender_ai_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ScorerService.from_store(ObjectStore(str(ROOT / "artifacts")))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    args = cli.parse_args(["--store", str(ROOT / "artifacts")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.build_service(args)


def test_cli_builds_a_cpu_service_when_asked():
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--device", "cpu"])
    svc = cli.build_service(args)
    try:
        ready, payload = svc.ready()
        assert ready and payload["device"] == "cpu" and payload["kernel"] == "plain"
    finally:
        svc.close()


def test_cli_rejects_unported_precisions():
    args = cli.parse_args(
        ["--store", str(ROOT / "artifacts"), "--device", "cpu", "--forest-precision", "int8"]
    )
    with pytest.raises(NotImplementedError, match="f32"):
        cli.build_service(args)


def _run_chip_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever this runs
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_chip_smoke_fails_without_a_gpu():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
