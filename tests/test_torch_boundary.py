"""The port's boundaries: it imports neither JAX nor the JAX package, its
entry points default to the card and raise without one, and
``chip_smoke.py`` refuses to run where it cannot measure."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from kubebrain_tpu_torch import _build
from kubebrain_tpu_torch.device import resolve_device
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.cuda.engine import CudaKvStorage

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kubebrain_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "kubebrain_tpu", "grpc", "bench")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_engine_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_storage("cuda", inner="memkv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaKvStorage(new_storage("memkv"))
    store = new_storage("cuda", inner="memkv", device="cpu")
    assert store.make_scanner(get_compact_revision=lambda _s: 0)._device.type == "cpu"
    store.close()


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(os.path, "exists", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_every_cuda_source_is_compiled_for_sm_90a():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "compact_victims", "fanout_match", "scan_visibility"]
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def _smoke(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    # this CPU-only interpreter: no card, so no result line and a non-zero exit
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_watch_ab_fails_without_card():
    """The A/B watch drive measures on a card or not at all: without one
    it fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--watch-ab", "."],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"tree"' not in out.stdout
