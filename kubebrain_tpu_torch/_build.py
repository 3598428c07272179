"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` (repo
root), compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface and loaded with ``ctypes``. The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one is reused. A file
lock keeps concurrent processes from compiling the same library twice.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built by
#: this process, by source name
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    """``nvcc`` on the PATH, else under the CUDA toolkit PyTorch finds
    (``CUDA_HOME``, or the toolkit's default install prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is already built;
    returns (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    log = out.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)
    BUILD_LOG[name] = log


def build_all() -> list[str]:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together; load each. Returns the source names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / "lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            jobs = [(n, *_start(n)) for n in names if n not in _libs]
            for n, target, job in jobs:
                _finish(n, target, job)
            for n, target, _job in jobs:
                _libs[n] = ctypes.CDLL(str(target))
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return names


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib
