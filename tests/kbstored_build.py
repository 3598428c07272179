"""Session fixtures that build the native binaries on first use:
``native/kvrpc/kbstored`` (``kbstored``) and ``native/front/kbfront``
(``kbfront``).

The binaries are git-ignored, so a clean checkout lacks them when the tests
are collected. Each fixture runs ``make -C native <target>`` under an
exclusive ``fcntl.flock`` on ``build/kbstored.lock``, so the xdist workers
that reach it together build it once, and it hands out the binary's path
only once make has returned under the lock (another process may be running
the JAX adapter's ``make -C native`` of every target at the same moment).
It skips only when ``make`` or a C++ compiler is absent; a failed build
fails the test, with make's stderr.

Import a fixture into a test module (``from kbstored_build import
kbstored``) and request it, or mark the module with
``pytest.mark.usefixtures("kbstored")``.
"""

from __future__ import annotations

import fcntl
import os
import pathlib
import shutil
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"
STORED_BIN = NATIVE / "kvrpc" / "kbstored"
FRONT_BIN = NATIVE / "front" / "kbfront"
LOCK = REPO / "build" / "kbstored.lock"


def build_native(target: str) -> pathlib.Path:
    """Make ``native/<target>`` under the lock; returns its path."""
    binary = NATIVE / target
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which("make") is None or shutil.which(cxx) is None:
        pytest.skip(f"make or a C++ compiler ({cxx}) is absent: "
                    f"{target} cannot be built")
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            out = subprocess.run(["make", "-C", str(NATIVE), target],
                                 capture_output=True, text=True, timeout=600)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if out.returncode != 0 or not binary.exists():
        pytest.fail(f"make -C native {target} failed "
                    f"(exit {out.returncode}):\n{out.stderr[-4000:]}")
    return binary


def build_kbstored() -> pathlib.Path:
    """Make ``kbstored`` under the lock; returns its path."""
    return build_native("kvrpc/kbstored")


@pytest.fixture(scope="session")
def kbstored() -> pathlib.Path:
    return build_kbstored()


@pytest.fixture(scope="session")
def kbfront() -> pathlib.Path:
    return build_native("front/kbfront")
