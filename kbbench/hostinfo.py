"""Host and card lines printed beside each run: a host-speed probe (the
host's speed has varied between machines by up to 2.8x), taken in set-up
and again once the store is closed after the window, ``nvidia-smi``
readings of the card's clocks, power and limit, taken as the window opens
and as it closes, and the collector's passes in the window."""

from __future__ import annotations

import gc
import hashlib
import os
import shutil
import subprocess
import time

SMI_FIELDS = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def host_probe() -> dict:
    """Milliseconds of a fixed interpreter loop and of hashing 64 MiB."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i * i
    t1 = time.perf_counter()
    hashlib.sha256(bytes(64 << 20)).digest()
    t2 = time.perf_counter()
    return {"python_loop_ms": (t1 - t0) * 1e3, "sha256_64mib_ms": (t2 - t1) * 1e3}


def pressure() -> str:
    """The host's load averages and its CPU and IO pressure (PSI), where
    the kernel exposes them: what other work on the machine takes."""
    out = ["load %.2f %.2f %.2f" % os.getloadavg(),
           f"cpus {len(os.sched_getaffinity(0))}"]
    for res in ("cpu", "io"):
        try:
            with open(f"/proc/pressure/{res}") as f:
                out.append(f"{res} " + f.readline().split(" ", 1)[1].strip())
        except OSError:
            pass
    return "; ".join(out)


def smi() -> str | None:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return None
    return out.stdout.strip().replace("\n", " | ")


class Collections:
    """The collector's passes while it is open (:meth:`open` to
    :meth:`close`): how many of each generation, and each full
    collection's pause in ms."""

    def __init__(self):
        self.counts = [0, 0, 0]
        self.full_ms: list[float] = []
        self._began = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._began = time.perf_counter()
            return
        gen = info["generation"]
        self.counts[gen] += 1
        if gen == 2:
            self.full_ms.append((time.perf_counter() - self._began) * 1e3)

    def open(self) -> None:
        gc.callbacks.append(self)

    def close(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def line(self) -> str:
        return (f"collections by generation {self.counts}, full ones "
                f"pausing {[round(ms, 1) for ms in self.full_ms]} ms")
