"""Host and card lines printed beside each run: a host-speed probe (the
host's speed has varied between machines by up to 2.8x) and ``nvidia-smi``
readings of the card's clocks, power and limit, taken as the window opens
and as it closes."""

from __future__ import annotations

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
