"""The device trace of a ``--trace 1`` window: ``torch.profiler`` with CUDA
activity only (the kernels, copies and sets the card ran), read back from
its Chrome trace into busy seconds, device time by operation and the
longest idle gaps."""

from __future__ import annotations

import json
import os
import tempfile

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def summarize(prof) -> dict:
    """``{"busy_s", "ops": {name: [launches, seconds]}, "gaps": [[label,
    seconds]]}`` of a finished profile. ``busy_s`` is the union of the device operations' intervals;
    each gap is labelled by the operations on either side of it."""
    fd, path = tempfile.mkstemp(prefix="kbbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in trace.get("traceEvents", [])
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda e: e[1])
    ops: dict[str, list] = {}
    for name, _ts, dur in events:
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur / 1e6
    busy = 0.0
    gaps = []
    end = None
    prev = None
    for name, ts, dur in events:
        if end is not None and ts > end:
            gaps.append([f"after {prev[:60]}, before {name[:60]}",
                         (ts - end) / 1e6])
        if end is None or ts + dur > end:
            busy += (ts + dur - max(ts, end if end is not None else ts)) / 1e6
            end = ts + dur
            prev = name
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy, "ops": ops, "gaps": gaps[:10]}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps."""
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:120], sec] for name, (_n, sec) in top],
            "idle_gaps": summary["gaps"]}
