"""The device trace of a ``--trace 1`` window: ``torch.profiler`` with CUDA
activity only (the kernels, copies and sets the card ran), read back from
its Chrome trace into busy seconds, device time by operation and the
longest idle gaps, each named by what the host did in it where the run's
spans are at hand."""

from __future__ import annotations

import json
import os
import tempfile

from kbbench.spans import host_label

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def summarize(prof) -> dict:
    """``{"busy_s", "ops": {name: [launches, seconds]}, "gaps": [[label,
    seconds]], "gap_ns": [[start, end]] or None}`` of a finished profile.
    ``busy_s`` is the union of the device operations' intervals; each gap
    is labelled by the operations on either side of it, and ``gap_ns``
    gives its start and end in epoch nanoseconds (the trace's
    ``baseTimeNanoseconds + ts * 1000``), None where the trace has no
    base."""
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
                         (ts - end) / 1e6, end, ts])
        if end is None or ts + dur > end:
            busy += (ts + dur - max(ts, end if end is not None else ts)) / 1e6
            end = ts + dur
            prev = name
    gaps.sort(key=lambda g: -g[1])
    base = trace.get("baseTimeNanoseconds")
    return {"busy_s": busy, "ops": ops,
            "gaps": [[label, sec] for label, sec, _a, _b in gaps[:10]],
            "gap_ns": None if base is None else [
                [int(base) + round(a * 1e3), int(base) + round(b * 1e3)]
                for _l, _s, a, b in gaps[:10]]}


def breakdown(summary: dict, spans: list[dict] | None = None) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps, each named by the host stages
    in it (``kbbench.spans.host_label``) where the run's ``spans`` and the
    trace's base are at hand, else by its device neighbours."""
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = summary["gaps"]
    if spans and summary.get("gap_ns"):
        gaps = [[host_label(a, b, spans), sec]
                for (_label, sec), (a, b) in zip(gaps, summary["gap_ns"])]
    return {"device_ops": [[name[:120], sec] for name, (_n, sec) in top],
            "idle_gaps": gaps}
