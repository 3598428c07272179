"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark's
tree (the same cells, configurations and mixes, at a few hundred rows and
four clients) and a helper that runs one cell of it on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(tree: Path) -> None:
    """Cut every configuration and mix under ``tree/kbbench`` to a size a
    test run holds: 3 namespaces of 60 pods, 40 nodes and leases, 400
    benchmark keys, 4 clients (an open loop's at 400 requests a second),
    pages of 25, compaction every second."""
    for path in (tree / "kbbench" / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        for r in conf["resources"]:
            if "namespaces" in r:
                r.update(namespaces=3, per_namespace=60)
            else:
                r["count"] = 400 if "key_bytes" in r else 40
        if "etcd_compaction_interval_s" in conf:
            conf["etcd_compaction_interval_s"] = 1
        path.write_text(json.dumps(conf))
    for path in (tree / "kbbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(clients=4, warmup_ops_per_client=2, check_share=0.5)
        if t["loop"] == "open":
            t.update(rate=400, warmup_s=0.3)
        for op in t["ops"]:
            if "page" in op:
                op["page"] = 25
        path.write_text(json.dumps(t))


#: the configuration and mixes kept under ``kbbench/`` for later cells
#: (PERF.md, Open questions), given here the entries a manifest would give
#: them, so that their code stays tested: their cells and the per-layer
#: metrics each would report
KEPT_CONFIG = {"name": "k8s-cl2-5k", "source": "kept for later cells",
               "file": "kbbench/configs/k8s-cl2-5k.json",
               "reduced": ["wire", "etcd_compaction_interval_s"],
               "why": "kept for later cells"}
SHARED = ["sched.queue_wait_ms", "sched.write_group_ops", "mirror.merge_ms",
          "watch.hub_lag_ms", "device.idle_pct"]
#: the latency tails, end-to-end metrics of the kept cells
KEPT_E2E = ["read_p95_ms", "write_p95_ms", "watch_lag_p95_ms"]
KEPT_CELLS = {
    "k8s-cl2-5k.relist": SHARED + ["scan.host_copy_ms", "scan.engine_ms",
                                   "transfer.bytes_per_read",
                                   "kernel.scan_roofline_pct"],
    "k8s-cl2-5k.churn": SHARED + ["scan.host_copy_ms", "scan.engine_ms",
                                  "compact.seconds"]}
#: the capacity cell of the published mix, kept for a later cell (PERF.md,
#: Open questions): it has no per-layer metric yet
KEPT_PEAK = "kb-upstream-rw.insert-read-peak"
KEPT_METRICS = {
    "scan.host_copy_ms": ("ms", "lower", "program_span", "read_p95_ms"),
    "scan.engine_ms": ("ms", "lower", "program_span", "read_p95_ms"),
    "transfer.bytes_per_read": ("B", "lower", "program_counter",
                                "read_p95_ms"),
    "kernel.scan_roofline_pct": ("%", "higher", "device_trace",
                                 "read_p95_ms"),
    "compact.seconds": ("s", "lower", "program_span", "write_p95_ms"),
    "watch.hub_lag_ms": ("ms", "lower", "program_span", "watch_lag_p95_ms")}


@pytest.fixture
def tiny(tmp_path) -> Path:
    """A tiny copy of the benchmark under ``tmp_path``: ``BENCHMARK.json``
    with the kept cells added (each reporting ``ops_per_s``), and
    ``kbbench/``'s data files and readers."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    if KEPT_CONFIG["name"] not in {c["name"] for c in manifest["configs"]}:
        manifest["configs"].append(KEPT_CONFIG)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    # the kept cells' rate is the fixed-rate cells' one
    rate = e2e["ops_per_s"]["workloads"]
    rate += [c for c in (*KEPT_CELLS, KEPT_PEAK) if c not in rate]
    for name in KEPT_E2E:
        e2e.setdefault(name, {"name": name, "unit": "ms", "better": "lower",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": list(KEPT_CELLS)})
    manifest["end_to_end"] = list(e2e.values())
    metrics = {m["name"]: m for m in manifest["per_layer"]}
    for name, (unit, better, source, moves) in KEPT_METRICS.items():
        metrics.setdefault(name, {
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": "kept for later cells", "moves": moves, "workloads": []})
    manifest["per_layer"] = list(metrics.values())
    for cell, names in KEPT_CELLS.items():
        if cell in {w["name"] for w in manifest["workloads"]}:
            continue
        manifest["workloads"].append({
            "name": cell, "config": "k8s-cl2-5k",
            "traffic": cell.split(".", 1)[1], "chips": 1,
            "why": "kept for a later cell"})
        for name in names:
            metrics[name]["workloads"].append(cell)
    if KEPT_PEAK not in {w["name"] for w in manifest["workloads"]}:
        manifest["workloads"].append({
            "name": KEPT_PEAK, "config": "kb-upstream-rw",
            "traffic": "insert-read-peak", "chips": 1,
            "why": "kept for a later cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "kbbench" / sub, tmp_path / "kbbench" / sub)
    shrink(tmp_path)
    return tmp_path


def run_cell(tree: Path, workload: str, seed: int = 20240611,
             seconds: float = 1.5, trace: int = 0, control: bool = False,
             faults=None) -> dict:
    """One run of ``workload`` on the CPU; its result line, parsed."""
    from kbbench import run

    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--manifest",
            str(tree / "BENCHMARK.json")]
    if control:
        argv.append("--control")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(argv, device="cpu", faults=faults)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])
