#!/usr/bin/env python3
"""Run one benchmark cell of the port and print its result.

    python3 kbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``kbbench/configs/<config>.json``), its traffic mix
(``kbbench/traffic/<mix>.json``) and its metrics; each per-layer metric is
read by ``kbbench/metrics/<metric>.py``. One run builds the store from the
seed, boots the port through its CLI wiring, warms the cell's own requests,
measures for ``--seconds``, checks what the program answered against the
reference (``kbbench/reference.py``) and prints, last on standard output,
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit (also the last lines of
standard error). It exits 2 without a result where the card is missing,
and 3 where the process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kubebrain_tpu", "bench", "chip_smoke")
#: a latency percentile that falls on a failed request, ms
FAILED_MS = 1e9


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="serve the cell from the control (kbbench/control.py) "
                        "in the program's place; its run must not be correct")
    p.add_argument("--manifest", default=str(ROOT / "BENCHMARK.json"),
                   help="the benchmark's manifest (default: BENCHMARK.json "
                        "at the root of the checkout)")
    return p.parse_args(argv)


def load_cell(manifest_path: str, workload: str) -> SimpleNamespace:
    """The cell ``workload`` of the manifest: its entry, its configuration
    and traffic files, and the metrics it reports."""
    manifest = json.loads(Path(manifest_path).read_text())
    here = Path(manifest_path).resolve().parent
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {manifest_path}")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((here / conf["file"]).read_text())
    traffic_dir = here / Path(conf["file"]).parent.parent / "traffic"
    traffic = json.loads((traffic_dir / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reported]
    return SimpleNamespace(cell=cell, config=config, traffic=traffic,
                           e2e=e2e, layer=layer,
                           metrics_dir=traffic_dir.parent / "metrics")


def reader(metrics_dir: Path, name: str):
    """The per-layer metric ``name``'s reader module,
    ``kbbench/metrics/<name>.py``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kbbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(line: str) -> None:
    print(line, flush=True)


def finite(v: float) -> float:
    return FAILED_MS if math.isinf(v) else v


def main(argv=None, device: str | None = None, faults=None) -> int:
    """One run. ``device`` None takes the card (and exits 2 without one);
    the CPU tests pass ``"cpu"``. ``faults(backend)``, where given, breaks
    the booted program for the tests that show a fault is caught."""
    args = parse(argv)
    cell = load_cell(args.manifest, args.workload)
    chips = cell.cell["chips"]

    import torch

    from kbbench import dataset, devtrace, driver, hostinfo, reference, spans
    from kbbench.sink import RecordingMetrics

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"kbbench: the cell needs {chips} CUDA device(s), this "
                  f"machine has {n}", file=sys.stderr)
            return 2
        device = "cuda"
    on_card = device == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    say(f"kbbench: {args.workload} seed {args.seed} seconds {args.seconds} "
        f"trace {args.trace}: {kind} x {torch.cuda.device_count() if on_card else 0}"
        f" (uses {chips}), torch {torch.__version__}")
    say(f"host probe: {json.dumps(hostinfo.host_probe())}")
    say(f"nvidia-smi before: {hostinfo.smi()}")

    t = time.monotonic()
    ds = dataset.build(cell.config, args.seed)
    say(f"set-up: dataset of {len(ds.records)} version rows, top revision "
        f"{ds.top}, in {time.monotonic() - t:.3f} s")
    # the harness's dataset leaves the collector's generations before the
    # program boots: a full collection walks the program's objects, as in
    # a deployed server, and not the harness's hundreds of thousands of rows
    gc.collect()
    gc.freeze()
    store_dir = driver.data_dir()
    backend = None
    sink = RecordingMetrics()
    collections = hostinfo.Collections()
    try:
        if args.control:
            from kbbench.control import ControlBackend

            backend, times = ControlBackend(ds), (0.0, 0.0, 0.0)
        else:
            backend, times = driver.boot(cell.config, ds, store_dir, sink,
                                         device)
        t = time.monotonic()
        if on_card and not args.control:
            from kubebrain_tpu_torch import _build

            _build.build_all()
        say("set-up: booted in {:.3f} s, store loaded in {:.3f} s, mirror "
            "published in {:.3f} s, kernels built or loaded in {:.3f} s"
            .format(*times, time.monotonic() - t))
        if faults is not None:
            faults(backend)
        run = driver.Run(backend, ds, cell.config, cell.traffic, args.seed)
        if cell.traffic["compaction"]:
            # the last compaction before the window: the dataset's history
            t = time.monotonic()
            run.compact(ds.top)
            say(f"set-up: compaction to {ds.top} in "
                f"{time.monotonic() - t:.3f} s")
        readers = {m["name"]: reader(cell.metrics_dir, m["name"])
                   for m in cell.layer} if args.trace else {}
        w = SimpleNamespace(scratch={}, trace=None, trace_window_s=0.0,
                            backend=backend)
        prof = devtrace.profiler() if args.trace and on_card else None
        smi_lines = []
        marks = {}

        def on_start():
            smi_lines.extend((hostinfo.smi(), hostinfo.pressure()))
            collections.open()
            for r in readers.values():
                if hasattr(r, "start"):
                    r.start(w)
            if prof is not None:
                prof.__enter__()
            marks["t0"] = time.monotonic()
            marks["m0"] = sink.mark()

        def on_stop():
            collections.close()
            marks["m1"] = sink.mark()
            if prof is not None:
                prof.__exit__(None, None, None)
            marks["t1"] = time.monotonic()
            smi_lines.extend((hostinfo.smi(), hostinfo.pressure()))

        run.warm_and_measure(args.seconds, on_start, on_stop)
        setup_s = run.t0 - T_START
        late = run.drain()
        for rev, a, b in run.compactions:
            say(f"compaction to {rev}: began {a - run.t0:+.3f} s from the "
                f"window's start, took {b - a:.3f} s")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        attempted, failed = run.counts()
        slices = run.slices(5.0)
        merges = [(t, v) for t, v in sink.timed("kb.mirror.merge.seconds")
                  if t - v < run.t1 and t > run.t0]
        metrics = {}
        result = {}
        if args.trace:
            summary = devtrace.summarize(prof) if prof is not None else None
            model = []

            def get_model():
                if not model:
                    m = reference.Model()
                    m.load(ds.records)
                    for c in run.clients:
                        for verb, key, value, rev, _a, t1 in c.acked:
                            if t1 < run.t1:
                                m.apply(verb, key, rev, value)
                    model.append(m)
                return model[0]

            w.__dict__.update(
                samples=lambda name, **tags: sink.samples(
                    name, since=marks["m0"], until=marks["m1"], **tags),
                samples_after_start=lambda name, **tags: sink.samples(
                    name, since=marks["m0"], **tags),
                timed=sink.timed, t0=run.t0, t1=run.t1,
                seconds=run.t1 - run.t0,
                reads=sum(1 for c in run.clients for o in c.ops
                          if o[0] == "r" and o[3] and run.t0 <= o[2] < run.t1),
                compactions=sum(1 for _r, a, _b in run.compactions
                                if run.t0 <= a < run.t1),
                trace=summary, trace_window_s=marks["t1"] - marks["t0"],
                traffic=cell.traffic, dataset=ds, model=get_model,
                head=max((a[3] for c in run.clients for a in c.acked
                          if a[5] < run.t1), default=ds.top))
            for m in cell.layer:
                v = readers[m["name"]].read(w)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if summary is not None:
                result["breakdown"] = devtrace.breakdown(summary,
                                                         spans.spans(w))
        else:
            e2e = run.e2e()
            e2e["setup_s"] = setup_s
            for m in cell.e2e:
                metrics[m["name"]] = {"value": finite(e2e[m["name"]]),
                                      "unit": m["unit"]}
        lat = run.latencies()
        say("window: latency ms, p50 / p95 / p99 / mean (the cell's "
            "end-to-end metrics are those BENCHMARK.json lists): " + "; ".join(
                f"{k} " + " / ".join(f"{finite(driver.percentile(v, q)):.3f}"
                                     for q in (0.5, 0.95, 0.99))
                + f" / {finite(sum(v) / len(v)) if v else 0.0:.3f}"
                for k, v in lat.items()))
        del lat
        t = time.monotonic()
        outputs = run.outputs(cell.traffic["readback"], sink)
        gathered_s = time.monotonic() - t
        outputs.unanswered += late
    finally:
        collections.close()
        # the store is not closed: closing checkpoints the whole store to
        # disk (about a gigabyte here) for a restart that never comes; the
        # directory goes with its write-ahead log
        if backend is not None:
            backend.close()
        backend = None
        say(f"store directory: {driver.disk_bytes(store_dir)} bytes on disk")
        driver.remove(store_dir)
    del run, w
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the host's speed with the program stopped, as near the window as the
    # run allows: the set-up probe alone does not follow the window's speed
    say(f"host probe after the window: {json.dumps(hostinfo.host_probe())}")
    t = time.monotonic()
    checks = reference.judge(ds.records, outputs)
    say(f"check: the program's answers gathered in {gathered_s:.3f} s, "
        f"judged by the reference in {time.monotonic() - t:.3f} s")
    correct = all(c["value"] <= c["limit"] for c in checks)
    found = forbidden_modules()
    if found:
        print(f"kbbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": chips, "memory_peak_bytes": peak}
    if args.trace:
        device_out["busy_s"] = summary["busy_s"] if summary else 0.0
        device_out["window_s"] = w_window = marks["t1"] - marks["t0"]
        say(f"traced window {w_window:.3f} s, device busy "
            f"{device_out['busy_s']:.6f} s")
    for when, line in zip(("opens", "opens", "closes", "closes"), smi_lines):
        say(f"as the window {when}: {line}")
    say(f"window: {attempted} requests sent, {failed} failed; answered "
        f"per 5 s: {slices}; {len(merges)} merges ran in it, of "
        f"{sorted(round(v, 3) for _t, v in merges)} s; "
        + collections.line())
    for c in checks:
        if c["what"]:
            say(f"check {c['name']}: {c['value']} (limit {c['limit']}): "
                + "; ".join(c["what"]))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_out, **result,
              "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]}
                         for c in checks}}
    for c in checks:
        print(f"{c['name']} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
