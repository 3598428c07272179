"""The served multichip phase: one scan workload through the request
scheduler over the ``part``-sharded ``cuda`` engine at several mesh sizes
(counterpart of ``bench.py``'s ``multichip_phase``, ``bench.py:1782``, which
the port may not import; its raw-key-layout control run is left out).

One host store is loaded once; each mesh size wraps it in a fresh
``CudaKvStorage`` whose mirror splits over that many slots, then the
per-namespace Range/Count requests are pushed through the scheduler from
``threads`` clients. Every answer is held against the sequential
unscheduled oracle at that size and across sizes, byte for byte.
"""

from __future__ import annotations

import threading
import time

#: timed serves per mesh size; the best is kept, and every pass must
#: return the same answers
SERVE_PASSES = 3


def _fingerprint(kind: str, res) -> bytes:
    if kind == "count":
        return b"count|%d|%d" % res
    out = [b"%d|%d|%d" % (res.revision, res.count, int(res.more))]
    for kv in res.kvs:
        out.append(kv.key + b"\x00" + kv.value + b"\x00%d" % kv.revision)
    return b"\xff".join(out)


def multichip_phase(mesh_sizes, n_keys=20_000, n_req=64, depth=4, batch=8,
                    partitions=0, threads=8, device=None) -> dict:
    """Serve the same requests at each mesh size (``make_mesh(n,
    device=device)`` slots) and report rows/s, the scaling against the
    first size, the byte identity and the query batches formed."""
    from ..backend import Backend, BackendConfig
    from ..device import TRANSFER_METER, resolve_device
    from ..sched import SchedConfig, ensure_scheduler
    from ..storage import new_storage
    from ..storage.cuda.engine import CudaKvStorage
    from .mesh import make_mesh

    dev = resolve_device(device)
    ns = 8
    inner = new_storage("memkv")
    loader = Backend(inner, BackendConfig(
        event_ring_capacity=max(8192, n_keys * 2)))
    for i in range(n_keys):
        loader.create(b"/registry/pods/ns-%02d/pod-%07d" % (i % ns, i),
                      b"x" * 64)
    loader.close()

    # per-namespace Range (3 of 4) and Count (1 of 4): the distinct-prefix
    # shape that forms query batches
    reqs = []
    for i in range(n_req):
        bounds = (b"/registry/pods/ns-%02d/" % (i % ns),
                  b"/registry/pods/ns-%02d0" % (i % ns))
        reqs.append(("count" if i % 4 == 3 else "list", *bounds))

    report = {
        "mesh_sizes": list(mesh_sizes), "rows_per_sec": {},
        "scaling_vs_1dev": {}, "byte_identical": True, "batched_riders": {},
        "mirror_partitions": {}, "host_transfer_bytes_per_req": {},
        "requests": n_req,
        "sched": {"depth": depth, "batch": batch, "threads": threads},
        "dataset": {"keys": n_keys, "namespaces": ns},
    }

    def serve(sched):
        results: list = [None] * n_req
        rows = [0] * n_req
        pending = iter(range(n_req))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    i = next(pending, None)
                if i is None:
                    return
                kind, s, e = reqs[i]
                if kind == "count":
                    res = sched.count(s, e, client=f"c{i % 4}")
                    rows[i] = res[0]
                else:
                    res = sched.list_(s, e, 0, 0, client=f"c{i % 4}")
                    rows[i] = len(res.kvs)
                results[i] = _fingerprint(kind, res)

        pool = [threading.Thread(target=worker) for _ in range(threads)]
        t0 = time.monotonic()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        return results, rows, time.monotonic() - t0

    def serve_best(sched):
        best = None
        for _ in range(SERVE_PASSES):
            results, rows, dt = serve(sched)
            if best is not None and results != best[0]:
                raise AssertionError("serve passes diverged")
            if best is None or dt < best[2]:
                best = (results, rows, dt)
        return best

    baseline = None
    try:
        for n in mesh_sizes:
            store = CudaKvStorage(inner, mesh=make_mesh(n, device=dev),
                                  partitions=partitions)
            backend = Backend(store, BackendConfig(event_ring_capacity=8192))
            try:
                sched = ensure_scheduler(
                    backend, SchedConfig(depth=depth, batch=batch))
                # the sequential unscheduled oracle; it also publishes the
                # mirror off the clock
                expect = [_fingerprint(kind, backend.count(s, e)
                                       if kind == "count"
                                       else backend.list_(s, e))
                          for kind, s, e in reqs]
                report["mirror_partitions"][str(n)] = \
                    backend.scanner._mirror.partitions
                serve(sched)  # warm the batched path off the clock
                batched0 = sched.batched
                b0, _ = TRANSFER_METER.snapshot()
                results, rows, dt = serve_best(sched)
                b1, _ = TRANSFER_METER.snapshot()
                mism = sum(a != b for a, b in zip(results, expect))
                if mism:
                    raise AssertionError(
                        f"{mism}/{n_req} scheduled results diverged from the "
                        f"sequential oracle at mesh={n}")
                if baseline is None:
                    baseline = expect
                elif expect != baseline:
                    report["byte_identical"] = False
                report["rows_per_sec"][str(n)] = round(sum(rows) / dt)
                report["batched_riders"][str(n)] = round(
                    (sched.batched - batched0) / SERVE_PASSES)
                report["host_transfer_bytes_per_req"][str(n)] = round(
                    (b1 - b0) / n_req / SERVE_PASSES)
            finally:
                backend.close()
    finally:
        inner.close()
    if not report["byte_identical"]:
        raise AssertionError("mesh sizes disagreed byte for byte")
    base = report["rows_per_sec"].get(str(mesh_sizes[0]), 0) or 1
    for k, v in report["rows_per_sec"].items():
        report["scaling_vs_1dev"][k] = round(v / base, 3)
    report["kernel"] = "cuda" if dev.type == "cuda" else "plain"
    return report
