"""Request tracing through the port's gRPC front, over the ``cuda``
engine on memkv with ``--device cpu``: span trees findable by the client's
W3C traceparent, /debug/traces and /debug/profile (``torch.profiler``), the
kb_rpc_stage_seconds histogram and the watch-path lag metrics on /metrics.
Counterparts of the front tests of ``tests/test_trace.py``; the traceparent
test drives the server with the JAX package's client library."""

import json
import urllib.request

import pytest

from kubebrain_tpu_torch.cli import build_endpoint, build_parser
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.trace import make_traceparent, parse_traceparent

from test_etcd_server import EtcdClient, free_port
from test_torch_etcd_server import port_flags


def test_cli_accepts_sched_depth_zero():
    from kubebrain_tpu_torch.cli import validate_args

    args = build_parser().parse_args(["--sched-depth", "0"])
    validate_args(args)  # must not raise
    with pytest.raises(SystemExit):
        validate_args(build_parser().parse_args(["--sched-depth", "-1"]))


# ------------------------------------------------------- wire end-to-end
@pytest.fixture(scope="module")
def server():
    port = free_port()
    info_port = free_port()
    args = build_parser().parse_args(port_flags(
        port, "--info-port", str(info_port), "--trace-slow-ms", "10000"))
    endpoint, backend, store = build_endpoint(args)
    endpoint.run()
    client = EtcdClient(f"127.0.0.1:{port}")
    for i in range(40):
        client.create(b"/registry/pods/default/pod-%04d" % i, b"x" * 64)
    yield client, port, info_port
    client.close()
    endpoint.close()
    backend.close()
    store.close()


def _http_json(info_port, path, timeout=10):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{info_port}{path}", timeout=timeout
    ) as resp:
        return json.loads(resp.read())


def _http_text(info_port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{info_port}{path}", timeout=10
    ) as resp:
        return resp.read().decode()


def test_range_trace_stages_sum_to_latency(server):
    """Acceptance: a Range RPC through the real gRPC server yields a trace
    with >= 5 named stages whose durations sum to within 10% of the
    observed end-to-end latency, findable by the client's traceparent."""
    client, _port, info_port = server
    # warm the scheduler threads so queue_wait isn't dominated by startup
    for _ in range(3):
        client.range_(rpc_pb2.RangeRequest(
            key=b"/registry/pods/", range_end=b"/registry/pods0"))

    tp = make_traceparent()
    trace_id = parse_traceparent(tp)[0]
    client.range_(
        rpc_pb2.RangeRequest(key=b"/registry/pods/", range_end=b"/registry/pods0"),
        metadata=(("traceparent", tp),),
    )

    snap = _http_json(info_port, "/debug/traces")
    mine = [t for t in snap["traces"] if t["trace_id"] == trace_id]
    assert mine, f"trace {trace_id} not in /debug/traces"
    span = mine[0]
    assert span["name"] == "etcd.KV/Range"
    assert span["parent_id"] == parse_traceparent(tp)[1]
    stages = {s["stage"] for s in span["stages"]}
    assert len(stages) >= 5, span
    assert {"endpoint_recv", "queue_wait", "device_compute",
            "host_copy", "response_encode"} <= stages
    total = sum(s["duration_ms"] for s in span["stages"])
    assert total == pytest.approx(span["duration_ms"], rel=0.10), span


def test_stage_histogram_on_metrics(server):
    """queue-wait and device-compute appear in kb_rpc_stage_seconds on
    /metrics (alongside the sched gauges + the new depth/RTT gauges)."""
    client, _port, info_port = server
    client.range_(rpc_pb2.RangeRequest(
        key=b"/registry/pods/", range_end=b"/registry/pods0"))
    body = _http_text(info_port, "/metrics")
    assert 'kb_rpc_stage_seconds_bucket{' in body
    assert 'stage="queue_wait"' in body
    assert 'stage="device_compute"' in body
    assert "kb_sched_depth" in body
    assert "kb_sched_dispatch_rtt_seconds" in body


def test_watch_lag_and_backlog_metrics(server):
    """Watch-path lag instrumentation: commit->delivery histogram and the
    per-watcher backlog gauge surface on /metrics."""
    client, _port, info_port = server
    import queue as _q

    requests: _q.Queue = _q.Queue()
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/registry/pods/"
    req.create_request.range_end = b"/registry/pods0"
    requests.put(req)
    responses = client.watch(iter(requests.get, None))
    first = next(iter(responses))
    assert first.created
    client.create(b"/registry/pods/default/watched-1", b"v")
    got = next(iter(responses))
    assert got.events
    # the sync pump records the wire sample after the send returns, so it
    # may land just after the client holds the event: poll for it
    import time as _time

    deadline = _time.monotonic() + 5
    while True:
        body = _http_text(info_port, "/metrics")
        if 'point="wire"' in body or _time.monotonic() > deadline:
            break
        _time.sleep(0.05)
    assert 'kb_watch_lag_seconds_bucket{' in body
    assert 'point="queue"' in body
    assert 'point="wire"' in body
    assert 'kb_watch_backlog{watcher=' in body
    requests.put(None)
    # watcher death unregisters its backlog gauge eagerly (no scrape
    # needed in between — unregister_gauge_fn, not just scrape-time GC)
    import time as _time

    deadline = _time.monotonic() + 5
    while _time.monotonic() < deadline:
        if 'kb_watch_backlog{watcher=' not in _http_text(info_port, "/metrics"):
            break
        _time.sleep(0.1)
    else:
        pytest.fail("dead watcher's backlog gauge still registered")


def test_slow_request_log_via_wire(server):
    """A request slower than --trace-slow-ms lands in the slow log; this
    server's threshold is 10s so the log stays empty."""
    _client, _port, info_port = server
    snap = _http_json(info_port, "/debug/traces")
    assert snap["slow_ms"] == 10000
    assert snap["slow"] == []
    assert snap["stage_ewma_seconds"].get("device_compute") is not None


def test_debug_profile_on_demand(server):
    """/debug/profile?seconds=N captures a torch.profiler trace; the
    legacy /debug/jax-profile URL is the same 2 s capture."""
    _client, _port, info_port = server
    out = _http_json(info_port, "/debug/profile?seconds=0.05", timeout=90)
    assert "trace_dir" in out, out
    assert out["seconds"] == pytest.approx(0.05)
    import os

    assert os.path.isdir(out["trace_dir"])
    assert os.path.isfile(os.path.join(out["trace_dir"], "trace.json"))
    out = _http_json(info_port, "/debug/jax-profile", timeout=90)
    assert out["seconds"] == pytest.approx(2.0)
    # malformed query answers with a JSON error, not a 500
    out = _http_json(info_port, "/debug/profile?seconds=bogus")
    assert "error" in out


def test_traceparent_metadata_flows_from_client_lib(server):
    """EtcdCompatClient injects traceparent on every call — server spans
    come out parented without the caller doing anything."""
    _client, port, info_port = server
    from kubebrain_tpu.client import EtcdCompatClient

    c = EtcdCompatClient(f"127.0.0.1:{port}")
    try:
        kvs, _rev = c.list(b"/registry/pods/", b"/registry/pods0")
        assert len(kvs) >= 40
    finally:
        c.close()
    snap = _http_json(info_port, "/debug/traces")
    parented = [t for t in snap["traces"]
                if t["parent_id"] is not None and t["name"] == "etcd.KV/Range"]
    assert parented, "client-lib Range produced no parented server span"
