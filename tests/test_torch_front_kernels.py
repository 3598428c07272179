"""Every kernel of the port is reached through the etcd3 front.

The port's server runs over the ``cuda`` engine on memkv with
``--device cpu``. CPU tensors take the kernels' plain versions, so the
wrappers count a launch where they call the plain version, as in the chip
rehearsal (``tests/test_torch_chip_smoke.py``, ``cpu_shims``): concurrent
front Ranges batched by the scheduler reach K2 (``--sched-batch``), and
Watch streams reach K4 with ``--tpu-fanout`` and K5 with ``--tpu-fanout
--fanout-impl legacy``, each response held to the Backend's own answer or
to the events each watch must get. K1 and K3 through the front are in
``tests/test_torch_front_differential.py``.
"""

import queue
import threading
import time

import pytest

from kubebrain_tpu_torch.cli import build_endpoint
from kubebrain_tpu_torch.fanout import DeviceFanout
from kubebrain_tpu_torch.ops import compact_kernels, fanout_kernels, scan_kernels
from kubebrain_tpu_torch.ops.fanout import FanoutMatcher
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.sched import Lane

from test_etcd_server import EtcdClient, free_port
from test_torch_chip_smoke import cpu_shims
from test_torch_etcd_server import port_flags

NAMESPACES = [b"/registry/pods/ns%02d/" % i for i in range(70)]


@pytest.fixture
def serve(monkeypatch):
    """``serve(*flags)``: a running port server with the rehearsal's
    launch counting; (client, backend)."""
    cpu_shims(monkeypatch.setattr)
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()
    running = []

    def start(*flags):
        port = free_port()
        endpoint, backend, store = build_endpoint(port_flags(port, *flags))
        endpoint.run()
        client = EtcdClient(f"127.0.0.1:{port}")
        running.append((client, endpoint, backend, store))
        return client, backend

    yield start
    for client, endpoint, backend, store in running:
        client.close()
        endpoint.close()
        backend.close()
        store.close()
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()


def _queued(sched) -> int:
    return sum(lq.size for lq in sched._queues.values()) + sched.coalesced


def test_concurrent_front_ranges_batch_into_k2(serve):
    """Distinct Ranges that queue together behind a busy slot leave the
    scheduler as one batch, one K2 launch, and each answers as the
    Backend does alone."""
    client, backend = serve("--sched-depth", "1", "--sched-batch", "8")
    for ns in NAMESPACES[:4]:
        for i in range(5):
            assert client.create(ns + b"p%d" % i, b"v").succeeded
    backend.scanner._host_limit_threshold = 0  # every Range on the device path
    spans = [(ns, ns[:-1] + b"0") for ns in NAMESPACES[:4]]
    want = [backend.list_(start, end) for start, end in spans]
    sched = backend._kb_scheduler
    scan_kernels.reset_launch_counts()
    release = threading.Event()
    # one plug runs, a second waits in the dispatcher's hand: the Ranges
    # then queue together
    plugs = [sched.submit_async(release.wait, Lane.SYSTEM) for _ in range(2)]
    got: list = [None] * len(spans)

    def one(i):
        start, end = spans[i]
        got[i] = client.range_(rpc_pb2.RangeRequest(key=start, range_end=end))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(spans))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while _queued(sched) < len(spans) and time.monotonic() < deadline:
        time.sleep(0.005)
    release.set()
    for t in threads:
        t.join(timeout=30)
    for p in plugs:
        p.wait(5.0)
    assert sched.batched > 0
    assert scan_kernels.visibility_mask_batch_q.launches > 0
    for resp, ref in zip(got, want):
        assert [(kv.key, kv.value, kv.mod_revision) for kv in resp.kvs] == [
            (kv.key, kv.value, kv.revision) for kv in ref.kvs]


@pytest.mark.parametrize("impl", ["block", "legacy"])
def test_front_watches_reach_the_fanout_kernel(serve, impl):
    """70 broad and 70 namespace watches on one Watch stream make the hub's
    interval index dense, so each drain block goes to the device matcher:
    K4 (``DeviceFanout``) or, with ``--fanout-impl legacy``, K5
    (``FanoutMatcher``). Every watch gets exactly its events."""
    client, backend = serve("--tpu-fanout", "--fanout-impl", impl)
    matcher = backend.watcher_hub._fanout_matcher
    assert isinstance(matcher, DeviceFanout if impl == "block" else FanoutMatcher)
    requests: queue.Queue = queue.Queue()
    responses = client.watch(iter(requests.get, None))
    ranges = [(b"/registry/", b"/registry0")] * 70 + [
        (ns, ns[:-1] + b"0") for ns in NAMESPACES]
    ids = {}
    for start, end in ranges:
        req = rpc_pb2.WatchRequest()
        req.create_request.key = start
        req.create_request.range_end = end
        requests.put(req)
        created = next(responses)
        assert created.created
        ids[created.watch_id] = (start, end)
    got = {wid: [] for wid in ids}
    fanout_kernels.reset_launch_counts()
    keys = [NAMESPACES[i % 7] + b"w%d" % i for i in range(20)]
    for key in keys:
        assert client.create(key, b"v").succeeded
    want = {wid: [k for k in keys if start <= k < end]
            for wid, (start, end) in ids.items()}
    n_want = sum(len(v) for v in want.values())
    seen = 0
    while seen < n_want:
        resp = next(responses)
        got[resp.watch_id].extend(e.kv.key for e in resp.events)
        seen += len(resp.events)
    requests.put(None)
    assert got == want
    launched = (fanout_kernels.fanout_dispatch if impl == "block"
                else fanout_kernels.fanout_mask_range).launches
    assert launched > 0
