"""The port's asyncio etcd3 listener (``kubebrain_tpu_torch/endpoint/aio.py``)
over the ``cuda`` engine on memkv with ``device="cpu"``: counterparts of
``tests/test_aio_endpoint.py`` (300 concurrent watch streams on a
coroutine-held server, far beyond any thread pool, with writes flowing
throughout), and the request script of ``tests/test_torch_front_differential.py``
sent to the JAX CLI's ``--aio-port`` listener and the port CLI's, whose
serialized responses, errors and watch events must be equal."""

import queue as sync_queue
import threading
import time

import grpc
import pytest

from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.endpoint.aio import AioBridgeQueue, AioEndpoint
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.server.service import SingleNodePeerService
from kubebrain_tpu_torch.storage import new_storage

from test_etcd_server import EtcdClient, free_port
from test_torch_front_differential import fronts, run_differential  # noqa: F401


@pytest.fixture
def aio_server():
    store = new_storage("cuda", inner="memkv", device="cpu")
    backend = Backend(store, BackendConfig(event_ring_capacity=65536,
                                           watch_cache_capacity=65536))
    peers = SingleNodePeerService(backend)
    port = free_port()
    ep = AioEndpoint(backend, peers, "127.0.0.1", port)
    ep.run()
    client = EtcdClient(f"127.0.0.1:{port}")
    yield client, backend
    client.close()
    ep.close()
    backend.close()
    store.close()


def test_aio_txn_and_range(aio_server):
    client, backend = aio_server
    resp = client.create(b"/aio/k", b"v1")
    assert resp.succeeded
    rev = resp.responses[0].response_put.header.revision
    assert client.update(b"/aio/k", b"v2", rev).succeeded
    r = client.range_(rpc_pb2.RangeRequest(key=b"/aio/k"))
    assert r.kvs[0].value == b"v2"
    # the Range went through the cuda engine's scanner
    assert type(backend.scanner).__name__ == "TorchScanner"
    # error mapping through the executor adapter
    put = client.ch.unary_unary(
        "/etcdserverpb.KV/Put",
        request_serializer=rpc_pb2.PutRequest.SerializeToString,
        response_deserializer=rpc_pb2.PutResponse.FromString,
    )
    with pytest.raises(grpc.RpcError) as ei:
        put(rpc_pb2.PutRequest(key=b"/x", value=b"y"))
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_aio_watch_stream(aio_server):
    client, _ = aio_server
    requests: sync_queue.Queue = sync_queue.Queue()
    responses = client.watch(iter(requests.get, None))
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/aio/w/"
    req.create_request.range_end = b"/aio/w0"
    requests.put(req)
    assert next(responses).created
    r1 = client.create(b"/aio/w/a", b"1")
    rev1 = r1.responses[0].response_put.header.revision
    client.update(b"/aio/w/a", b"2", rev1)
    events = []
    while len(events) < 2:
        events.extend(next(responses).events)
    assert [e.kv.value for e in events] == [b"1", b"2"]
    requests.put(None)


def test_300_streams_beyond_any_thread_pool(aio_server):
    client, backend = aio_server
    N = 300
    received = [0]
    lock = threading.Lock()
    request_queues = []

    def consume(responses):
        try:
            for resp in responses:
                with lock:
                    received[0] += len(resp.events)
        except grpc.RpcError:
            return  # channel closed at teardown

    for _ in range(N):
        rq: sync_queue.Queue = sync_queue.Queue()
        responses = client.watch(iter(rq.get, None))
        req = rpc_pb2.WatchRequest()
        req.create_request.key = b"/aio/scale/"
        req.create_request.range_end = b"/aio/scale0"
        rq.put(req)
        request_queues.append(rq)
        threading.Thread(target=consume, args=(responses,), daemon=True).start()
    # streams register asynchronously; wait until the hub sees them all
    deadline = time.time() + 20
    while time.time() < deadline and backend.watcher_hub.watcher_count() < N:
        time.sleep(0.05)
    assert backend.watcher_hub.watcher_count() == N

    for i in range(10):
        assert client.create(b"/aio/scale/k%02d" % i, b"v").succeeded
    deadline = time.time() + 20
    while time.time() < deadline and received[0] < N * 10:
        time.sleep(0.1)
    assert received[0] == N * 10, f"delivered {received[0]}/{N*10}"
    for rq in request_queues:
        rq.put(None)


def test_aio_list_over_watch_and_keepalive(aio_server):
    """Negative-start-revision range stream + LeaseKeepAlive parity."""
    client, backend = aio_server
    for i in range(7):
        client.create(b"/aio/low/k%02d" % i, b"v%d" % i)
    requests: sync_queue.Queue = sync_queue.Queue()
    responses = client.watch(iter(requests.get, None))
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/aio/low/"
    req.create_request.range_end = b"/aio/low0"
    req.create_request.start_revision = -backend.current_revision()
    requests.put(req)
    created = next(responses)
    assert created.created
    got = []
    while True:
        resp = next(responses)
        got.extend(resp.events)
        if resp.canceled:
            break
    assert len(got) == 7 and all(e.kv.value.startswith(b"v") for e in got)
    requests.put(None)

    lg = client.lease_grant(rpc_pb2.LeaseGrantRequest(TTL=600))
    ka = client.ch.stream_stream(
        "/etcdserverpb.Lease/LeaseKeepAlive",
        request_serializer=rpc_pb2.LeaseKeepAliveRequest.SerializeToString,
        response_deserializer=rpc_pb2.LeaseKeepAliveResponse.FromString,
    )
    # the aio keepalive path shares the real registry (SYSTEM-lane refresh)
    resp = next(ka(iter([rpc_pb2.LeaseKeepAliveRequest(ID=lg.ID)])))
    assert resp.ID == lg.ID and resp.TTL == 600
    resp = next(ka(iter([rpc_pb2.LeaseKeepAliveRequest(ID=999999)])))
    assert resp.TTL == 0  # unknown lease: etcd's not-found encoding


def test_bridge_queue_overflow_is_the_hubs_full():
    """The hub's side of a subscriber queue: ``put_nowait`` raises
    ``queue.Full`` at its size (the hub's slow-consumer drop) and
    ``get_nowait`` ``queue.Empty``; the first item of an empty queue wakes
    the loop once, through the notifier."""
    import asyncio

    loop = asyncio.new_event_loop()
    try:
        woken = []
        notifier = type("N", (), {"notify": lambda self, q: woken.append(q)})()
        q = AioBridgeQueue(2, loop, notifier)
        q.put_nowait("a")
        q.put_nowait("b")
        with pytest.raises(sync_queue.Full):
            q.put_nowait("c")
        assert woken == [q] and q.qsize() == 2
        assert q.get_nowait() == "a" and loop.run_until_complete(q.get()) == "b"
        with pytest.raises(sync_queue.Empty):
            q.get_nowait()
        assert q.empty()
    finally:
        loop.close()


@pytest.mark.parametrize("fronts", [(False, "aio_port"), (True, "aio_port")],
                         indirect=True, ids=["host_path", "device_path"])
def test_port_aio_listener_answers_as_the_jax_one(fronts):
    """The differential request script through each package's ``--aio-port``
    listener (the JAX CLI over memkv, the port's over ``cuda`` on memkv):
    byte-equal responses and errors, the same watch events in order; with
    the device path, the Ranges reach K1's wrapper and the Compact K3's."""
    from kubebrain_tpu_torch.ops import compact_kernels, scan_kernels

    jax_front, port_front, device_path = fronts
    run_differential(jax_front, port_front)
    if device_path:
        assert scan_kernels.visibility_mask_batch.launches > 0
        assert compact_kernels.victim_mask_batch.launches > 0
