"""Mini kube-apiserver simulation on the port's front: pod-churn
List+Watch over the etcd3 surface, the informer pattern (List at a
revision, Watch from that revision, reconcile events into a local cache,
assert the cache converges to server state), over the ``cuda`` engine on
memkv with ``--device cpu``. Counterpart of ``tests/test_apiserver_sim.py``
(there over the JAX ``tpu`` engine)."""

import queue
import threading

import pytest

from kubebrain_tpu_torch.cli import build_endpoint
from kubebrain_tpu_torch.proto import kv_pb2, rpc_pb2

from test_etcd_server import EtcdClient, free_port
from test_torch_etcd_server import port_flags


@pytest.fixture
def server():
    port = free_port()
    endpoint, backend, store = build_endpoint(port_flags(port))
    backend.scanner._merge_threshold = 64
    endpoint.run()
    client = EtcdClient(f"127.0.0.1:{port}")
    yield client, backend
    client.close()
    endpoint.close()
    backend.close()
    store.close()


def test_informer_pattern_pod_churn(server):
    client, backend = server
    PREFIX = b"/registry/pods/default/"
    N = 40

    # seed some pods
    revs = {}
    for i in range(N):
        r = client.create(PREFIX + b"pod-%03d" % i, b"gen-0")
        revs[i] = r.responses[0].response_put.header.revision

    # informer: List at snapshot, then Watch from snapshot revision
    lst = client.range_(rpc_pb2.RangeRequest(key=PREFIX, range_end=PREFIX[:-1] + b"0"))
    cache = {kv.key: kv.value for kv in lst.kvs}
    list_rev = lst.header.revision
    assert len(cache) == N

    requests: queue.Queue = queue.Queue()
    responses = client.watch(iter(requests.get, None))
    wreq = rpc_pb2.WatchRequest()
    wreq.create_request.key = PREFIX
    wreq.create_request.range_end = PREFIX[:-1] + b"0"
    wreq.create_request.start_revision = list_rev + 1
    requests.put(wreq)
    assert next(responses).created

    stop = threading.Event()
    applied = []

    def reconcile():
        for resp in responses:
            for ev in resp.events:
                if ev.type == kv_pb2.Event.DELETE:
                    cache.pop(ev.kv.key, None)
                else:
                    cache[ev.kv.key] = ev.kv.value
                applied.append(ev.kv.mod_revision)
            if stop.is_set() and not resp.events:
                return

    t = threading.Thread(target=reconcile, daemon=True)
    t.start()

    # churn: updates + deletes + creates through the same surface
    expected_events = 0
    for i in range(N):
        if i % 4 == 0:
            r = client.delete(PREFIX + b"pod-%03d" % i, revs[i])
            assert r.succeeded
            expected_events += 1
        else:
            r = client.update(PREFIX + b"pod-%03d" % i, b"gen-1", revs[i])
            assert r.succeeded
            expected_events += 1
    for i in range(N, N + 10):
        client.create(PREFIX + b"pod-%03d" % i, b"gen-1")
        expected_events += 1

    deadline = threading.Event()
    for _ in range(200):
        if len(applied) >= expected_events:
            break
        deadline.wait(0.05)
    assert len(applied) >= expected_events, f"saw {len(applied)}/{expected_events}"
    assert applied == sorted(applied), "events out of order"

    # cache must equal a fresh server List
    lst = client.range_(rpc_pb2.RangeRequest(key=PREFIX, range_end=PREFIX[:-1] + b"0"))
    server_state = {kv.key: kv.value for kv in lst.kvs}
    assert cache == server_state
    assert len(server_state) == N - N // 4 + 10

    requests.put(None)
    stop.set()
