"""The port's native brain protocol surface (reference pkg/server/brain),
served on the client port beside etcd3 over the ``cuda`` engine on memkv
with ``--device cpu``: counterparts of ``tests/test_brain_server.py``,
driven with its raw ``BrainClient``."""

import threading

import pytest

from kubebrain_tpu_torch.cli import build_endpoint
from kubebrain_tpu_torch.proto import brain_pb2

from test_brain_server import BrainClient
from test_etcd_server import free_port
from test_torch_etcd_server import port_flags


@pytest.fixture(scope="module")
def brain():
    port = free_port()
    endpoint, backend, store = build_endpoint(port_flags(port))
    endpoint.run()
    client = BrainClient(f"127.0.0.1:{port}")
    yield client, backend
    client.close()
    endpoint.close()
    backend.close()
    store.close()


def test_brain_crud(brain):
    c, _ = brain
    r = c.create(brain_pb2.CreateRequest(key=b"/k", value=b"v1"))
    assert r.succeeded and r.revision > 0
    rev1 = r.revision
    dup = c.create(brain_pb2.CreateRequest(key=b"/k", value=b"x"))
    assert not dup.succeeded and dup.revision == rev1

    g = c.get(brain_pb2.GetRequest(key=b"/k"))
    assert g.kv.value == b"v1" and g.kv.revision == rev1

    u = c.update(brain_pb2.UpdateRequest(key=b"/k", value=b"v2", expected_revision=rev1))
    assert u.succeeded
    stale = c.update(brain_pb2.UpdateRequest(key=b"/k", value=b"x", expected_revision=rev1))
    assert not stale.succeeded and stale.latest.value == b"v2"

    d = c.delete(brain_pb2.BrainDeleteRequest(key=b"/k"))
    assert d.succeeded and d.prev_kv.value == b"v2"
    g = c.get(brain_pb2.GetRequest(key=b"/k"))
    assert not g.HasField("kv")


def test_brain_range_stream_count_partitions(brain):
    c, _ = brain
    for i in range(25):
        c.create(brain_pb2.CreateRequest(key=b"/data/i%03d" % i, value=b"v"))
    r = c.range(brain_pb2.BrainRangeRequest(start=b"/data/", end=b"/data0", limit=10))
    assert len(r.kvs) == 10 and r.more
    total = []
    for resp in c.range_stream(brain_pb2.BrainRangeRequest(start=b"/data/", end=b"/data0")):
        total.extend(resp.kvs)
    assert len(total) == 25
    cnt = c.count(brain_pb2.CountRequest(start=b"/data/", end=b"/data0"))
    assert cnt.count == 25
    lp = c.list_partition(brain_pb2.ListPartitionRequest(start=b"/data/", end=b"/data0"))
    assert lp.borders[0] == b"/data/" and lp.borders[-1] == b"/data0"


def test_brain_watch_and_compact(brain):
    c, backend = brain
    events = []
    started = threading.Event()

    def consume():
        stream = c.watch(brain_pb2.BrainWatchRequest(prefix=b"/watched/"))
        started.set()
        for resp in stream:
            events.extend(resp.events)
            if len(events) >= 2:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    started.wait(5)
    import time

    time.sleep(0.2)  # let the server register the watcher
    r = c.create(brain_pb2.CreateRequest(key=b"/watched/a", value=b"v1"))
    c.update(brain_pb2.UpdateRequest(key=b"/watched/a", value=b"v2", expected_revision=r.revision))
    t.join(timeout=5)
    assert [e.type for e in events[:2]] == [brain_pb2.CREATE, brain_pb2.PUT]
    assert events[1].prev_revision == r.revision

    done = c.compact(brain_pb2.BrainCompactRequest(revision=backend.current_revision()))
    assert done.compacted_revision == backend.current_revision()


def test_background_compact_loop():
    """The leader's periodic compaction actually runs and advances the
    watermark (reference brain/server.go:64-74, 60s loop, keep-1000)."""
    import time

    from kubebrain_tpu_torch.backend import Backend, BackendConfig
    from kubebrain_tpu_torch.server.brain import BrainServer
    from kubebrain_tpu_torch.storage import new_storage

    store = new_storage("cuda", inner="memkv", device="cpu")
    b = Backend(store, BackendConfig(event_ring_capacity=4096))
    srv = BrainServer(b, peers=None, compact_interval=0.2, compact_keep=5)
    K = b"/registry/loop/a"
    rev = b.create(K, b"v0")
    for i in range(20):
        rev = b.update(K, b"v%d" % (i + 1), rev)
    srv.start_background()
    deadline = time.time() + 10
    while time.time() < deadline and b.compact_revision() == 0:
        time.sleep(0.05)
    assert b.compact_revision() >= rev - 5 - 1
    srv.close()
    b.close()
    store.close()
