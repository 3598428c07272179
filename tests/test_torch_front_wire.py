"""The scheduler's and the lease subsystem's wire behavior through the
port's front, over the ``cuda`` engine on memkv with ``device="cpu"``:
counterparts of ``tests/test_sched.py::
test_shed_returns_resource_exhausted_on_wire`` and of the wire tests of
``tests/test_lease.py`` (follower refusal, keepalives under a 10x
overload, and the lease lifecycle driven by the JAX package's client
library)."""

import threading
import time
import urllib.request

import grpc
import pytest

from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.cli import build_endpoint
from kubebrain_tpu_torch.lease import ensure_lease
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.sched import (
    Lane,
    SchedConfig,
    SchedOverloadError,
    ensure_scheduler,
)
from kubebrain_tpu_torch.server.etcd.misc import LeaseNotLeaderError, LeaseService
from kubebrain_tpu_torch.storage import new_storage

from test_etcd_server import EtcdClient, free_port
from test_torch_etcd_server import port_flags


def make_backend():
    store = new_storage("cuda", inner="memkv", device="cpu")
    return Backend(store, BackendConfig(event_ring_capacity=4096)), store


# ================================================================ shedding
@pytest.fixture()
def overloaded_endpoint():
    """A live endpoint whose backend list path is artificially slow and
    whose scheduler queue is tiny — Range floods must shed."""
    from kubebrain_tpu_torch.endpoint import Endpoint, EndpointConfig
    from kubebrain_tpu_torch.metrics.prom import PrometheusMetrics
    from kubebrain_tpu_torch.server import Server
    from kubebrain_tpu_torch.server.service import SingleNodePeerService

    backend, store = make_backend()
    metrics = PrometheusMetrics()
    ensure_scheduler(backend, SchedConfig(depth=1, queue_limit=2,
                                          shed_ms=30_000.0), metrics=metrics)
    slow_list = backend.list_

    def slowed(*a, **kw):
        time.sleep(0.15)
        return slow_list(*a, **kw)

    backend.list_ = slowed
    peers = SingleNodePeerService(backend)
    server = Server(backend, peers, metrics)
    cport, info = free_port(), free_port()
    ep = Endpoint(server, metrics, EndpointConfig(
        host="127.0.0.1", client_port=cport,
        peer_port=free_port(), info_port=info,
    ))
    ep.run()
    yield f"127.0.0.1:{cport}", info, backend
    ep.close()
    backend.close()
    store.close()


def test_shed_returns_resource_exhausted_on_wire(overloaded_endpoint):
    target, info_port, backend = overloaded_endpoint
    c = EtcdClient(target)
    for i in range(5):
        c.create(b"/registry/pods/p%02d" % i, b"v")

    codes: list = []
    details: list = []

    def one_list(i):
        try:
            # distinct limits => distinct coalesce keys: identical requests
            # would legitimately merge into one execution and never shed
            c.range_(rpc_pb2.RangeRequest(
                key=b"/registry/pods/", range_end=b"/registry/pods0",
                limit=i + 1))
            codes.append("ok")
        except grpc.RpcError as e:
            codes.append(e.code())
            details.append(e.details())

    threads = [threading.Thread(target=one_list, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)

    shed = [x for x in codes if x == grpc.StatusCode.RESOURCE_EXHAUSTED]
    assert shed, codes  # 16 concurrent vs depth 1 + queue 2: must shed
    assert any("etcdserver: too many requests" in d for d in details), details
    assert "ok" in codes  # admitted requests still served

    body = urllib.request.urlopen(
        f"http://127.0.0.1:{info_port}/metrics", timeout=10
    ).read().decode()
    assert "kb_sched_shed_total" in body, body[:2000]
    assert "kb_sched_queue_depth" in body
    assert "kb_sched_inflight" in body
    sched = backend._kb_scheduler
    assert sum(sched.shed_counts.values()) >= len(shed)
    c.close()


# ================================================================= leases
def test_followers_refuse_lease_rpcs():
    """Lease state lives on the leader: a follower must refuse keepalive /
    TimeToLive / Leases (UNAVAILABLE → client retries the leader) instead
    of answering from its stale local table."""

    class FollowerPeers:
        def is_leader(self):
            return False

    class AbortCalled(Exception):
        pass

    class Ctx:
        code = None

        def abort(self, code, details):
            self.code = code
            raise AbortCalled(details)

        def invocation_metadata(self):
            return ()

    b, store = make_backend()
    try:
        svc = LeaseService(b, peers=FollowerPeers())
        with pytest.raises(LeaseNotLeaderError):
            svc.keepalive_one(rpc_pb2.LeaseKeepAliveRequest(ID=1))
        for call, req in (
            (svc.LeaseGrant, rpc_pb2.LeaseGrantRequest(TTL=5)),
            (svc.LeaseRevoke, rpc_pb2.LeaseRevokeRequest(ID=1)),
            (svc.LeaseTimeToLive, rpc_pb2.LeaseTimeToLiveRequest(ID=1)),
            (svc.LeaseLeases, rpc_pb2.LeaseLeasesRequest()),
        ):
            ctx = Ctx()
            with pytest.raises(AbortCalled):
                call(req, ctx)
            assert ctx.code == grpc.StatusCode.UNAVAILABLE
    finally:
        b.close()
        store.close()


def test_keepalive_not_shed_at_10x_overload():
    """Keepalives ride the scheduler's SYSTEM lane: with the background
    lane 10x oversubscribed, every keepalive must still succeed — a shed
    keepalive would expire a healthy client's lease and cascade into key
    deletion."""
    b, store = make_backend()
    sched = ensure_scheduler(b, SchedConfig(depth=1, queue_limit=16,
                                            shed_ms=30_000.0))
    ensure_lease(b, reap_interval=60.0, checkpoint_interval=60.0)
    svc = LeaseService(b)
    lease = svc.registry.grant(30)

    stop = threading.Event()
    sheds = [0]

    def flood():
        # keep the background queue pinned at 10x its limit
        while not stop.is_set():
            for _ in range(10 * 16):
                try:
                    sched.submit_async(lambda: time.sleep(0.005),
                                       lane=Lane.BACKGROUND, client="flood")
                except SchedOverloadError:
                    sheds[0] += 1
            time.sleep(0.002)

    flooder = threading.Thread(target=flood, daemon=True)
    flooder.start()
    try:
        time.sleep(0.05)  # let the flood saturate the lane
        for _ in range(20):
            resp = svc.keepalive_one(rpc_pb2.LeaseKeepAliveRequest(ID=lease.id))
            assert resp.TTL > 0  # refreshed, never shed, never expired
        assert sheds[0] > 0, "flood never oversubscribed the background lane"
        assert svc.registry.time_to_live(lease.id)[0] > 0
    finally:
        stop.set()
        flooder.join(timeout=5)
        b.close()
        store.close()


@pytest.fixture(scope="module")
def server():
    from kubebrain_tpu.client import EtcdCompatClient

    port = free_port()
    endpoint, backend, store = build_endpoint(port_flags(
        port, "--lease-reap-interval", "0.1",
        "--lease-checkpoint-interval", "60"))
    endpoint.run()
    client = EtcdCompatClient(f"127.0.0.1:{port}")
    yield client, backend
    client.close()
    endpoint.close()
    backend.close()
    store.close()


K_LEASED = b"/registry/pods/default/leased-pod"


def test_wire_lease_lifecycle_with_expiry(server):
    """etcd3 wire acceptance: grant → put-with-lease → TimeToLive(keys) →
    expiry → watcher sees DELETE at a real mod_revision → TTL=-1."""
    client, _backend = server
    events, cancel = client.watch(b"/registry/pods/", b"/registry/pods0")

    lease_id, granted = client.lease_grant(1)
    assert lease_id > 0 and granted == 1
    ok, rev = client.create(K_LEASED, b"spec", lease=lease_id)
    assert ok and rev > 0

    ttl, g, keys = client.lease_time_to_live(lease_id, keys=True)
    assert ttl >= 0 and g == 1 and keys == [K_LEASED]
    assert lease_id in client.lease_leases()

    kind, kv, _prev = next(events)  # the create
    assert (kind, kv.key) == ("PUT", K_LEASED)
    kind, kv, _prev = next(events)  # the reaper's expiry delete
    assert (kind, kv.key) == ("DELETE", K_LEASED)
    assert kv.mod_revision > rev  # revision-stamped, sequenced after create
    cancel()

    assert client.get(K_LEASED) is None
    assert client.lease_time_to_live(lease_id)[0] == -1
    assert lease_id not in client.lease_leases()

    # a watcher started AFTER expiry replays the delete from the cache
    late_events, late_cancel = client.watch(
        b"/registry/pods/", b"/registry/pods0", start_revision=rev)
    kinds = [next(late_events)[0] for _ in range(2)]
    assert kinds == ["PUT", "DELETE"]
    late_cancel()


def test_wire_keepalive_extends_and_revoke_deletes(server):
    """The client lease() helper: background keepalive holds a 1s-TTL lease
    alive well past its granted TTL; revoke deletes the attached key."""
    client, _backend = server
    h = client.lease(ttl=1, keepalive_interval=0.25)
    key = b"/registry/pods/default/kept-alive"
    ok, _rev = client.create(key, b"spec", lease=h.id)
    assert ok
    time.sleep(2.2)  # > 2x the granted TTL: only keepalives explain survival
    assert h.alive
    assert client.get(key) is not None
    assert client.lease_time_to_live(h.id)[0] >= 0

    h.revoke()
    assert client.get(key) is None
    assert client.lease_time_to_live(h.id)[0] == -1


def test_wire_put_under_unknown_lease_fails(server):
    client, _backend = server
    with pytest.raises(grpc.RpcError) as ei:
        client.create(b"/registry/pods/default/orphan", b"v", lease=987654321)
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND
    assert "lease not found" in ei.value.details()
    assert client.get(b"/registry/pods/default/orphan") is None
