"""The port's client library (``kubebrain_tpu_torch/client.py``) against
the port's server on the CPU: the four cases of ``tests/test_client.py``
(partition-parallel listing over the ``cuda`` engine's partitions), the
client-library cases the port's front tests ran with the JAX client
(lease lifecycle, traceparent), and a differential in which the JAX client
and the port client run one script against one server and must return
equal values: kvs, counts, revisions, watch events, lease TTLs, and
``classify_rpc_error`` on the same statuses."""

import json
import time
import urllib.request

import grpc
import pytest

from kubebrain_tpu import client as jax_client
from kubebrain_tpu_torch import client as port_client
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.client import BrainClient, EtcdCompatClient
from kubebrain_tpu_torch.endpoint import Endpoint, EndpointConfig
from kubebrain_tpu_torch.metrics import NoopMetrics
from kubebrain_tpu_torch.server import Server
from kubebrain_tpu_torch.server.service import SingleNodePeerService
from kubebrain_tpu_torch.storage import new_storage

from test_etcd_server import free_port


@pytest.fixture(scope="module")
def served():
    # cuda engine over memkv on the CPU, 4 mirror partitions: partition-
    # parallel listing fans out over them
    store = new_storage("cuda", inner="memkv", device="cpu", partitions=4)
    backend = Backend(store, BackendConfig(event_ring_capacity=8192))
    backend.scanner._merge_threshold = 16
    peers = SingleNodePeerService(backend)
    server = Server(backend, peers, NoopMetrics())
    port, info_port = free_port(), free_port()
    ep = Endpoint(server, NoopMetrics(), EndpointConfig(
        host="127.0.0.1", client_port=port,
        peer_port=free_port(), info_port=info_port,
    ))
    ep.run()
    yield f"127.0.0.1:{port}", backend, info_port
    ep.close()
    backend.close()
    store.close()


def test_etcd_client_crud_watch(served):
    target, _, _ = served
    c = EtcdCompatClient(target)
    ok, rev = c.create(b"/registry/cl/a", b"v1")
    assert ok
    dup_ok, dup_rev = c.create(b"/registry/cl/a", b"zzz")
    assert not dup_ok and dup_rev == rev
    events, cancel = c.watch(b"/registry/cl/", b"/registry/cl0", prev_kv=True)
    ok, rev2 = c.update(b"/registry/cl/a", b"v2", rev)
    assert ok and rev2 > rev
    kind, kv, prev = next(events)
    # prev_kv rides DELETE events only (like the reference shim,
    # backendshim.go:372-412 — updates don't read the old value)
    assert kind == "PUT" and kv.value == b"v2"
    assert c.delete(b"/registry/cl/a", rev2)
    kind, kv, prev = next(events)
    assert kind == "DELETE" and prev is not None and prev.value == b"v2"
    cancel()
    assert c.get(b"/registry/cl/a") is None
    c.close()


def test_etcd_client_pagination_and_count(served):
    target, _, _ = served
    c = EtcdCompatClient(target)
    for i in range(25):
        c.create(b"/registry/pg/i%03d" % i, b"v%d" % i)
    kvs, rev = c.list(b"/registry/pg/", b"/registry/pg0", page=7)
    assert len(kvs) == 25 and rev > 0
    assert [kv.key for kv in kvs] == sorted(kv.key for kv in kvs)
    assert c.count(b"/registry/pg/", b"/registry/pg0") == 25
    limited, _ = c.list(b"/registry/pg/", b"/registry/pg0", limit=10, page=4)
    assert len(limited) == 10
    c.close()


def test_parallel_list_matches_plain_list(served):
    target, backend, _ = served
    c = EtcdCompatClient(target)
    for i in range(60):
        c.create(b"/registry/par/p%04d" % i, b"val-%d" % i)
    backend.scanner.publish()  # ensure mirror partitions exist
    borders = c.partition_borders(b"/registry/par/", b"/registry/par0")
    assert len(borders) >= 2
    plain, _ = c.list(b"/registry/par/", b"/registry/par0")
    par = list(c.parallel_list(b"/registry/par/", b"/registry/par0"))
    assert [(kv.key, kv.value) for kv in par] == [(kv.key, kv.value) for kv in plain]
    c.close()


def test_brain_client(served):
    target, _, _ = served
    c = BrainClient(target)
    ok, rev = c.create(b"/brain/x", b"1")
    assert ok
    ok, rev2 = c.update(b"/brain/x", b"2", rev)
    assert ok
    assert c.get(b"/brain/x").value == b"2"
    kvs, more = c.range(b"/brain/", b"/brain0")
    assert len(kvs) == 1 and not more
    assert c.count(b"/brain/", b"/brain0") == 1
    assert len(c.list_partition(b"/brain/", b"/brain0")) >= 2
    streamed = list(c.range_stream(b"/brain/", b"/brain0"))
    assert len(streamed) == 1
    ok, _ = c.delete(b"/brain/x", rev2)
    assert ok
    c.close()


# ------------------------------------------------------------ differential
def _script(client_mod, target: str, tag: bytes) -> list:
    """One client script on ``target`` under ``/registry/diff/<tag>/``:
    writes (create, duplicate create, CAS update, stale CAS, delete), a
    paged list, a count, a read at an old revision, a watch from the first
    write with ``prev_kv``, and a lease with an attached key. Revisions are
    returned relative to the server's revision when the script starts and
    keys without the tag, so two runs on one server compare equal."""
    c = client_mod.EtcdCompatClient(target)
    base = c.current_revision()
    pre = b"/registry/diff/" + tag + b"/"
    end = pre[:-1] + b"0"

    def k(name):
        return pre + name

    def rel(kvs):
        return [(kv.key[len(pre):], kv.value, kv.mod_revision - base)
                for kv in kvs]

    try:
        out = []
        ok, r1 = c.create(k(b"a"), b"v1")
        out.append(("create", ok, r1 - base))
        ok, r = c.create(k(b"a"), b"dup")
        out.append(("dup", ok, r - base))
        ok, r2 = c.update(k(b"a"), b"v2", r1)
        out.append(("update", ok, r2 - base))
        ok, r = c.update(k(b"a"), b"stale", r1)
        out.append(("stale", ok, r - base))
        for name in (b"b", b"c", b"d"):
            ok, r = c.create(k(name), b"val-" + name)
            out.append(("create", ok, r - base))
        out.append(("delete", c.delete(k(b"b"), 0)))
        kvs, rev = c.list(pre, end, page=2)
        out.append(("list", rel(kvs), rev - base))
        out.append(("count", c.count(pre, end)))
        out.append(("old", c.get(k(b"a"), revision=r1).value))
        events, cancel = c.watch(pre, end, start_revision=r1, prev_kv=True)
        seen = []
        for _ in range(6):
            kind, kv, prev = next(events)
            seen.append((kind, kv.key[len(pre):], kv.value,
                         kv.mod_revision - base,
                         None if prev is None else prev.value))
        cancel()
        out.append(("watch", seen))
        lease_id, granted = c.lease_grant(60)
        ok, r = c.create(k(b"leased"), b"l", lease=lease_id)
        ttl, granted2, keys = c.lease_time_to_live(lease_id, keys=True)
        assert 0 < ttl <= granted2
        out.append(("lease", granted, granted2,
                    [key[len(pre):] for key in keys], ok, r - base))
        c.lease_revoke(lease_id)
        out.append(("revoked", c.lease_time_to_live(lease_id)[0],
                    c.get(k(b"leased"))))
        return out
    finally:
        c.close()


class _Status(grpc.RpcError):
    def __init__(self, code, details):
        self._code, self._details = code, details

    def code(self):
        return self._code

    def details(self):
        return self._details


def test_jax_and_port_clients_agree_on_one_server(served):
    """The JAX client and the port's run one script against the port's
    server and return equal values; both then read the same state alike
    (kvs with their revisions, counts), and classify the same statuses,
    synthetic and real, alike."""
    target, _, _ = served
    jax_out = _script(jax_client, target, b"j")
    port_out = _script(port_client, target, b"p")
    assert port_out == jax_out
    assert jax_out[0] == ("create", True, 1)
    clients = [jax_client.EtcdCompatClient(target),
               port_client.EtcdCompatClient(target)]
    try:
        reads = []
        for c in clients:
            kvs, rev = c.list(b"/registry/diff/", b"/registry/diff0", page=3)
            kv = c.get(b"/registry/diff/p/a")
            reads.append(([(x.key, x.value, x.mod_revision) for x in kvs], rev,
                          c.count(b"/registry/diff/", b"/registry/diff0"),
                          (kv.key, kv.value, kv.mod_revision),
                          c.current_revision()))
        assert reads[0] == reads[1] and reads[0][2] == 6
        # a real refusal: a read below the compaction
        head = clients[1].current_revision()
        clients[1].compact(head - 1)
        errors = []
        for c in clients:
            with pytest.raises(grpc.RpcError) as ei:
                c.get(b"/registry/diff/p/a", revision=2)
            errors.append(ei.value)
    finally:
        for c in clients:
            c.close()
    assert [e.code() for e in errors] == [grpc.StatusCode.OUT_OF_RANGE] * 2
    details = ("", "etcdserver: not leader", "connection reset")
    cases = [_Status(code, d) for code in grpc.StatusCode for d in details]
    cases += errors
    for write in (False, True):
        verdicts = [(jax_client.classify_rpc_error(e, write),
                     port_client.classify_rpc_error(e, write)) for e in cases]
        assert all(j == p for j, p in verdicts)
        assert {p for _j, p in verdicts} == (
            {"safe", "definite", "ambiguous"} if write
            else {"safe", "definite"})


def test_port_client_lease_lifecycle_and_traceparent():
    """The wire lease lifecycle and trace-context cases the port's front
    tests run with the JAX client (``test_torch_front_wire.py``,
    ``test_torch_trace_front.py``), with the port's: a 1 s lease expires
    into a watched DELETE at a real revision, and the client's calls come
    out as parented server spans in ``/debug/traces``."""
    from kubebrain_tpu_torch.cli import build_endpoint

    from test_torch_etcd_server import port_flags

    port, info_port = free_port(), free_port()
    endpoint, backend, store = build_endpoint(port_flags(
        port, "--lease-reap-interval", "0.1", "--info-port", str(info_port)))
    endpoint.run()
    c = EtcdCompatClient(f"127.0.0.1:{port}")
    try:
        key = b"/registry/pods/default/leased"
        events, cancel = c.watch(b"/registry/pods/", b"/registry/pods0")
        lease_id, granted = c.lease_grant(1)
        ok, rev = c.create(key, b"spec", lease=lease_id)
        assert ok and granted == 1
        assert c.lease_time_to_live(lease_id, keys=True)[2] == [key]
        assert next(events)[:2][0] == "PUT"
        kind, kv, _prev = next(events)  # the reaper's expiry delete
        assert (kind, kv.key) == ("DELETE", key) and kv.mod_revision > rev
        cancel()
        assert c.get(key) is None and c.lease_time_to_live(lease_id)[0] == -1
        c.list(b"/registry/pods/", b"/registry/pods0")
        deadline = time.monotonic() + 10
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{info_port}/debug/traces",
                    timeout=10) as resp:
                snap = json.loads(resp.read())
            if any(t["parent_id"] is not None and t["name"] == "etcd.KV/Range"
                   for t in snap["traces"]):
                break
            assert time.monotonic() < deadline, "no parented Range span"
            time.sleep(0.05)
    finally:
        c.close()
        endpoint.close()
        backend.close()
        store.close()
