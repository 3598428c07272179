"""The port's etcd3 gRPC front, end to end: a raw grpcio client speaking
etcdserverpb against ``kubebrain_tpu_torch.cli.build_endpoint`` over the
``cuda`` engine (on memkv unless a test says otherwise) with
``--device cpu``. Counterparts of ``tests/test_etcd_server.py``; the raw
client (``EtcdClient``) and the backup tool of one case
(``kubebrain_tpu.tools``) are the JAX package's, since the generated
messages are one set of classes; the port's tool is held to it byte for
byte.
"""

import pathlib
import queue

import grpc
import pytest

from kubebrain_tpu_torch.cli import build_endpoint, build_parser
from kubebrain_tpu_torch.proto import kv_pb2, rpc_pb2

from test_etcd_server import EtcdClient, free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent


def port_flags(client_port: int, *extra: str) -> list[str]:
    """The port's server on ``client_port``: single node, ``cuda`` over
    memkv on the CPU, fresh peer and info ports; ``extra`` flags after
    (a later flag wins)."""
    peer = free_port()
    return ["--single-node", "--storage", "cuda", "--inner-storage", "memkv",
            "--device", "cpu", "--host", "127.0.0.1",
            "--identity", f"127.0.0.1:{peer}",
            "--client-port", str(client_port), "--peer-port", str(peer),
            "--info-port", str(free_port()), *extra]


@pytest.fixture(scope="module")
def server():
    port = free_port()
    args = build_parser().parse_args(port_flags(port))
    endpoint, backend, store = build_endpoint(args)
    endpoint.run()
    client = EtcdClient(f"127.0.0.1:{port}")
    yield client, backend, args
    client.close()
    endpoint.close()
    backend.close()
    store.close()


K = b"/registry/pods/default/nginx"


def test_create_get_update_delete_txn_flow(server):
    client, backend, _ = server
    resp = client.create(K, b"spec-v1")
    assert resp.succeeded
    rev1 = resp.responses[0].response_put.header.revision
    assert rev1 > 0

    # duplicate create fails; failure branch returns current kv
    resp = client.create(K, b"other")
    assert not resp.succeeded
    assert resp.responses[0].response_range.kvs[0].mod_revision == rev1
    assert resp.responses[0].response_range.kvs[0].value == b"spec-v1"

    # get via Range (no range_end)
    r = client.range_(rpc_pb2.RangeRequest(key=K))
    assert r.count == 1 and r.kvs[0].value == b"spec-v1"

    # guarded update
    resp = client.update(K, b"spec-v2", rev1)
    assert resp.succeeded
    rev2 = resp.responses[0].response_put.header.revision
    # stale guard fails with current kv in failure branch
    resp = client.update(K, b"nope", rev1)
    assert not resp.succeeded
    assert resp.responses[0].response_range.kvs[0].mod_revision == rev2

    # guarded delete
    resp = client.delete(K, rev2)
    assert resp.succeeded
    r = client.range_(rpc_pb2.RangeRequest(key=K))
    assert r.count == 0


def test_list_count_pagination(server):
    client, _, _ = server
    for i in range(10):
        client.create(b"/registry/cm/item%02d" % i, b"v%d" % i)
    r = client.range_(rpc_pb2.RangeRequest(key=b"/registry/cm/", range_end=b"/registry/cm0"))
    assert r.count == 10 and not r.more
    r = client.range_(
        rpc_pb2.RangeRequest(key=b"/registry/cm/", range_end=b"/registry/cm0", limit=4)
    )
    assert len(r.kvs) == 4 and r.more
    # apiserver continuation: start from last key + \x00
    cont = r.kvs[-1].key + b"\x00"
    r2 = client.range_(
        rpc_pb2.RangeRequest(key=cont, range_end=b"/registry/cm0", limit=100)
    )
    assert len(r2.kvs) == 6
    # count_only
    r = client.range_(
        rpc_pb2.RangeRequest(key=b"/registry/cm/", range_end=b"/registry/cm0", count_only=True)
    )
    assert r.count == 10 and not r.kvs


def test_snapshot_list_and_compaction_error(server):
    client, backend, _ = server
    resp = client.create(b"/registry/snap/a", b"1")
    rev1 = resp.responses[0].response_put.header.revision
    client.update(b"/registry/snap/a", b"2", rev1)
    r = client.range_(
        rpc_pb2.RangeRequest(key=b"/registry/snap/", range_end=b"/registry/snap0", revision=rev1)
    )
    assert r.kvs[0].value == b"1"
    # compact past rev1, stale read must fail with the etcd error string
    client.compact(rpc_pb2.CompactionRequest(revision=backend.current_revision()))
    with pytest.raises(grpc.RpcError) as ei:
        client.range_(
            rpc_pb2.RangeRequest(
                key=b"/registry/snap/", range_end=b"/registry/snap0", revision=rev1
            )
        )
    assert ei.value.code() == grpc.StatusCode.OUT_OF_RANGE
    assert "compacted" in ei.value.details()


def test_watch_stream(server):
    client, _, _ = server
    requests: queue.Queue = queue.Queue()
    responses = client.watch(iter(requests.get, None))
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/registry/watched/"
    req.create_request.range_end = b"/registry/watched0"
    req.create_request.prev_kv = True
    requests.put(req)

    created = next(responses)
    assert created.created
    watch_id = created.watch_id

    resp = client.create(b"/registry/watched/pod1", b"w1")
    rev1 = resp.responses[0].response_put.header.revision
    client.update(b"/registry/watched/pod1", b"w2", rev1)

    events = []
    while len(events) < 2:
        wr = next(responses)
        events.extend(wr.events)
    assert events[0].type == kv_pb2.Event.PUT and events[0].kv.value == b"w1"
    assert events[1].kv.value == b"w2"
    assert events[1].kv.mod_revision > events[0].kv.mod_revision

    # delete event carries prev_kv
    client.delete(b"/registry/watched/pod1", events[1].kv.mod_revision)
    wr = next(responses)
    assert wr.events[0].type == kv_pb2.Event.DELETE
    assert wr.events[0].prev_kv.value == b"w2"

    # cancel
    creq = rpc_pb2.WatchRequest()
    creq.cancel_request.watch_id = watch_id
    requests.put(creq)
    wr = next(responses)
    assert wr.canceled
    requests.put(None)


def test_watch_from_revision_replays(server):
    client, backend, _ = server
    resp = client.create(b"/registry/replay/a", b"1")
    rev1 = resp.responses[0].response_put.header.revision
    client.create(b"/registry/replay/b", b"2")

    requests: queue.Queue = queue.Queue()
    responses = client.watch(iter(requests.get, None))
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/registry/replay/"
    req.create_request.range_end = b"/registry/replay0"
    req.create_request.start_revision = rev1
    requests.put(req)
    assert next(responses).created
    events = []
    while len(events) < 2:
        events.extend(next(responses).events)
    assert [e.kv.value for e in events] == [b"1", b"2"]
    requests.put(None)


def test_watch_compacted_revision_cancels(server):
    client, backend, _ = server
    resp = client.create(b"/registry/wcomp/a", b"1")
    rev1 = resp.responses[0].response_put.header.revision
    client.update(b"/registry/wcomp/a", b"2", rev1)
    client.compact(rpc_pb2.CompactionRequest(revision=backend.current_revision()))
    requests: queue.Queue = queue.Queue()
    responses = client.watch(iter(requests.get, None))
    req = rpc_pb2.WatchRequest()
    req.create_request.key = b"/registry/"
    req.create_request.range_end = b"/registry0"
    req.create_request.start_revision = rev1  # below the compact watermark
    requests.put(req)
    wr = next(responses)
    assert wr.canceled and wr.compact_revision >= 1
    requests.put(None)


def test_compactor_coordination_protocol(server):
    """The kube-apiserver compactor's txn dance on compact_rev_key."""
    client, _, _ = server
    # first run: version token 0 => create
    resp = client.compact_coordination(0, b"100")
    if not resp.succeeded:
        # key exists from a previous test run: read token and retry
        token = resp.responses[0].response_range.kvs[0].version
        resp = client.compact_coordination(token, b"100")
    assert resp.succeeded
    # another replica with a stale token loses and reads the fresh token
    resp2 = client.compact_coordination(0, b"200")
    assert not resp2.succeeded
    kv = resp2.responses[0].response_range.kvs[0]
    assert kv.value == b"100" and kv.version > 0
    # retry with the fresh token wins
    resp3 = client.compact_coordination(kv.version, b"200")
    assert resp3.succeeded


def test_lease_and_memberlist_and_status(server):
    client, _, _ = server
    lg = client.lease_grant(rpc_pb2.LeaseGrantRequest(TTL=3600))
    # real lease subsystem: a server-chosen id, not the old ID:=TTL stub
    assert lg.ID > 0 and lg.TTL == 3600
    ml = client.member_list(rpc_pb2.MemberListRequest())
    assert len(ml.members) == 1
    st = client.status(rpc_pb2.StatusRequest())
    assert "kubebrain-tpu" in st.version


def test_raw_put_rejected(server):
    client, _, _ = server
    put = client.ch.unary_unary(
        "/etcdserverpb.KV/Put",
        request_serializer=rpc_pb2.PutRequest.SerializeToString,
        response_deserializer=rpc_pb2.PutResponse.FromString,
    )
    with pytest.raises(grpc.RpcError) as ei:
        put(rpc_pb2.PutRequest(key=b"/x", value=b"y"))
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_partition_magic_revision(server):
    client, _, _ = server
    r = client.range_(
        rpc_pb2.RangeRequest(
            key=b"/registry/", range_end=b"/registry0", revision=1888
        )
    )
    borders = [kv.key for kv in r.kvs]
    assert borders[0] == b"/registry/" and borders[-1] == b"/registry0"


def test_http_status_and_health(server):
    client, backend, args = server
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{args.peer_port}/status", timeout=5) as resp:
        payload = json.loads(resp.read())
    assert payload["revision"] == backend.current_revision()
    assert payload["is_leader"] is True
    with urllib.request.urlopen(f"http://127.0.0.1:{args.peer_port}/health", timeout=5) as resp:
        assert json.loads(resp.read())["health"] == "true"
    with urllib.request.urlopen(f"http://127.0.0.1:{args.info_port}/metrics", timeout=5) as resp:
        assert resp.status == 200


def test_maintenance_snapshot_and_defrag(server):
    client, backend, _ = server
    client.create(b"/registry/snapme/a", b"payload-a")
    client.create(b"/registry/snapme/b", b"payload-b")
    snap = client.ch.unary_stream(
        "/etcdserverpb.Maintenance/Snapshot",
        request_serializer=rpc_pb2.SnapshotRequest.SerializeToString,
        response_deserializer=rpc_pb2.SnapshotResponse.FromString,
    )
    blob = b""
    for resp in snap(rpc_pb2.SnapshotRequest()):
        blob += resp.blob
        last_remaining = resp.remaining_bytes
    assert last_remaining == 0
    assert blob.startswith(b"KBSNAP1")
    assert b"/registry/snapme/a" in blob and b"payload-b" in blob
    defrag = client.ch.unary_unary(
        "/etcdserverpb.Maintenance/Defragment",
        request_serializer=rpc_pb2.DefragmentRequest.SerializeToString,
        response_deserializer=rpc_pb2.DefragmentResponse.FromString,
    )
    assert defrag(rpc_pb2.DefragmentRequest()).header.revision > 0


def test_lease_keepalive_and_revoke(server):
    client, _, _ = server
    lg = client.lease_grant(rpc_pb2.LeaseGrantRequest(TTL=60))
    ka = client.ch.stream_stream(
        "/etcdserverpb.Lease/LeaseKeepAlive",
        request_serializer=rpc_pb2.LeaseKeepAliveRequest.SerializeToString,
        response_deserializer=rpc_pb2.LeaseKeepAliveResponse.FromString,
    )
    # a live lease refreshes to its granted TTL; an unknown one gets the
    # etcd TTL=0 encoding of "lease not found"
    resp = next(ka(iter([rpc_pb2.LeaseKeepAliveRequest(ID=lg.ID)])))
    assert resp.ID == lg.ID and resp.TTL == 60
    resp = next(ka(iter([rpc_pb2.LeaseKeepAliveRequest(ID=999999)])))
    assert resp.TTL == 0
    revoke = client.ch.unary_unary(
        "/etcdserverpb.Lease/LeaseRevoke",
        request_serializer=rpc_pb2.LeaseRevokeRequest.SerializeToString,
        response_deserializer=rpc_pb2.LeaseRevokeResponse.FromString,
    )
    assert revoke(rpc_pb2.LeaseRevokeRequest(ID=lg.ID)).header.revision > 0
    with pytest.raises(grpc.RpcError) as ei:
        revoke(rpc_pb2.LeaseRevokeRequest(ID=lg.ID))  # already gone
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_snapshot_save_restore_roundtrip(server, tmp_path):
    """Backup from one server, restore into a fresh one (tools.py)."""
    import subprocess
    import sys as _sys

    client, backend, args = server
    client.create(b"/registry/backup/a", b"va")
    client.create(b"/registry/backup/b", b"vb")
    snap_path = str(tmp_path / "backup.snap")
    rc = subprocess.run(
        [_sys.executable, "-m", "kubebrain_tpu.tools", "snapshot-save",
         "--endpoint", f"127.0.0.1:{args.client_port}", snap_path],
        cwd=ROOT, capture_output=True,
    )
    assert rc.returncode == 0, rc.stderr.decode()

    from kubebrain_tpu.tools import parse_snapshot

    with open(snap_path, "rb") as f:
        header_rev, kvs = parse_snapshot(f.read())
    keys = {k for k, _, _ in kvs}
    assert b"/registry/backup/a" in keys and b"/registry/backup/b" in keys
    assert header_rev >= max(r for _, _, r in kvs)

    # restore into a brand-new server
    port2 = free_port()
    ep2, be2, st2 = build_endpoint(port_flags(port2))
    ep2.run()
    try:
        rc = subprocess.run(
            [_sys.executable, "-m", "kubebrain_tpu.tools", "snapshot-restore",
             "--endpoint", f"127.0.0.1:{port2}", snap_path],
            cwd=ROOT, capture_output=True,
        )
        assert rc.returncode == 0, rc.stderr.decode()
        c2 = EtcdClient(f"127.0.0.1:{port2}")
        r = c2.range_(rpc_pb2.RangeRequest(key=b"/registry/backup/", range_end=b"/registry/backup0"))
        assert {kv.key: kv.value for kv in r.kvs} == {
            b"/registry/backup/a": b"va", b"/registry/backup/b": b"vb",
        }
        c2.close()
    finally:
        ep2.close()
        be2.close()
        st2.close()


def test_port_snapshot_tool_round_trip(server, tmp_path):
    """The port's tool (``python -m kubebrain_tpu_torch.tools``): its
    snapshot of a server is byte-identical to the JAX tool's of the same
    server, and it restores into a fresh server."""
    import subprocess
    import sys as _sys

    from kubebrain_tpu import tools as jax_tools
    from kubebrain_tpu_torch import tools

    client, backend, args = server
    client.create(b"/registry/backup/port-a", b"pa")
    client.create(b"/registry/backup/port-b", b"pb" * 300)
    endpoint = f"127.0.0.1:{args.client_port}"
    port_path, jax_path = tmp_path / "port.snap", tmp_path / "jax.snap"
    rc = subprocess.run(
        [_sys.executable, "-m", "kubebrain_tpu_torch.tools", "snapshot-save",
         "--endpoint", endpoint, str(port_path)],
        cwd=ROOT, capture_output=True, timeout=120)
    assert rc.returncode == 0, rc.stderr.decode()
    assert jax_tools.snapshot_save(endpoint, str(jax_path)) == 0
    blob = port_path.read_bytes()
    assert blob == jax_path.read_bytes()
    header_rev, kvs = tools.parse_snapshot(blob)
    assert (header_rev, kvs) == jax_tools.parse_snapshot(blob)
    live = {k: v for k, v, _ in kvs if k.startswith(b"/registry/backup/")}
    assert live[b"/registry/backup/port-b"] == b"pb" * 300

    port2 = free_port()
    ep2, be2, st2 = build_endpoint(port_flags(port2))
    ep2.run()
    try:
        assert tools.main(["snapshot-restore", "--endpoint",
                           f"127.0.0.1:{port2}", str(port_path)]) == 0
        c2 = EtcdClient(f"127.0.0.1:{port2}")
        r = c2.range_(rpc_pb2.RangeRequest(key=b"/registry/backup/",
                                           range_end=b"/registry/backup0"))
        assert {kv.key: kv.value for kv in r.kvs} == live
        c2.close()
    finally:
        ep2.close()
        be2.close()
        st2.close()


def test_lease_attached_put_expires():
    """A put with a lease expires via the lease subsystem: the reaper turns
    the expired lease's keys into revision-stamped MVCC deletes (covers
    apiserver masterleases and events uniformly), here over ``cuda`` on
    native."""
    import time as _time

    port = free_port()
    args = build_parser().parse_args(port_flags(
        port, "--inner-storage", "native", "--lease-reap-interval", "0.1"))
    endpoint, backend, store = build_endpoint(args)
    endpoint.run()
    client = EtcdClient(f"127.0.0.1:{port}")
    try:
        lg = client.lease_grant(rpc_pb2.LeaseGrantRequest(TTL=1))
        req = rpc_pb2.TxnRequest()
        c = req.compare.add()
        c.result, c.target, c.key, c.mod_revision = (
            rpc_pb2.Compare.EQUAL, rpc_pb2.Compare.MOD, b"/registry/masterleases/1.2.3.4", 0,
        )
        req.success.add().request_put.CopyFrom(rpc_pb2.PutRequest(
            key=b"/registry/masterleases/1.2.3.4", value=b"lease-me", lease=lg.ID,
        ))
        assert client.txn(req).succeeded
        r = client.range_(rpc_pb2.RangeRequest(key=b"/registry/masterleases/1.2.3.4"))
        assert r.count == 1
        deadline = _time.time() + 5.0
        while _time.time() < deadline:
            r = client.range_(rpc_pb2.RangeRequest(key=b"/registry/masterleases/1.2.3.4"))
            if r.count == 0:
                break
            _time.sleep(0.1)
        assert r.count == 0  # expired with the lease TTL
    finally:
        client.close()
        endpoint.close()
        backend.close()
        store.close()
