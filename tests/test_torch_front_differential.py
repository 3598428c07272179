"""The port's etcd3 front held against the JAX package's front on one
script of requests.

Two servers start on fresh stores: the JAX CLI's ``--storage memkv`` and
the port CLI's ``--storage cuda --inner-storage memkv --device cpu``,
both with ``--single-node`` and the same ``--identity``. Every request of
the script goes to both, and the serialized responses (deterministic
protobuf encoding) must be equal byte for byte; an RPC that fails must
fail on both with the same status code and details. The one field that
differs by construction is named: ``MemberListResponse.members[].
clientURLs`` carries each server's own client port. Lease IDs are chosen
by the client, since a server picks a random one. A Watch opened on each
server before the script must deliver the same events (key, value,
mod_revision, type) in the same order. ``run_differential`` and
``Front(..., listener=...)`` drive the same script through the asyncio
and kbfront listeners (``tests/test_torch_aio_endpoint.py``,
``tests/test_torch_front.py``).

With ``device_path`` the port's mirror serves every Range from the device
path (``scanner._host_limit_threshold = 0``) and the kernel wrappers
count the calls to their plain versions as the chip rehearsal does
(``tests/test_torch_chip_smoke.py``): the script's Ranges reach K1's
wrapper and its Compact reaches K3's, with the answers still equal.
"""

import queue
import threading
import time

import grpc
import pytest

from kubebrain_tpu import cli as jax_cli
from kubebrain_tpu_torch import cli as port_cli
from kubebrain_tpu_torch.ops import compact_kernels, fanout_kernels, scan_kernels
from kubebrain_tpu_torch.proto import rpc_pb2

from test_etcd_server import EtcdClient, free_port
from test_torch_chip_smoke import cpu_shims

IDENTITY = "127.0.0.1:2380"
PODS = (b"/registry/pods/", b"/registry/pods0")
LEASE_ID = 0x5EED


def _flags(*storage: str) -> list[str]:
    return ["--single-node", *storage, "--host", "127.0.0.1",
            "--identity", IDENTITY, "--client-port", str(free_port()),
            "--peer-port", str(free_port()), "--info-port", str(free_port())]


class Front:
    """One running server, its raw client and a Watch on ``/registry/``.
    ``listener`` names the flag of the port the client speaks to:
    ``client_port`` (the sync gRPC front), ``aio_port`` or ``front_port``
    (kbfront), each given a free port here."""

    def __init__(self, cli, flags, listener: str = "client_port"):
        if listener != "client_port":
            flags = [*flags, "--" + listener.replace("_", "-"),
                     str(free_port())]
        args = cli.build_parser().parse_args(flags)
        self.endpoint, self.backend, self.store = cli.build_endpoint(args)
        self.endpoint.run()
        target = f"127.0.0.1:{getattr(args, listener)}"
        if listener == "front_port":
            # kbfront is a second process: wait until it answers
            wait_ready(target)
        self.client = EtcdClient(target)
        self._requests: queue.Queue = queue.Queue()
        self._responses = self.client.watch(iter(self._requests.get, None))
        req = rpc_pb2.WatchRequest()
        req.create_request.key = b"/registry/"
        req.create_request.range_end = b"/registry0"
        self._requests.put(req)
        assert next(self._responses).created
        self.events: list = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        try:
            for resp in self._responses:
                self.events.extend((e.kv.key, e.kv.value, e.kv.mod_revision,
                                    e.type) for e in resp.events)
        except grpc.RpcError:
            pass  # the stream is cancelled at close

    def call(self, method: str, request):
        """(status, response bytes): status None and the deterministic
        encoding, or the error's (code, details) and b""."""
        stub = getattr(self.client, method)
        try:
            resp = stub(request)
        except grpc.RpcError as e:
            return (e.code(), e.details()), b""
        if isinstance(resp, rpc_pb2.MemberListResponse):
            for m in resp.members:
                del m.clientURLs[:]  # each server's own client port
        return None, resp.SerializeToString(deterministic=True)

    def close(self):
        self._requests.put(None)
        self.client.close()
        self.endpoint.close()
        self.backend.close()
        self.store.close()


def wait_ready(target: str, timeout: float = 30.0) -> None:
    ch = grpc.insecure_channel(target)
    try:
        grpc.channel_ready_future(ch).result(timeout=timeout)
    finally:
        ch.close()


def txn(key, mod_rev, put=None, delete=False, lease=0):
    """kube-apiserver's Txn: compare MOD == ``mod_rev``; on success the
    put or the delete, on failure a Range of the key."""
    req = rpc_pb2.TxnRequest()
    c = req.compare.add()
    c.result, c.target, c.key, c.mod_revision = (
        rpc_pb2.Compare.EQUAL, rpc_pb2.Compare.MOD, key, mod_rev)
    if delete:
        req.success.add().request_delete_range.CopyFrom(
            rpc_pb2.DeleteRangeRequest(key=key))
    else:
        req.success.add().request_put.CopyFrom(
            rpc_pb2.PutRequest(key=key, value=put, lease=lease))
    req.failure.add().request_range.CopyFrom(rpc_pb2.RangeRequest(key=key))
    return ("txn", req)


def rng(key=PODS[0], end=PODS[1], **kw):
    return ("range_", rpc_pb2.RangeRequest(key=key, range_end=end, **kw))


def script(run) -> None:
    """The request script; ``run((method, request))`` sends one request to
    both fronts, checks that they agree and returns the port's response
    (parsed) or None for an error."""
    revs = {}
    for ns in (b"a", b"b"):
        for i in range(6):
            key = b"/registry/pods/%s/p%d" % (ns, i)
            revs[key] = run(txn(key, 0, put=b"v0-%s-%d" % (ns, i))).header.revision
    a0, a1, a2 = (b"/registry/pods/a/p%d" % i for i in range(3))
    assert not run(txn(a0, 0, put=b"again")).succeeded       # create of an existing key
    r = run(txn(a0, revs[a0], put=b"v1"))                      # CAS update
    assert r.succeeded
    revs[a0] = r.header.revision
    assert not run(txn(a0, revs[a0] - 1, put=b"stale")).succeeded  # stale CAS
    assert run(txn(a1, revs[a1], delete=True)).succeeded       # delete
    assert not run(txn(a2, revs[a2] + 1000, delete=True)).succeeded  # failed compare
    head = run(rng(PODS[0] + b"a/p0", b"")).header.revision
    run(rng())
    run(rng(limit=3))
    run(rng(revision=revs[a0] - 1))
    run(rng(count_only=True))
    run(rng(keys_only=True))
    run(rng(PODS[0] + b"b/", PODS[0] + b"b0", count_only=True))
    # a page run: continue from the last key + NUL until no more
    key = PODS[0]
    while True:
        page = run(rng(key, PODS[1], limit=4))
        if not page.more:
            break
        key = page.kvs[-1].key + b"\0"
    # a lease, a key under it, its keys, then the revoke deletes the key
    leased = b"/registry/events/a/e1"
    run(("lease_grant", rpc_pb2.LeaseGrantRequest(TTL=3600, ID=LEASE_ID)))
    run(("lease_grant", rpc_pb2.LeaseGrantRequest(TTL=3600, ID=LEASE_ID)))  # exists
    assert run(txn(leased, 0, put=b"event", lease=LEASE_ID)).succeeded
    run(txn(b"/registry/events/a/e2", 0, put=b"orphan", lease=LEASE_ID + 1))  # unknown
    run(("lease_ttl", rpc_pb2.LeaseTimeToLiveRequest(ID=LEASE_ID, keys=True)))
    run(("lease_revoke", rpc_pb2.LeaseRevokeRequest(ID=LEASE_ID)))
    run(("lease_revoke", rpc_pb2.LeaseRevokeRequest(ID=LEASE_ID)))  # gone
    run(rng(b"/registry/events/", b"/registry/events0"))
    # compaction, then a read below it fails with ErrCompacted on both
    run(("compact", rpc_pb2.CompactionRequest(revision=head)))
    assert run(rng(revision=revs[a0] - 1)) is None
    run(rng(revision=head))
    run(rng())
    run(("status", rpc_pb2.StatusRequest()))
    run(("member_list", rpc_pb2.MemberListRequest()))


@pytest.fixture
def fronts(request, monkeypatch):
    """(JAX front, port front, device_path); the parameter is
    ``device_path`` or ``(device_path, listener)`` (see :class:`Front`)."""
    device_path, listener = (request.param if isinstance(request.param, tuple)
                             else (request.param, "client_port"))
    if device_path:
        cpu_shims(monkeypatch.setattr)
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()
    jax_front = Front(jax_cli, _flags("--storage", "memkv"), listener)
    try:
        port_front = Front(port_cli, _flags(
            "--storage", "cuda", "--inner-storage", "memkv", "--device",
            "cpu"), listener)
    except BaseException:
        jax_front.close()
        raise
    try:
        for front in (jax_front, port_front):
            _stubs(front)
        if device_path:
            port_front.backend.scanner._host_limit_threshold = 0
        yield jax_front, port_front, device_path
    finally:
        port_front.close()
        jax_front.close()
        for mod in (scan_kernels, compact_kernels, fanout_kernels):
            mod.reset_launch_counts()


def _stubs(front: Front) -> None:
    ch = front.client.ch
    for name, path, req, resp in (
        ("lease_ttl", "/etcdserverpb.Lease/LeaseTimeToLive",
         rpc_pb2.LeaseTimeToLiveRequest, rpc_pb2.LeaseTimeToLiveResponse),
        ("lease_revoke", "/etcdserverpb.Lease/LeaseRevoke",
         rpc_pb2.LeaseRevokeRequest, rpc_pb2.LeaseRevokeResponse),
    ):
        setattr(front.client, name, ch.unary_unary(
            path, request_serializer=req.SerializeToString,
            response_deserializer=resp.FromString))


def run_differential(jax_front: Front, port_front: Front) -> None:
    """The script through both fronts, every answer equal, then their
    watches' events equal and in the same order."""
    n = [0]

    def run(item):
        method, request = item
        want = jax_front.call(method, request)
        got = port_front.call(method, request)
        assert got == want, (n[0], method, request)
        n[0] += 1
        status, body = got
        return None if status is not None else _RESPONSES[method].FromString(body)

    script(run)
    assert n[0] >= 40
    # the watches: the same events in the same order
    head = port_front.backend.current_revision()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            not f.events or f.events[-1][2] < head for f in (jax_front, port_front)):
        time.sleep(0.02)
    assert port_front.events == jax_front.events
    # 12 creates, an update, a delete, the leased key's create and the
    # revoke's delete of it
    assert len(port_front.events) == 16


@pytest.mark.parametrize("fronts", [False, True], indirect=True,
                         ids=["host_path", "device_path"])
def test_port_front_answers_as_the_jax_front(fronts):
    jax_front, port_front, device_path = fronts
    run_differential(jax_front, port_front)
    if device_path:
        assert scan_kernels.visibility_mask_batch.launches > 0
        assert compact_kernels.victim_mask_batch.launches > 0


_RESPONSES = {
    "txn": rpc_pb2.TxnResponse, "range_": rpc_pb2.RangeResponse,
    "compact": rpc_pb2.CompactionResponse,
    "lease_grant": rpc_pb2.LeaseGrantResponse,
    "lease_ttl": rpc_pb2.LeaseTimeToLiveResponse,
    "lease_revoke": rpc_pb2.LeaseRevokeResponse,
    "status": rpc_pb2.StatusResponse, "member_list": rpc_pb2.MemberListResponse,
}
