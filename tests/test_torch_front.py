"""The port's kbfront backhaul (``kubebrain_tpu_torch/endpoint/front.py``):
a real grpcio client speaks etcd3 and brain to the C++ frontend
(``native/front/kbfront``, built on first use by the ``kbfront`` fixture),
which forwards de-framed requests over the unix backhaul to the port's
Python terminals over the ``cuda`` engine on memkv with ``device="cpu"``.
Counterparts of ``tests/test_front.py`` (the single-port HTTP/1 + h2
demux, the raw-list path of the native engine) and
``tests/test_front_tls.py`` (TLS terminated in kbfront: both modes on one
port, secure-only), and the request script of
``tests/test_torch_front_differential.py`` sent through two kbfront
processes, one in front of each package's ``FrontServer``: serialized
responses, errors and watch events must be equal."""

import os
import queue
import socket
import ssl
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import grpc
import pytest

from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.endpoint.front import FrontServer
from kubebrain_tpu_torch.proto import brain_pb2, rpc_pb2
from kubebrain_tpu_torch.server import Server
from kubebrain_tpu_torch.server.service import SingleNodePeerService
from kubebrain_tpu_torch.storage import new_storage

from kbstored_build import REPO, kbfront  # noqa: F401
from test_etcd_server import free_port
from test_torch_front_differential import fronts, run_differential  # noqa: F401

pytestmark = pytest.mark.usefixtures("kbfront")


class FrontFixture:
    """A port Backend over ``cuda`` on memkv (CPU), its Server and a
    ``FrontServer`` with kbfront on a free port; ``run_kw`` go to
    ``FrontServer.run`` (the TLS files)."""

    def __init__(self, identity="front-test:0", **run_kw):
        self.store = new_storage("cuda", inner="memkv", device="cpu")
        self.backend = Backend(self.store, BackendConfig(
            event_ring_capacity=4096, watch_cache_capacity=4096))
        self.peers = SingleNodePeerService(self.backend, identity)
        self.server = Server(self.backend, self.peers, None, identity,
                             client_urls=[])
        self.front = FrontServer(self.backend, self.peers, self.server,
                                 identity, brain=self.server.brain)
        self.port = free_port()
        try:
            self.front.run(self.port, **run_kw)
        except BaseException:
            self.backend.close()
            self.store.close()
            raise

    def close(self):
        self.front.close()
        self.backend.close()
        self.store.close()


def kv_stubs(channel):
    p = rpc_pb2
    txn = channel.unary_unary(
        "/etcdserverpb.KV/Txn",
        request_serializer=p.TxnRequest.SerializeToString,
        response_deserializer=p.TxnResponse.FromString)
    rng = channel.unary_unary(
        "/etcdserverpb.KV/Range",
        request_serializer=p.RangeRequest.SerializeToString,
        response_deserializer=p.RangeResponse.FromString)
    return txn, rng


def create_req(key, value):
    p = rpc_pb2
    return p.TxnRequest(
        compare=[p.Compare(target=p.Compare.MOD, key=key, mod_revision=0)],
        success=[p.RequestOp(request_put=p.PutRequest(key=key, value=value))],
        failure=[p.RequestOp(request_range=p.RangeRequest(key=key))],
    )


def cas_req(key, mod_rev, value=None):
    """Txn: MOD == ``mod_rev``, then the put (or, without a value, the
    delete); else a Range of the key."""
    p = rpc_pb2
    op = (p.RequestOp(request_put=p.PutRequest(key=key, value=value))
          if value is not None else
          p.RequestOp(request_delete_range=p.DeleteRangeRequest(key=key)))
    return p.TxnRequest(
        compare=[p.Compare(target=p.Compare.MOD, key=key,
                           mod_revision=mod_rev)],
        success=[op],
        failure=[p.RequestOp(request_range=p.RangeRequest(key=key))])


class Client:
    """A plaintext channel to a front and its KV and Watch stubs."""

    def __init__(self, port):
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(self.channel).result(timeout=15)
        self.txn, self.range_ = kv_stubs(self.channel)
        self.watch = self.channel.stream_stream(
            "/etcdserverpb.Watch/Watch",
            request_serializer=rpc_pb2.WatchRequest.SerializeToString,
            response_deserializer=rpc_pb2.WatchResponse.FromString)


@pytest.fixture(scope="module")
def front(kbfront):  # noqa: F811
    f = FrontFixture()
    c = Client(f.port)
    yield f, c
    c.channel.close()
    f.close()


def test_front_txn_create_and_range(front):
    f, c = front
    r = c.txn(create_req(b"/registry/f/a", b"va"))
    assert r.succeeded
    rev = r.header.revision
    assert rev >= 1
    lst = c.range_(rpc_pb2.RangeRequest(key=b"/registry/f/",
                                        range_end=b"/registry/f0"))
    assert lst.count == 1
    assert lst.kvs[0].key == b"/registry/f/a"
    assert lst.kvs[0].value == b"va"
    assert lst.kvs[0].mod_revision == rev
    assert type(f.backend.scanner).__name__ == "TorchScanner"


def test_front_txn_conflict(front):
    _f, c = front
    c.txn(create_req(b"/registry/f/dup", b"v1"))
    assert not c.txn(create_req(b"/registry/f/dup", b"v2")).succeeded


def test_front_update_delete(front):
    _f, c = front
    rev1 = c.txn(create_req(b"/registry/f/u", b"v1")).header.revision
    up = c.txn(cas_req(b"/registry/f/u", rev1, b"v2"))
    assert up.succeeded
    assert c.txn(cas_req(b"/registry/f/u", up.header.revision)).succeeded
    assert c.range_(rpc_pb2.RangeRequest(key=b"/registry/f/u")).count == 0


def test_front_watch_stream(front):
    _f, c = front
    rev1 = c.txn(create_req(b"/registry/fw/a", b"v1")).header.revision
    got = []
    done = threading.Event()

    def reqs():
        yield rpc_pb2.WatchRequest(create_request=rpc_pb2.WatchCreateRequest(
            key=b"/registry/fw/", range_end=b"/registry/fw0",
            start_revision=rev1))
        done.wait(20)

    def consume():
        for resp in c.watch(reqs()):
            for ev in resp.events:
                got.append((ev.type, bytes(ev.kv.key), ev.kv.mod_revision))
                if len(got) >= 3:
                    done.set()
                    return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.3)
    c.txn(create_req(b"/registry/fw/b", b"v2"))
    assert c.txn(cas_req(b"/registry/fw/a", rev1)).succeeded
    t.join(timeout=20)
    assert len(got) == 3, got
    assert got[0] == (0, b"/registry/fw/a", rev1)       # replay PUT
    assert got[1][0] == 0 and got[1][1] == b"/registry/fw/b"
    assert got[2][0] == 1 and got[2][1] == b"/registry/fw/a"  # DELETE


def test_front_http_same_port(front):
    """Single-port demux: plain HTTP/1 on the gRPC port (cmux parity)."""
    f, _c = front
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{f.port}/health", timeout=10).read()
    assert b"true" in body
    status = urllib.request.urlopen(
        f"http://127.0.0.1:{f.port}/status", timeout=10).read()
    assert b"revision" in status
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{f.port}/nope", timeout=10)


def test_front_unknown_method(front):
    _f, c = front
    call = c.channel.unary_unary(
        "/etcdserverpb.KV/Nonexistent",
        request_serializer=lambda b: bytes(b),
        response_deserializer=lambda b: bytes(b))
    with pytest.raises(grpc.RpcError) as ei:
        call(b"", timeout=10)
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_front_brain_create_get(front):
    _f, c = front
    create = c.channel.unary_unary(
        "/brainpb.Brain/Create",
        request_serializer=brain_pb2.CreateRequest.SerializeToString,
        response_deserializer=brain_pb2.CreateResponse.FromString)
    get = c.channel.unary_unary(
        "/brainpb.Brain/Get",
        request_serializer=brain_pb2.GetRequest.SerializeToString,
        response_deserializer=brain_pb2.GetResponse.FromString)
    cr = create(brain_pb2.CreateRequest(key=b"/registry/fb/x", value=b"bv"),
                timeout=10)
    assert cr.succeeded
    assert get(brain_pb2.GetRequest(key=b"/registry/fb/x"),
               timeout=10).kv.value == b"bv"


def test_front_raw_list_path_matches_python_listener(tmp_path):
    """The port CLI as a process, ``--storage native --device cpu
    --front-port``: the C wire-encoded list fast path (``kb_mvcc_list_wire``
    + ``_RawResponse``, taken only behind kbfront) gives the answers of the
    gRPC listener's proto-built path: same kvs, ``more``, snapshot reads,
    limits and single-key gets."""
    from kubebrain_tpu_torch.client import EtcdCompatClient

    pyp, fp = free_port(), free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "kubebrain_tpu_torch.cli", "--single-node",
         "--storage", "native", "--device", "cpu",
         "--data-dir", str(tmp_path / "native"), "--host", "127.0.0.1",
         "--client-port", str(pyp), "--peer-port", str(free_port()),
         "--info-port", str(free_port()), "--front-port", str(fp)],
        cwd=REPO, stderr=subprocess.DEVNULL)
    c = None
    try:
        c = EtcdCompatClient(f"127.0.0.1:{pyp}")
        deadline = time.time() + 60
        while True:
            try:
                c.count(b"/x", b"/y")
                break
            except Exception:
                assert server.poll() is None, "the port CLI exited"
                assert time.time() < deadline, "the port CLI never served"
                time.sleep(0.2)
        revs = {}
        for i in range(30):
            ok, r = c.create(b"/registry/raw/k%03d" % i, b"v%d" % i)
            assert ok
            revs[i] = r
        snap = revs[14]
        ok, _ = c.update(b"/registry/raw/k005", b"upd", revs[5])
        assert ok
        assert c.delete(b"/registry/raw/k006", revs[6])

        def collect(port):
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            grpc.channel_ready_future(ch).result(timeout=30)
            _txn, rng = kv_stubs(ch)
            out = []
            for req in (
                rpc_pb2.RangeRequest(key=b"/registry/raw/",
                                     range_end=b"/registry/raw0"),
                rpc_pb2.RangeRequest(key=b"/registry/raw/",
                                     range_end=b"/registry/raw0", limit=7),
                rpc_pb2.RangeRequest(key=b"/registry/raw/",
                                     range_end=b"/registry/raw0",
                                     revision=snap),
                rpc_pb2.RangeRequest(key=b"/registry/raw/k003"),
            ):
                resp = rng(req, timeout=10)
                out.append((
                    [(kv.key, kv.value, kv.mod_revision, kv.create_revision,
                      kv.version) for kv in resp.kvs],
                    resp.more, resp.count, resp.header.revision))
            ch.close()
            return out

        via_front = collect(fp)
        via_python = collect(pyp)
        assert via_front == via_python
        assert len(via_front[0][0]) == 29   # one of 30 deleted
        assert via_front[1][1] is True      # limit=7 -> more
        assert len(via_front[2][0]) == 15   # snapshot at k014's create
    finally:
        if c is not None:
            c.close()
        server.terminate()
        server.wait(timeout=10)


@pytest.mark.parametrize("fronts", [(False, "front_port"),
                                    (True, "front_port")],
                         indirect=True, ids=["host_path", "device_path"])
def test_port_kbfront_answers_as_the_jax_one(fronts):
    """The differential request script through two kbfront processes, one
    before each package's ``FrontServer`` (the JAX CLI over memkv, the
    port's over ``cuda`` on memkv): byte-equal responses and errors, the
    same watch events in order; with the device path, the Ranges reach
    K1's wrapper and the Compact K3's."""
    from kubebrain_tpu_torch.ops import compact_kernels, scan_kernels

    jax_front, port_front, device_path = fronts
    run_differential(jax_front, port_front)
    if device_path:
        assert scan_kernels.visibility_mask_batch.launches > 0
        assert compact_kernels.victim_mask_batch.launches > 0


# ------------------------------------------------------------------- TLS
@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from kubebrain_tpu_torch.util.selfsigned import gen_self_signed

    return gen_self_signed(str(tmp_path_factory.mktemp("front-certs")),
                           "kbfront-test")


class TlsFront(FrontFixture):
    def __init__(self, certs, secure_only=False):
        self.cert_file, self.key_file = certs
        super().__init__("front-tls:0", cert_file=self.cert_file,
                         key_file=self.key_file, secure_only=secure_only)
        with open(self.cert_file, "rb") as fh:
            self.root_pem = fh.read()

    def secure_channel(self):
        creds = grpc.ssl_channel_credentials(root_certificates=self.root_pem)
        ch = grpc.secure_channel(f"localhost:{self.port}", creds)
        grpc.channel_ready_future(ch).result(timeout=15)
        return ch


@pytest.fixture(scope="module")
def tfront(certs, kbfront):  # noqa: F811
    f = TlsFront(certs)
    yield f
    f.close()


def test_tls_grpc_create_and_range(tfront):
    txn, rng = kv_stubs(tfront.secure_channel())
    assert txn(create_req(b"/registry/tls/a", b"v1"), timeout=10).succeeded
    resp = rng(rpc_pb2.RangeRequest(
        key=b"/registry/tls/", range_end=b"/registry/tls0"), timeout=10)
    assert [kv.key for kv in resp.kvs] == [b"/registry/tls/a"]


def test_plaintext_still_served_in_both_mode(tfront):
    ch = grpc.insecure_channel(f"127.0.0.1:{tfront.port}")
    grpc.channel_ready_future(ch).result(timeout=15)
    txn, rng = kv_stubs(ch)
    assert txn(create_req(b"/registry/tls/plain", b"v2"), timeout=10).succeeded
    resp = rng(rpc_pb2.RangeRequest(
        key=b"/registry/tls/", range_end=b"/registry/tls0"), timeout=10)
    assert len(resp.kvs) >= 1
    ch.close()


def test_https_and_http_health_same_port(tfront):
    ctx = ssl.create_default_context(cadata=tfront.root_pem.decode())
    with urllib.request.urlopen(f"https://localhost:{tfront.port}/health",
                                context=ctx, timeout=10) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(f"http://127.0.0.1:{tfront.port}/health",
                                timeout=10) as resp:
        assert resp.status == 200


def test_secure_only_refuses_plaintext(certs):
    f = TlsFront(certs, secure_only=True)
    try:
        txn, _ = kv_stubs(f.secure_channel())
        assert txn(create_req(b"/registry/so/a", b"v"), timeout=10).succeeded
        # plaintext HTTP is dropped without a response
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{f.port}/health",
                                   timeout=5)
        # and a raw plaintext h2 preface gets the connection closed
        s = socket.create_connection(("127.0.0.1", f.port), timeout=5)
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
        s.settimeout(5)
        assert s.recv(1024) == b""  # EOF: refused
        s.close()
    finally:
        f.close()


def test_tls_watch_stream(tfront):
    """A watch stream inside the TLS session: create events arrive."""
    p = rpc_pb2
    ch = tfront.secure_channel()
    watch = ch.stream_stream(
        "/etcdserverpb.Watch/Watch",
        request_serializer=p.WatchRequest.SerializeToString,
        response_deserializer=p.WatchResponse.FromString)
    req_q: queue.Queue = queue.Queue()
    req_q.put(p.WatchRequest(create_request=p.WatchCreateRequest(
        key=b"/registry/tlsw/", range_end=b"/registry/tlsw0")))
    stream = watch(iter(req_q.get, None))
    assert next(stream).created
    txn, _ = kv_stubs(ch)
    assert txn(create_req(b"/registry/tlsw/p1", b"v1"), timeout=10).succeeded
    evt = next(stream)
    assert evt.events and evt.events[0].kv.key == b"/registry/tlsw/p1"
    req_q.put(None)
    stream.cancel()


def test_backhaul_socket_goes_to_the_temporary_directory(front):
    """With no socket path given, the backhaul socket is created under
    ``tempfile.gettempdir()`` (``TMPDIR``), and removed at close."""
    import tempfile

    f, _c = front
    assert os.path.dirname(f.front.socket_path) == tempfile.gettempdir()
    assert os.path.exists(f.front.socket_path)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_close_stops_the_backhaul_loop(package):
    """``FrontServer.close`` ends kbfront and then joins the backhaul's
    loop thread (5 s at most). The port's backhaul closes its connection
    when kbfront goes, so the unix server's exit, which on Python 3.12
    waits for its connections, returns and the thread stops at once; the
    JAX backhaul leaves the connection open, so its loop thread is still
    running when close returns (a kept fix, ROADMAP §3)."""
    if package == "port":
        f = FrontFixture()
    else:
        from kubebrain_tpu import backend as jbackend
        from kubebrain_tpu.endpoint.front import FrontServer as JaxFront
        from kubebrain_tpu.server import Server as JaxServer
        from kubebrain_tpu.server.service import SingleNodePeerService as JaxPeers
        from kubebrain_tpu.storage import new_storage as jax_storage

        f = types.SimpleNamespace(store=jax_storage("memkv"))
        f.backend = jbackend.Backend(f.store, jbackend.BackendConfig())
        peers = JaxPeers(f.backend, "front-jax:0")
        f.front = JaxFront(f.backend, peers, JaxServer(
            f.backend, peers, None, "front-jax:0", client_urls=[]),
            "front-jax:0")
        f.front.run(free_port())
    path = f.front.socket_path
    t0 = time.monotonic()
    f.front.close()
    took = time.monotonic() - t0
    f.backend.close()
    f.store.close()
    assert not os.path.exists(path)
    if package == "port":
        assert not f.front._thread.is_alive() and took < 4.0
    else:
        assert f.front._thread.is_alive() and took >= 5.0
