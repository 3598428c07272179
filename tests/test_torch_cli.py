"""The port's CLI (``kubebrain_tpu_torch/cli.py``): its wiring of the
``cuda`` engine, the engine hooks and the fan-out matchers, the mesh flags,
the asyncio and kbfront listeners, the follower role and its flags, the
device default, and a kept divergence from the JAX CLI, which cannot start
``tpu`` over native."""

import subprocess
import sys

import grpc
import pytest
import torch

from kubebrain_tpu import cli as jax_cli
from kubebrain_tpu_torch import __version__, cli
from kubebrain_tpu_torch.fanout import DeviceFanout
from kubebrain_tpu_torch.metrics import NoopMetrics, new_metrics
from kubebrain_tpu_torch.ops.fanout import FanoutMatcher
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.server.service import PeerService, SingleNodePeerService
from kubebrain_tpu_torch.storage.cuda.engine import CudaKvStorage, TorchScanner
from kubebrain_tpu_torch.storage.native import NativeKv

from kbstored_build import kbfront  # noqa: F401
from test_etcd_server import EtcdClient, free_port
from test_torch_etcd_server import ROOT, port_flags

CUDA_ON_CPU = ("--storage", "cuda", "--inner-storage", "memkv", "--device",
               "cpu", "--single-node", "--identity", "127.0.0.1:2380")


class Booted:
    """``cli.build_backend(flags)`` closed on exit."""

    def __init__(self, *flags, metrics=None):
        self.flags = flags
        self.metrics = metrics or NoopMetrics()

    def __enter__(self):
        self.backend, self.store, self.peers = cli.build_backend(
            list(self.flags), metrics=self.metrics)
        return self

    def __exit__(self, *exc):
        self.peers.close()
        self.backend.close()
        self.store.close()


def test_cuda_over_native_boots_serves_and_restarts(tmp_path):
    """``--storage cuda --inner-storage native --data-dir``: the mirror
    over native with the CLI's partition counts, serving etcd3 Txn and
    Range; a second boot on the data dir reads the same rows back."""
    d = str(tmp_path / "native")
    key = b"/registry/pods/default/p0"
    for boot in range(2):
        port = free_port()
        args = cli.build_parser().parse_args(port_flags(
            port, "--inner-storage", "native", "--data-dir", d,
            "--native-partitions", "3", "--scan-partitions", "2"))
        endpoint, backend, store = cli.build_endpoint(args)
        endpoint.run()
        client = EtcdClient(f"127.0.0.1:{port}")
        try:
            assert isinstance(store, CudaKvStorage)
            assert isinstance(store._inner, NativeKv)
            assert store._inner._n_parts == 3  # --native-partitions
            assert backend.scanner._partitions == 2  # --scan-partitions
            if boot == 0:
                assert client.create(key, b"v").succeeded
            r = client.range_(rpc_pb2.RangeRequest(
                key=b"/registry/pods/", range_end=b"/registry/pods0"))
            assert [(kv.key, kv.value) for kv in r.kvs] == [(key, b"v")]
        finally:
            client.close()
            endpoint.close()
            backend.close()
            store.close()


def test_jax_cli_cannot_boot_tpu_over_native(tmp_path):
    """Kept divergence: the JAX CLI passes the native engine's
    ``partitions`` beside the mirror's, so ``--storage tpu --inner-storage
    native`` fails with a TypeError where the port's CLI boots."""
    args = jax_cli.build_parser().parse_args([
        "--single-node", "--storage", "tpu", "--inner-storage", "native",
        "--data-dir", str(tmp_path / "jax"), "--identity", "127.0.0.1:2380",
        "--client-port", str(free_port()), "--peer-port", str(free_port()),
        "--info-port", str(free_port())])
    with pytest.raises(TypeError, match="multiple values for keyword argument 'partitions'"):
        jax_cli.build_endpoint(args)


@pytest.mark.parametrize("encoding", ["encoded", "raw"])
def test_cli_reaches_the_engine_hooks(monkeypatch, encoding):
    """The CLI hands its sink to ``register_metrics`` and its fault plane
    to ``set_fault_plane`` (through ``hasattr``, as the JAX CLI does), and
    ``--key-encoding`` reaches the mirror that ``encoding_stats`` reports;
    the mirror's gauges then show on the sink."""
    calls = []
    for name in ("register_metrics", "set_fault_plane"):
        orig = getattr(TorchScanner, name)

        def spy(self, arg, _name=name, _orig=orig):
            calls.append((_name, arg))
            return _orig(self, arg)

        monkeypatch.setattr(TorchScanner, name, spy)
    metrics = new_metrics()
    with Booted(*CUDA_ON_CPU, "--faults", "smoke", "--fault-seed", "3",
                "--key-encoding", encoding, metrics=metrics) as b:
        plane = b.backend._kb_faults
        assert calls == [("set_fault_plane", plane), ("register_metrics", metrics)]
        assert plane._hub is b.backend.watcher_hub
        b.backend.create(b"/registry/pods/a/p", b"v")
        b.backend.scanner.publish()
        stats = b.backend.scanner.encoding_stats()
        assert stats["rows"] > 0 and stats["encoded"] == (encoding == "encoded")
        _ctype, body = metrics.http_handler()()
        assert b'kb_mirror_bytes{device="cpu"}' in body
        assert b'kb_mirror_state{state="serving"} 1.0' in body


@pytest.mark.parametrize("impl,kind", [("block", DeviceFanout),
                                       ("legacy", FanoutMatcher)])
def test_fanout_impl_wires_its_matcher(impl, kind):
    """``--tpu-fanout`` wires ``DeviceFanout`` (K4), and ``--fanout-impl
    legacy`` the per-batch ``FanoutMatcher`` (K5), on ``--device``."""
    with Booted(*CUDA_ON_CPU, "--tpu-fanout", "--fanout-impl", impl) as b:
        matcher = b.backend.watcher_hub._fanout_matcher
        assert type(matcher) is kind
        assert matcher.device == torch.device("cpu")
    with Booted(*CUDA_ON_CPU) as b:
        assert b.backend.watcher_hub._fanout_matcher is None


def test_peers_follow_single_node():
    with Booted(*CUDA_ON_CPU) as b:
        assert type(b.peers) is SingleNodePeerService and b.peers.is_leader()
    flags = [f for f in CUDA_ON_CPU if f != "--single-node"]
    with Booted(*flags) as b:
        assert type(b.peers) is PeerService


@pytest.mark.parametrize("listener", ["aio_port", "front_port"])
@pytest.mark.parametrize("secure", [False, True], ids=["plaintext", "tls"])
def test_listener_flags_boot_and_serve_a_range(listener, secure, kbfront,
                                               tmp_path):
    """``--aio-port`` and ``--front-port`` boot with the CLI's wiring and
    serve a Range written through the sync front, beside it; with
    ``--cert-file``/``--key-file`` both serve it over TLS. The kbfront
    binary is built on first use (``kbfront`` fixture)."""
    from kubebrain_tpu_torch.util.selfsigned import gen_self_signed

    port, extra = free_port(), free_port()
    flags = port_flags(port, "--" + listener.replace("_", "-"), str(extra))
    if secure:
        cert, key = gen_self_signed(str(tmp_path), "cli-listener")
        flags += ["--cert-file", cert, "--key-file", key]
    endpoint, backend, store = cli.build_endpoint(flags)
    endpoint.run()
    key_ = b"/registry/pods/default/p0"
    channels = []
    try:
        if secure:
            with open(cert, "rb") as fh:
                creds = grpc.ssl_channel_credentials(root_certificates=fh.read())
            channels = [grpc.secure_channel(f"localhost:{p}", creds)
                        for p in (port, extra)]
        else:
            channels = [grpc.insecure_channel(f"127.0.0.1:{p}")
                        for p in (port, extra)]
        for ch in channels:
            grpc.channel_ready_future(ch).result(timeout=30)
        txn = channels[0].unary_unary(
            "/etcdserverpb.KV/Txn",
            request_serializer=rpc_pb2.TxnRequest.SerializeToString,
            response_deserializer=rpc_pb2.TxnResponse.FromString)
        put = rpc_pb2.TxnRequest(  # a create: MOD == 0, else a Range
            compare=[rpc_pb2.Compare(target=rpc_pb2.Compare.MOD, key=key_,
                                     mod_revision=0)],
            success=[rpc_pb2.RequestOp(request_put=rpc_pb2.PutRequest(
                key=key_, value=b"v"))],
            failure=[rpc_pb2.RequestOp(request_range=rpc_pb2.RangeRequest(
                key=key_))])
        rev = txn(put, timeout=10).header.revision
        rng = channels[1].unary_unary(
            "/etcdserverpb.KV/Range",
            request_serializer=rpc_pb2.RangeRequest.SerializeToString,
            response_deserializer=rpc_pb2.RangeResponse.FromString)
        r = rng(rpc_pb2.RangeRequest(key=b"/registry/pods/",
                                     range_end=b"/registry/pods0"), timeout=10)
        assert [(kv.key, kv.value, kv.mod_revision) for kv in r.kvs] == [
            (key_, b"v", rev)]
        assert isinstance(store, CudaKvStorage)
    finally:
        for ch in channels:
            ch.close()
        endpoint.close()
        backend.close()
        store.close()


@pytest.mark.parametrize("flags", [
    ("--mesh-part", "2"), ("--mesh-wat", "2", "--tpu-fanout"),
], ids=["mesh_part", "mesh_wat"])
def test_mesh_flags_boot_a_sharded_backend(flags):
    """``--mesh-part 2`` splits the mirror over two CPU slots (one
    partition each) and ``--mesh-wat 2`` the watcher table, which the
    ``kb.fanout.sharded`` gauge then reports; a write and a Range are
    served either way."""
    with Booted(*CUDA_ON_CPU, *flags) as b:
        rev = b.backend.create(b"/registry/pods/a/p", b"v")
        assert [kv.revision for kv in b.backend.list_(
            b"/registry/pods/", b"/registry/pods0").kvs] == [rev]
        mirror = b.backend.scanner._mirror
        matcher = b.backend.watcher_hub._fanout_matcher
        if flags[0] == "--mesh-part":
            assert len(mirror.shards) == 2 and mirror.partitions == 2
            assert matcher is None
        else:
            assert len(mirror.shards) == 1
            assert matcher.table.stats()["sharded"] is True
            assert matcher.table.stats()["devices"] == 2


FOLLOWER = ("--role", "follower", "--leader-address", "127.0.0.1:2379",
            "--leader-info", "127.0.0.1:8081")


@pytest.mark.parametrize("flags,message", [
    (("--role", "follower", "--leader-info", "127.0.0.1:8081"),
     "requires --leader-address"),
    (("--role", "follower", "--leader-address", "127.0.0.1:2379"),
     "requires --leader-info"),
    ((*FOLLOWER, "--aio-port", "23790"), "sync gRPC front only"),
    ((*FOLLOWER, "--front-port", "23791"), "sync gRPC front only"),
    ((*FOLLOWER, "--fence-timeout-ms", "0"), "--fence-timeout-ms must be > 0"),
    ((*FOLLOWER, "--max-staleness-rev", "-1"), "must be >= 0"),
    ((*FOLLOWER, "--max-staleness-ms", "-1"), "must be >= 0"),
    (("--leader-address", "127.0.0.1:2379"), "require --role follower"),
    (("--leader-info", "127.0.0.1:8081"), "require --role follower"),
])
def test_follower_flags_are_validated(flags, message):
    """Each refusal of the JAX CLI's follower validation
    (``kubebrain_tpu/cli.py:282-304``), which the JAX CLI gives too."""
    with pytest.raises(SystemExit, match=message):
        cli.build_backend([*CUDA_ON_CPU, *flags], metrics=NoopMetrics())
    with pytest.raises(SystemExit, match=message):
        jax_cli.validate_args(jax_cli.build_parser().parse_args(
            [a if a != "cuda" else "tpu" for a in CUDA_ON_CPU
             if a not in ("--device", "cpu")] + list(flags)))


def test_follower_role_is_the_peers_surface():
    """``--role follower`` builds ``FollowerRole`` as the peers (no leader,
    so the lease reaper never reaps) over the ``cuda`` mirror, with the
    flags' bounds, and starts no replication stream: the endpoint does."""
    from kubebrain_tpu_torch.replica import FollowerRole

    with Booted(*CUDA_ON_CPU, *FOLLOWER, "--max-staleness-rev", "7",
                "--max-staleness-ms", "250", "--fence-timeout-ms", "1500",
                "--tpu-fanout") as b:
        role = b.peers
        assert type(role) is FollowerRole and not role.is_leader()
        assert (role.config.leader_address, role.config.leader_info) == (
            "127.0.0.1:2379", "127.0.0.1:8081")
        assert (role.config.max_staleness_rev, role.config.max_staleness_ms,
                role.config.fence_timeout_s) == (7, 250.0, 1.5)
        assert role._stream is None and role.status()["stream"] == {
            "state": "not_started"}
        assert isinstance(b.backend.scanner, TorchScanner)
        assert type(b.backend.watcher_hub._fanout_matcher) is DeviceFanout
        assert b.backend._kb_lease_reaper.peers is role


@pytest.mark.parametrize("flags,message", [
    (("--inner-storage", "cuda"), "cannot be cuda"),
    (("--storage", "memkv", "--key-encoding", "raw"), "requires --storage=cuda"),
    (("--storage", "memkv", "--scan-partitions", "2"), "requires --storage=cuda"),
    (("--data-dir", "data"), "--data-dir requires"),
    (("--secure-only",), "requires --cert-file"),
    (("--faults", "bogus"), "unknown"),
])
def test_invalid_flags_raise(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.build_backend([*CUDA_ON_CPU, *flags], metrics=NoopMetrics())


def test_default_device_raises_without_card(monkeypatch):
    """``--storage`` defaults to ``cuda`` and ``--device`` to ``cuda``:
    without a card the server raises before anything opens, with no
    storage flags and over a host engine too; only ``--device cpu`` starts
    it there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    defaults = cli.build_parser().parse_args([])
    assert (defaults.storage, defaults.inner_storage, defaults.device) == (
        "cuda", "memkv", "cuda")
    for flags in ((), ("--storage", "cuda"), ("--storage", "memkv"),
                  ("--storage", "memkv", "--tpu-fanout")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.build_backend(["--single-node", "--identity", "127.0.0.1:2380",
                               *flags], metrics=NoopMetrics())


def test_host_engine_starts_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Booted("--storage", "memkv", "--device", "cpu", "--single-node",
                "--identity", "127.0.0.1:2380") as b:
        assert type(b.store).__name__ == "MemKv"
        assert b.backend.watcher_hub._fanout_matcher is None


def test_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "kubebrain_tpu_torch.cli",
                          "--version"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith(f"kubebrain-torch {__version__}")
