"""The port's TLS endpoint: secure gRPC and the HTTPS control plane over
the ``cuda`` engine on memkv with ``--device cpu``, with a certificate from
the port's ``util/selfsigned.py``. Counterpart of ``tests/test_tls.py``,
skipped as it is where ``cryptography`` is not installed."""

import ssl
import urllib.request

import grpc
import pytest

try:
    import cryptography  # noqa: F401  -- cert generation dependency
except ImportError:
    pytest.skip(
        "cryptography not installed in this image (needed to generate the "
        "self-signed test certs)", allow_module_level=True,
    )

from kubebrain_tpu_torch.cli import build_endpoint, build_parser
from kubebrain_tpu_torch.proto import rpc_pb2
from kubebrain_tpu_torch.util.selfsigned import gen_self_signed

from test_etcd_server import EtcdClient, free_port


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """Self-signed server cert for 127.0.0.1 and localhost."""
    return gen_self_signed(str(tmp_path_factory.mktemp("certs")),
                           common_name="kubebrain-torch-test")


def test_secure_grpc_and_https(certs):
    cert_file, key_file = certs
    port, peer, info = free_port(), free_port(), free_port()
    args = build_parser().parse_args([
        "--single-node", "--storage", "cuda", "--inner-storage", "memkv",
        "--device", "cpu", "--host", "127.0.0.1",
        "--identity", f"127.0.0.1:{peer}",
        "--client-port", str(port), "--peer-port", str(peer), "--info-port", str(info),
        "--cert-file", cert_file, "--key-file", key_file,
    ])
    endpoint, backend, store = build_endpoint(args)
    endpoint.config.insecure = False  # secure-only mode
    endpoint.run()
    try:
        with open(cert_file, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        ch = grpc.secure_channel(f"127.0.0.1:{port}", creds)
        txn = ch.unary_unary(
            "/etcdserverpb.KV/Txn",
            request_serializer=rpc_pb2.TxnRequest.SerializeToString,
            response_deserializer=rpc_pb2.TxnResponse.FromString,
        )
        req = rpc_pb2.TxnRequest()
        c = req.compare.add()
        c.result = rpc_pb2.Compare.EQUAL
        c.target = rpc_pb2.Compare.MOD
        c.key = b"/tls/k"
        c.mod_revision = 0
        req.success.add().request_put.CopyFrom(rpc_pb2.PutRequest(key=b"/tls/k", value=b"v"))
        resp = txn(req, timeout=5)
        assert resp.succeeded
        ch.close()

        # plaintext client must NOT work in secure-only mode
        insecure = EtcdClient(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError):
            insecure.create(b"/tls/x", b"v")
        insecure.close()

        # HTTPS control plane
        ctx = ssl.create_default_context(cafile=cert_file)
        ctx.check_hostname = False
        with urllib.request.urlopen(
            f"https://127.0.0.1:{peer}/health", timeout=5, context=ctx
        ) as resp:
            assert b"true" in resp.read()
    finally:
        endpoint.close()
        backend.close()
        store.close()
