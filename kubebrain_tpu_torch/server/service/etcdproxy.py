"""Follower→leader write forwarding over the etcd3 protocol.

Reference: pkg/server/service/etcdproxy/etcd_proxy.go — community
kube-apiserver load-balances writes across all replicas, but only the leader
can write; followers therefore proxy Txn (and Watch) to the leader's client
port. The reference keeps an etcd clientv3 pointed at the leader with a 1s
leader-change check loop (etcd_proxy.go:71-79); here a raw grpc channel
speaks the same etcdserverpb methods, re-dialed when the leader moves.

``grpc`` and the generated protos are imported inside ``EtcdProxy`` only,
so ``DisabledEtcdProxy`` and the peer services that hold it load where
neither is installed.
"""

from __future__ import annotations

import threading
from typing import Callable

PROXY_TIMEOUT_SECONDS = 5.0


class EtcdProxy:
    def __init__(self, get_leader_client_address: Callable[[], str | None]):
        self._get_leader = get_leader_client_address
        self._lock = threading.Lock()
        self._channel = None  # grpc.Channel
        self._target: str | None = None

    def _stub(self):
        import grpc

        from ...proto import rpc_pb2

        target = self._get_leader()
        if not target:
            return None
        with self._lock:
            if target != self._target:
                if self._channel is not None:
                    self._channel.close()
                self._channel = grpc.insecure_channel(target)
                self._target = target
            return self._channel.unary_unary(
                "/etcdserverpb.KV/Txn",
                request_serializer=rpc_pb2.TxnRequest.SerializeToString,
                response_deserializer=rpc_pb2.TxnResponse.FromString,
            )

    def forward_txn(self, request):
        import grpc

        call = self._stub()
        if call is None:
            return None
        try:
            return call(request, timeout=PROXY_TIMEOUT_SECONDS)
        except grpc.RpcError:
            return None

    def forward_watch(self, request_iterator):
        """Pipe a whole Watch stream through the leader (reference
        etcd_proxy.go:239-288); returns a response iterator or None."""
        import grpc

        from ...proto import rpc_pb2

        target = self._get_leader()
        if not target:
            return None
        with self._lock:
            if target != self._target:
                if self._channel is not None:
                    self._channel.close()
                self._channel = grpc.insecure_channel(target)
                self._target = target
            stream = self._channel.stream_stream(
                "/etcdserverpb.Watch/Watch",
                request_serializer=rpc_pb2.WatchRequest.SerializeToString,
                response_deserializer=rpc_pb2.WatchResponse.FromString,
            )
        return stream(request_iterator)

    def close(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
                self._target = None


class DisabledEtcdProxy:
    """No-op when --enable-etcd-proxy is off (reference etcdproxy/disabled.go)."""

    def forward_txn(self, request):  # noqa: ARG002
        return None

    def forward_watch(self, request_iterator):  # noqa: ARG002
        return None

    def close(self) -> None:
        pass
