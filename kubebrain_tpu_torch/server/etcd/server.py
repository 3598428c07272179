"""etcd3 gRPC service registration.

Reference: pkg/server/etcd/server.go:55-60 (registers KV, Watch, Lease,
Cluster). grpc_tools isn't available in this image, so instead of generated
``add_*_servicer_to_server`` glue the services are mounted with
``grpc.method_handlers_generic_handler`` — byte-identical on the wire.
"""

from __future__ import annotations

import grpc

from ...proto import rpc_pb2
from .kv import KVService
from .misc import ClusterService, LeaseService, MaintenanceService
from .watch import WatchService


def _unary(fn, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString,
    )


def _bidi(fn, req_cls, resp_cls):
    return grpc.stream_stream_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString,
    )


def make_etcd_handlers(backend, peers=None, identity="kubebrain-tpu",
                       client_urls=None, replica=None):
    """Generic handlers for the etcd3 surface; mount with
    ``server.add_generic_rpc_handlers``. ``replica`` (a FollowerRole)
    switches the per-RPC routing to follower mode: local/fence/forward
    (docs/replication.md)."""
    kv = KVService(backend, peers, replica=replica)
    watch = WatchService(backend, peers, replica=replica)
    lease = LeaseService(backend, peers, replica=replica)
    cluster = ClusterService(backend, identity, client_urls)
    maint = MaintenanceService(backend)
    p = rpc_pb2
    return [
        grpc.method_handlers_generic_handler("etcdserverpb.KV", {
            "Range": _unary(kv.Range, p.RangeRequest, p.RangeResponse),
            "Txn": _unary(kv.Txn, p.TxnRequest, p.TxnResponse),
            "Compact": _unary(kv.Compact, p.CompactionRequest, p.CompactionResponse),
            "Put": _unary(kv.Put, p.PutRequest, p.PutResponse),
            "DeleteRange": _unary(kv.DeleteRange, p.DeleteRangeRequest, p.DeleteRangeResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Watch", {
            "Watch": _bidi(watch.Watch, p.WatchRequest, p.WatchResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Lease", {
            "LeaseGrant": _unary(lease.LeaseGrant, p.LeaseGrantRequest, p.LeaseGrantResponse),
            "LeaseRevoke": _unary(lease.LeaseRevoke, p.LeaseRevokeRequest, p.LeaseRevokeResponse),
            "LeaseKeepAlive": _bidi(lease.LeaseKeepAlive, p.LeaseKeepAliveRequest, p.LeaseKeepAliveResponse),
            "LeaseTimeToLive": _unary(lease.LeaseTimeToLive, p.LeaseTimeToLiveRequest, p.LeaseTimeToLiveResponse),
            "LeaseLeases": _unary(lease.LeaseLeases, p.LeaseLeasesRequest, p.LeaseLeasesResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Cluster", {
            "MemberList": _unary(cluster.MemberList, p.MemberListRequest, p.MemberListResponse),
        }),
        grpc.method_handlers_generic_handler("etcdserverpb.Maintenance", {
            "Status": _unary(maint.Status, p.StatusRequest, p.StatusResponse),
            "Defragment": _unary(maint.Defragment, p.DefragmentRequest, p.DefragmentResponse),
            "Snapshot": grpc.unary_stream_rpc_method_handler(
                maint.Snapshot,
                request_deserializer=p.SnapshotRequest.FromString,
                response_serializer=p.SnapshotResponse.SerializeToString,
            ),
        }),
    ]
