"""Lease / Cluster / Maintenance terminals.

Reference: pkg/server/etcd/lease.go — which ships the "fake but truthy"
stub (LeaseGrant returns the TTL as the lease ID, TTL enforced by key
pattern, lease.go:24-31). This LeaseService is the real thing instead: a
monotonic-clock TTL state machine (kubebrain_tpu_torch/lease) whose expiry path
is the leader-only reaper issuing revision-stamped deletes through the
sequencer, so kube-apiserver workloads that depend on real lease semantics
(event TTLs, masterleases, lock/election keys) behave as against etcd.
ClusterService mirrors cluster.go (MemberList stub, :25-33).
"""

from __future__ import annotations

import grpc

from ... import __version__
from ...lease import LeaseExistsError, LeaseNotFoundError, ensure_lease
from ...proto import rpc_pb2
from ...sched import Lane, ensure_scheduler
from ...trace import TRACER, traceparent_of
from . import shim

ERR_LEASE_NOT_FOUND = "etcdserver: requested lease not found"
ERR_LEASE_EXISTS = "etcdserver: lease already exists"
ERR_NOT_LEADER = "etcdserver: not leader"


class LeaseNotLeaderError(Exception):
    """Lease RPC reached a follower. Lease state lives on the leader (the
    reaper is leader-only); answering from a follower's stale registry
    would either kill a healthy client's lease (TTL=0) or refresh a shadow
    copy the leader never sees. Transports map this to UNAVAILABLE so
    clients retry the leader."""

#: etcd's minLeaseTTL: sub-second grants flap under keepalive jitter
MIN_LEASE_TTL = 1


class LeaseService:
    """etcd Lease terminal over the shared registry + reaper.

    Keepalives are submitted on the request scheduler's SYSTEM lane: under
    overload the background/normal lanes shed, but a shed keepalive would
    expire a healthy client's lease and delete its keys — exactly the
    cascading failure admission control exists to prevent.
    """

    def __init__(self, backend, peers=None, replica=None):
        self.backend = backend
        self.peers = peers
        #: follower role (``replica.FollowerRole`` under ``--role
        #: follower``, None on a leader): lease state lives on the leader,
        #: so every lease RPC forwards there with status passthrough
        #: — unlike the election-follower refusal below, a replica-role
        #: follower is a full serving endpoint for lease clients
        self.replica = replica
        self.registry = ensure_lease(backend, peers=peers)
        self.reaper = backend._kb_lease_reaper
        self.limiter = ensure_scheduler(backend)

    def _check_leader(self, context) -> None:
        # lease state lives on the leader (the reaper is leader-only);
        # followers don't forward lease RPCs — clients retry the leader
        if self.peers is not None and not self.peers.is_leader():
            context.abort(grpc.StatusCode.UNAVAILABLE, ERR_NOT_LEADER)

    def LeaseGrant(self, request, context) -> rpc_pb2.LeaseGrantResponse:
        if self.replica is not None:
            return self.replica.forward_unary("lease_grant", request, context)
        with TRACER.span("etcd.Lease/LeaseGrant",
                         traceparent=traceparent_of(context)):
            with TRACER.stage("endpoint_recv"):
                self._check_leader(context)
                ttl = max(int(request.TTL), MIN_LEASE_TTL)
            try:
                with TRACER.stage("backend_write"):
                    lease = self.registry.grant(ttl, int(request.ID))
            except LeaseExistsError:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, ERR_LEASE_EXISTS)
            with TRACER.stage("response_encode"):
                return rpc_pb2.LeaseGrantResponse(
                    header=shim.header(self.backend.current_revision()),
                    ID=lease.id,
                    TTL=int(lease.granted_ttl),
                )

    def LeaseRevoke(self, request, context) -> rpc_pb2.LeaseRevokeResponse:
        if self.replica is not None:
            return self.replica.forward_unary("lease_revoke", request, context)
        with TRACER.span("etcd.Lease/LeaseRevoke",
                         traceparent=traceparent_of(context)):
            with TRACER.stage("endpoint_recv"):
                self._check_leader(context)
            try:
                # keys-first delete discipline (reaper.revoke): every
                # attached key dies as a normal MVCC tombstone through the
                # sequencer before the lease record goes away
                with TRACER.stage("backend_write"):
                    self.reaper.revoke(int(request.ID))
            except LeaseNotFoundError:
                context.abort(grpc.StatusCode.NOT_FOUND, ERR_LEASE_NOT_FOUND)
            with TRACER.stage("response_encode"):
                return rpc_pb2.LeaseRevokeResponse(
                    header=shim.header(self.backend.current_revision())
                )

    def LeaseKeepAlive(self, request_iterator, context):
        if self.replica is not None:
            # the whole stream pipes through the leader (the etcd-proxy
            # watch-piping shape applied to keepalives)
            yield from self.replica.forward_keepalive(request_iterator,
                                                      context)
            return
        tp = traceparent_of(context)
        try:
            for req in request_iterator:
                yield self.keepalive_one(req, traceparent=tp)
        except LeaseNotLeaderError:
            context.abort(grpc.StatusCode.UNAVAILABLE, ERR_NOT_LEADER)

    def keepalive_one(self, req, traceparent=None) -> rpc_pb2.LeaseKeepAliveResponse:
        """One keepalive refresh, admitted on the SYSTEM lane. TTL=0 in the
        response is the etcd encoding of "lease not found/expired" — the
        registry never revives an expired lease. Shared by the sync, aio,
        and native-front keepalive streams; raises LeaseNotLeaderError on
        followers (a follower answering TTL=0 from its stale table would
        make the client abandon a lease that is alive on the leader)."""
        with TRACER.span("etcd.Lease/LeaseKeepAlive", traceparent=traceparent):
            if self.peers is not None and not self.peers.is_leader():
                raise LeaseNotLeaderError(ERR_NOT_LEADER)
            registry = self.registry
            lease_id = int(req.ID)
            ttl = self.limiter.submit(
                lambda: registry.keepalive(lease_id),
                lane=Lane.SYSTEM, client="lease-keepalive",
            )
            with TRACER.stage("response_encode"):
                return rpc_pb2.LeaseKeepAliveResponse(
                    header=shim.header(self.backend.current_revision()),
                    ID=req.ID,
                    TTL=ttl,
                )

    def LeaseTimeToLive(self, request, context) -> rpc_pb2.LeaseTimeToLiveResponse:
        if self.replica is not None:
            return self.replica.forward_unary("lease_ttl", request, context)
        with TRACER.span("etcd.Lease/LeaseTimeToLive",
                         traceparent=traceparent_of(context)):
            self._check_leader(context)  # a follower's table is stale
            ttl, granted, keys = self.registry.time_to_live(int(request.ID))
            with TRACER.stage("response_encode"):
                resp = rpc_pb2.LeaseTimeToLiveResponse(
                    header=shim.header(self.backend.current_revision()),
                    ID=request.ID,
                    TTL=ttl,          # -1 = missing or expired (etcd contract)
                    grantedTTL=granted,
                )
                if request.keys and ttl >= 0:
                    resp.keys.extend(keys)
                return resp

    def LeaseLeases(self, request, context) -> rpc_pb2.LeaseLeasesResponse:
        if self.replica is not None:
            return self.replica.forward_unary("lease_leases", request, context)
        with TRACER.span("etcd.Lease/LeaseLeases",
                         traceparent=traceparent_of(context)):
            self._check_leader(context)  # a follower's table is stale
            resp = rpc_pb2.LeaseLeasesResponse(
                header=shim.header(self.backend.current_revision())
            )
            for lease_id in self.registry.ids():
                resp.leases.add(ID=lease_id)
            return resp


class ClusterService:
    def __init__(self, backend, identity: str = "kubebrain-tpu", client_urls=None):
        self.backend = backend
        self.identity = identity
        self.client_urls = client_urls or []

    def MemberList(self, request, context) -> rpc_pb2.MemberListResponse:
        resp = rpc_pb2.MemberListResponse(
            header=shim.header(self.backend.current_revision())
        )
        resp.members.add(ID=1, name=self.identity, clientURLs=self.client_urls)
        return resp


class MaintenanceService:
    def __init__(self, backend):
        self.backend = backend

    def Status(self, request, context) -> rpc_pb2.StatusResponse:
        return rpc_pb2.StatusResponse(
            header=shim.header(self.backend.current_revision()),
            version=f"3.5.0-kubebrain-tpu-{__version__}",
            leader=1,
            raftIndex=self.backend.current_revision(),
            raftTerm=1,
        )

    def Defragment(self, request, context) -> rpc_pb2.DefragmentResponse:
        """etcd defrag ≈ our checkpoint: rewrite a latest-only snapshot and
        truncate the WAL (no-op for engines without durability)."""
        from ...storage import unwrap_store

        # engines hide behind decorator stacks (metrics → cuda → native)
        store = unwrap_store(self.backend.store, "checkpoint")
        if store is not None:
            store.checkpoint()
        return rpc_pb2.DefragmentResponse(
            header=shim.header(self.backend.current_revision())
        )

    def Snapshot(self, request, context):
        """Stream a consistent backup (etcdctl snapshot save): a
        length-framed dump of the keyspace AT the header revision —
        engine-portable (restorable into any engine by replaying creates),
        streamed batch-by-batch so the keyspace never materializes in full
        (backend.list_by_stream)."""
        from ...sched import ensure_scheduler
        from ...trace import TRACER

        # background lane: a snapshot dump must queue behind serving reads.
        # Only the admission + initial dispatch is spanned — the stream
        # drains across yields, and a span must not straddle a generator's
        # suspension points (the contextvar would leak into the consumer).
        with TRACER.span("etcd.Maintenance/Snapshot"):
            rev, stream = ensure_scheduler(self.backend).list_by_stream(b"", b"")
        pending = b"KBSNAP1" + rev.to_bytes(8, "big")
        for batch in stream:
            frames = [pending]
            for kv in batch:
                frames.append(len(kv.key).to_bytes(4, "big"))
                frames.append(kv.key)
                frames.append(len(kv.value).to_bytes(4, "big"))
                frames.append(kv.value)
                frames.append(kv.revision.to_bytes(8, "big"))
            payload = b"".join(frames)
            pending = b""
            yield rpc_pb2.SnapshotResponse(
                header=shim.header(rev),
                remaining_bytes=1,  # progress hint; exact total unknown while streaming
                blob=payload,
            )
        yield rpc_pb2.SnapshotResponse(
            header=shim.header(rev), remaining_bytes=0, blob=pending
        )
