"""etcd3 KV service terminal: Range demux + Txn pattern matching + Compact.

Reference: pkg/server/etcd/kv.go. kube-apiserver speaks a tiny, rigid subset
of etcd3 — this service recognizes exactly that subset and rejects the rest:

- ``Range`` demuxes get / count / list / partition-borders (the magic
  revision 1888 returns partition borders for partition-wise listing,
  kv.go:33,54-57);
- ``Txn`` pattern-matches the four transaction shapes the apiserver emits —
  create (mod/version == 0 guard + put), update (mod == rev guard + put),
  delete (mod == rev guard + delete_range), and the compactor's
  coordination txn on the literal ``compact_rev_key`` — which under this
  matcher is just a create/update with a VERSION guard (kv.go:160-230).
  Version guards are honored with mod-revision semantics: the guard value is
  an opaque token the compactor reads back from Get, so any per-update
  changing token satisfies the protocol;
- raw ``Put``/``DeleteRange`` are unsupported (kv.go:142-148);
- errors map to the etcd error strings clients key on (ErrCompacted /
  ErrFutureRev) so kube-apiserver re-lists correctly.
"""

from __future__ import annotations

import grpc

from ...backend import (
    Backend,
    CASRevisionMismatchError,
    CompactedError,
    FutureRevisionError,
    KeyExistsError,
)
from ...lease import LeaseNotFoundError
from ...sched import (
    SchedOverloadError,
    SchedResultTimeoutError,
    client_of,
    ensure_scheduler,
)
from ...storage.errors import (
    KeyNotFoundError,
    StorageError,
    UncertainResultError,
)
from ...proto import rpc_pb2
from ...trace import TRACER, traceparent_of
from . import shim
from .misc import ERR_LEASE_NOT_FOUND

PARTITION_MAGIC_REVISION = 1888  # reference kv.go:33
COMPACT_REV_KEY = b"compact_rev_key"  # the apiserver compactor's coordination key

ERR_COMPACTED = "etcdserver: mvcc: required revision has been compacted"
ERR_FUTURE_REV = "etcdserver: mvcc: required revision is a future revision"


class _RawResponse(bytes):
    """Pre-serialized response body; the native-front backhaul sends it
    verbatim (front.py skips SerializeToString for bytes)."""

    def SerializeToString(self) -> bytes:  # grpc-python serializer hook
        return bytes(self)


class KVService:
    def __init__(self, backend: Backend, peers=None, limiter=None,
                 replica=None):
        self.backend = backend
        self.peers = peers  # PeerService: leader check / proxy / revision sync
        #: follower role (``replica.FollowerRole`` under ``--role
        #: follower``, None on a leader): per-RPC routing — reads gate on
        #: the replication watermark and then ride the SAME scheduler
        #: lanes below; writes/compaction forward to the leader
        self.replica = replica
        # the device-aware request scheduler: every range read goes through
        # its admission lanes (kblint KB106). All services over one backend
        # share one scheduler, or priority lanes mean nothing.
        self.limiter = limiter if limiter is not None else ensure_scheduler(backend)

    _client_of = staticmethod(client_of)  # fair-queuing flow id (sched)

    # ------------------------------------------------------------------ Range
    def Range(self, request: rpc_pb2.RangeRequest, context) -> rpc_pb2.RangeResponse:
        # every Range is one span tree in /debug/traces; the client's W3C
        # traceparent (gRPC metadata) parents it when the transport has one
        with TRACER.span("etcd.KV/Range", traceparent=traceparent_of(context)):
            return self._range(request, context)

    def _range(self, request: rpc_pb2.RangeRequest, context) -> rpc_pb2.RangeResponse:
        with TRACER.stage("endpoint_recv"):
            # the native-front backhaul forwards pre-serialized bytes
            # verbatim; python-grpc listeners reserialize, so the raw path
            # is front-only
            raw_ok = bool(getattr(context, "kb_raw_ok", False))
            if self.peers is not None:
                self.peers.sync_read_revision()
            # etcd range conventions: empty range_end = the single key;
            # range_end == b"\0" = everything >= key ("from key")
            range_end = bytes(request.range_end)
            single_key = not range_end
            if range_end == b"\x00":
                range_end = b""
        if (self.replica is not None
                and request.revision != PARTITION_MAGIC_REVISION):
            # follower read gate (docs/replication.md): explicit revisions
            # <= watermark and bounded-staleness serializable reads serve
            # locally; rev-0 linearizable reads fence on the leader's
            # committed revision first; past-bound lag REFUSES (clients
            # fail over) instead of answering stale
            self._replica_gate(request, context)
        try:
            if request.count_only:
                if not self.backend.config.enable_etcd_compatibility:
                    # Count is an etcd-compat feature (reference range.go:188)
                    context.abort(
                        grpc.StatusCode.UNIMPLEMENTED,
                        "etcdserver: count requires etcd compatibility mode",
                    )
                if single_key:
                    try:
                        self.backend.get(request.key, request.revision)
                        n, rev = 1, self.backend.current_revision()
                    except KeyNotFoundError:
                        n, rev = 0, self.backend.current_revision()
                else:
                    n, rev = self.limiter.count(
                        request.key, range_end, request.revision,
                        client=self._client_of(context),
                    )
                with TRACER.stage("response_encode"):
                    return rpc_pb2.RangeResponse(header=shim.header(rev), count=n)
            if request.revision == PARTITION_MAGIC_REVISION:
                return self._partitions(request)
            if single_key:
                return self._get(request)
            return self._list(request, range_end, raw_ok, self._client_of(context))
        except SchedOverloadError as e:
            # admission control shed this request: the etcd error
            # kube-apiserver's client retries with backoff
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except CompactedError:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, ERR_COMPACTED)
        except FutureRevisionError:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, ERR_FUTURE_REV)

    def _replica_gate(self, request, context) -> None:
        from ...replica import (
            FutureRevisionWaitError,
            ReplicaRefusedError,
        )

        try:
            self.replica.gate_read(int(request.revision),
                                   bool(request.serializable))
        except FutureRevisionWaitError:
            # same wire shape a leader gives for a revision it has not
            # dealt yet: the client's classification (definite) and the
            # apiserver's re-list behavior both already handle it
            context.abort(grpc.StatusCode.OUT_OF_RANGE, ERR_FUTURE_REV)
        except ReplicaRefusedError as e:
            # etcdserver:-prefixed UNAVAILABLE = processed-and-refused,
            # provably nothing served: classify_rpc_error calls it safe,
            # so multi-endpoint clients fail over to the next replica
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"etcdserver: replica refused ({e.reason}): {e}")
        self.replica.note_served("range")

    def _get(self, request) -> rpc_pb2.RangeResponse:
        try:
            kv = self.backend.get(request.key, request.revision)
        except KeyNotFoundError:
            return rpc_pb2.RangeResponse(
                header=shim.header(self.backend.current_revision()), count=0
            )
        resp = rpc_pb2.RangeResponse(
            header=shim.header(max(self.backend.current_revision(), kv.revision)), count=1
        )
        if request.keys_only:
            kv = type(kv)(kv.key, b"", kv.revision)
        resp.kvs.append(shim.to_kv(kv))
        self._fix_version_token(resp, request.key)
        return resp

    @staticmethod
    def _fix_version_token(resp, key: bytes) -> None:
        """The apiserver compactor guards its coordination txns with
        Version(compact_rev_key) and treats the value as an opaque token read
        back from Get. The MVCC core doesn't track per-key versions (like the
        reference, backendshim.go maps only revisions), so for this one key
        version := mod_revision — a token that changes on every update, which
        is all the protocol needs (kv.go:211-230)."""
        if key == COMPACT_REV_KEY:
            for kv in resp.kvs:
                kv.version = kv.mod_revision

    def _list(self, request, range_end: bytes, raw_ok: bool = False,
              client: str = "") -> rpc_pb2.RangeResponse:
        # raw fast path: the C engine encodes RangeResponse.kvs wire bytes
        # directly (kb_mvcc_list_wire) and the native frontend forwards them
        # without reserialization — no per-row Python anywhere on the list
        # hot path. Only for the default sort/shape kube-apiserver uses.
        if (raw_ok
                and request.sort_target == rpc_pb2.RangeRequest.KEY
                and request.sort_order == rpc_pb2.RangeRequest.NONE
                and not request.keys_only
                and request.key != COMPACT_REV_KEY):
            fast = self.limiter.list_wire(
                request.key, range_end, request.revision, int(request.limit),
                client=client,
            )
            if fast is not None:
                blob, n, more, read_rev = fast
                with TRACER.stage("response_encode"):
                    scalar = rpc_pb2.RangeResponse(
                        header=shim.header(read_rev), more=more, count=n
                    ).SerializeToString()
                    return _RawResponse(scalar + blob)
        res = self.limiter.list_(
            request.key, range_end, request.revision, int(request.limit),
            client=client,
        )
        with TRACER.stage("response_encode"):
            resp = rpc_pb2.RangeResponse(
                header=shim.header(res.revision), more=res.more, count=len(res.kvs)
            )
            kvs = res.kvs
            # results are produced key-ascending; honor the sort options
            # clients like etcdctl send (kube-apiserver uses the default)
            if request.sort_target == rpc_pb2.RangeRequest.MOD:
                kvs = sorted(kvs, key=lambda kv: kv.revision)
            if request.sort_order == rpc_pb2.RangeRequest.DESCEND:
                kvs = list(reversed(kvs))
            for kv in kvs:
                if request.keys_only:
                    kv = type(kv)(kv.key, b"", kv.revision)
                resp.kvs.append(shim.to_kv(kv))
            return resp

    def _partitions(self, request) -> rpc_pb2.RangeResponse:
        """Partition borders as bare KeyValues (reference kv.go:54-57 +
        range.go:208-244): n+1 border keys for n partitions."""
        parts = self.backend.get_partitions(request.key, request.range_end)
        rev = self.backend.current_revision()
        resp = rpc_pb2.RangeResponse(header=shim.header(rev), count=len(parts) + 1)
        borders = [parts[0].left] + [p.right for p in parts]
        for b in borders:
            resp.kvs.add(key=b, mod_revision=rev)
        return resp

    # -------------------------------------------------------------------- Txn
    def Txn(self, request: rpc_pb2.TxnRequest, context) -> rpc_pb2.TxnResponse:
        with TRACER.span("etcd.KV/Txn", traceparent=traceparent_of(context)):
            return self._txn(request, context)

    def _txn(self, request: rpc_pb2.TxnRequest, context) -> rpc_pb2.TxnResponse:
        with TRACER.stage("endpoint_recv"):
            if self.replica is not None:
                # follower role: every write forwards to the leader with
                # status passthrough — the client's safe-vs-ambiguous
                # classification must see exactly what a direct call would
                # (docs/replication.md)
                return self.replica.forward_unary("txn", request, context)
            if self.peers is not None and not self.peers.is_leader():
                fwd = self.peers.forward_txn(request)
                if fwd is not None:
                    return fwd
                context.abort(grpc.StatusCode.UNAVAILABLE, "etcdserver: not leader")
            m = self._match(request, context)
        kind, key, guard_rev, value, lease = m
        client = self._client_of(context)
        try:
            # writes go through the scheduler like reads (kblint KB106):
            # admission lanes + group commit — a freed slot drains queued
            # compatible writes into ONE backend.write_batch commit group
            # (contiguous revision block, one engine round trip, per-op
            # conflict demux; docs/writes.md)
            with TRACER.stage("backend_write"):
                if kind == "create":
                    rev = self.limiter.create(key, value, lease=lease,
                                              client=client)
                elif kind == "update":
                    rev = self.limiter.update(key, value, guard_rev,
                                              lease=lease, client=client)
                else:  # delete
                    rev, _prev = self.limiter.delete(key, guard_rev,
                                                     client=client)
            with TRACER.stage("response_encode"):
                return self._txn_ok(rev, put=kind != "delete")
        except SchedResultTimeoutError:
            # the result wait timed out AFTER dispatch: the write may yet
            # commit, so signal the ambiguous outcome the way etcd does
            # (ErrTimeout → DeadlineExceeded), never the safe-to-retry
            # RESOURCE_EXHAUSTED an admission shed gets
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "etcdserver: request timed out")
        except SchedOverloadError as e:
            # write shed by admission control BEFORE a revision was dealt:
            # safe to retry, and the etcd error the apiserver's client
            # already backs off on
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except LeaseNotFoundError:
            # a put under an unknown/expired lease is a definite failure
            # (etcd ErrLeaseNotFound) — the apiserver re-grants and retries
            context.abort(grpc.StatusCode.NOT_FOUND, ERR_LEASE_NOT_FOUND)
        except KeyExistsError as e:
            return self._txn_failed(request, e.revision)
        except (CASRevisionMismatchError,) as e:
            return self._txn_failed(request, e.revision)
        except KeyNotFoundError:
            return self._txn_failed(request, 0)
        except FutureRevisionError:
            # drift-back race (a concurrent op drew a higher revision than
            # this txn's dealt one): definite failure, safe to retry —
            # UNAVAILABLE makes clients (apiserver) re-issue the txn, which
            # deals a fresh revision (reference ErrRevisionDriftBack,
            # txn.go:171-175)
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "etcdserver: revision drift, retry txn")
        except UncertainResultError:
            # the engine cannot know whether the commit landed: the SAME
            # ambiguous status as a post-dispatch result timeout (etcd
            # ErrTimeout → DeadlineExceeded). Clients must NEVER blind-
            # retry a non-idempotent write on this status — the async
            # retry FIFO resolves the outcome server-side (docs/faults.md)
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "etcdserver: request timed out")
        except StorageError as e:
            # definite engine refusal BEFORE anything applied (e.g. an
            # injected storage fault): UNAVAILABLE with the etcdserver:
            # prefix = processed-and-refused, safe to retry
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"etcdserver: storage error: {e}")

    def _match(self, request, context):
        """Classify the txn (reference kv.go:160-230). Returns
        (kind, key, guard_revision, value, lease_id)."""
        if len(request.compare) != 1 or len(request.success) != 1:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "etcdserver: unsupported transaction shape",
            )
        cmp = request.compare[0]
        if cmp.result != rpc_pb2.Compare.EQUAL or cmp.target not in (
            rpc_pb2.Compare.MOD,
            rpc_pb2.Compare.VERSION,
            rpc_pb2.Compare.CREATE,
        ):
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED, "etcdserver: unsupported compare"
            )
        guard = (
            cmp.mod_revision
            if cmp.target == rpc_pb2.Compare.MOD
            else cmp.version if cmp.target == rpc_pb2.Compare.VERSION else cmp.create_revision
        )
        op = request.success[0]
        which = op.WhichOneof("request")
        if which == "request_put":
            if op.request_put.key != cmp.key:
                context.abort(grpc.StatusCode.UNIMPLEMENTED, "etcdserver: key mismatch")
            kind = "create" if guard == 0 else "update"
            # real lease attachment: PutRequest.lease names a lease granted
            # by LeaseService; the backend write path binds the key to it
            # and the reaper owns expiry (an explicit lease always beats the
            # legacy key-pattern TTL — docs/storage_engine.md precedence)
            lease = int(op.request_put.lease) if op.request_put.lease > 0 else 0
            return kind, bytes(op.request_put.key), int(guard), bytes(op.request_put.value), lease
        if which == "request_delete_range":
            if op.request_delete_range.key != cmp.key:
                context.abort(grpc.StatusCode.UNIMPLEMENTED, "etcdserver: key mismatch")
            return "delete", bytes(op.request_delete_range.key), int(guard), b"", 0
        context.abort(
            grpc.StatusCode.UNIMPLEMENTED, "etcdserver: unsupported transaction op"
        )

    def _txn_ok(self, revision: int, put: bool) -> rpc_pb2.TxnResponse:
        resp = rpc_pb2.TxnResponse(header=shim.header(revision), succeeded=True)
        op = resp.responses.add()
        if put:
            op.response_put.header.revision = revision
        else:
            op.response_delete_range.header.revision = revision
            op.response_delete_range.deleted = 1
        return resp

    def _txn_failed(self, request, current_rev: int) -> rpc_pb2.TxnResponse:
        """Failed guard: run the failure branch (always [OpGet(key)] from
        kube-apiserver) so the client sees the current kv."""
        resp = rpc_pb2.TxnResponse(
            header=shim.header(self.backend.current_revision()), succeeded=False
        )
        for op in request.failure:
            if op.WhichOneof("request") != "request_range":
                continue
            r = op.request_range
            try:
                kv = self.backend.get(r.key, r.revision)
                rr = rpc_pb2.RangeResponse(header=shim.header(kv.revision), count=1)
                rr.kvs.append(shim.to_kv(kv))
                self._fix_version_token(rr, bytes(r.key))
            except (KeyNotFoundError, CompactedError):
                rr = rpc_pb2.RangeResponse(
                    header=shim.header(self.backend.current_revision()), count=0
                )
            resp.responses.add().response_range.CopyFrom(rr)
        return resp

    # ----------------------------------------------------------------- Compact
    def Compact(self, request: rpc_pb2.CompactionRequest, context) -> rpc_pb2.CompactionResponse:
        if self.replica is not None:
            # compaction is the leader's job; the follower adopts the new
            # watermark through the replication stream's compact sync
            return self.replica.forward_unary("compact", request, context)
        if self.peers is not None and not self.peers.is_leader():
            # compaction is the leader's job; accept and no-op on followers
            return rpc_pb2.CompactionResponse(
                header=shim.header(self.backend.current_revision())
            )
        done = self.backend.compact(request.revision)
        return rpc_pb2.CompactionResponse(header=shim.header(done))

    # ------------------------------------------------- unsupported raw writes
    def Put(self, request, context):
        context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "etcdserver: raw Put is not supported; use Txn",  # kv.go:142-148
        )

    def DeleteRange(self, request, context):
        context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "etcdserver: raw DeleteRange is not supported; use Txn",
        )
