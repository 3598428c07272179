"""Client library — the kubebrain-client module role (SURVEY §2.7).

Two surfaces, matching the server:

- ``EtcdCompatClient`` speaks the etcd3 subset (what kube-apiserver uses) and
  adds the custom-apiserver extensions the reference supports: partition
  borders via the magic revision (kv.go:33) and **partition-parallel
  listing** over the list-over-watch stream protocol (negative start
  revision, watch.go:150-152,204) — each partition streams concurrently,
  the client merges in key order (SURVEY §5c);
- ``BrainClient`` speaks the lean native protocol (Create/Update/Delete/
  Compact/Get/Range/RangeStream/Count/ListPartition/Watch).

No generated stubs: raw grpc channels + the protos in
kubebrain_tpu_torch.proto. Counterpart of ``kubebrain_tpu/client.py``, with
the same names; it imports ``grpc`` and runs where the front runs (the
CPU), never in the wiring below the front.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import grpc

from .proto import brain_pb2, kv_pb2, rpc_pb2
from .trace import make_traceparent

PARTITION_MAGIC_REVISION = 1888

# --------------------------------------------------------- retry classification
#
# The safe-vs-ambiguous discipline (docs/faults.md): a write RPC may only be
# retried when its failure provably means NOTHING was applied. The server
# splits its status codes for exactly this (docs/writes.md):
#
# - RESOURCE_EXHAUSTED      — admission shed BEFORE a revision was dealt;
# - "etcdserver:"-prefixed UNAVAILABLE — processed-and-refused (drift,
#   storage fault refusal, not-leader): the handler ran and definitively
#   declined;
# - DEADLINE_EXCEEDED / CANCELLED / UNKNOWN / bare UNAVAILABLE — the op may
#   have committed (result-wait timeout, engine uncertainty, connection
#   drop mid-call): NEVER blind-retry a non-idempotent write here — a
#   retried create/update that already landed reports a spurious conflict.
#
# Reads are idempotent: every failure is safe to retry.

#: deterministic refusals: provably nothing applied AND re-sending the
#: identical request cannot change the answer (bad lease, compacted
#: revision, unsupported shape, auth) — retrying is pure waste
_DETERMINISTIC_CODES = frozenset({
    grpc.StatusCode.NOT_FOUND,
    grpc.StatusCode.OUT_OF_RANGE,
    grpc.StatusCode.UNIMPLEMENTED,
    grpc.StatusCode.INVALID_ARGUMENT,
    grpc.StatusCode.FAILED_PRECONDITION,
    grpc.StatusCode.PERMISSION_DENIED,
    grpc.StatusCode.UNAUTHENTICATED,
})


def classify_rpc_error(err: grpc.RpcError, write: bool) -> str:
    """``"safe"`` (definitely not applied — a retry may succeed),
    ``"definite"`` (definitely not applied — retrying the identical
    request is pointless), or ``"ambiguous"`` (maybe applied — never
    blind-retry a write). Reads are never worse than ``"safe"``."""
    code = err.code() if hasattr(err, "code") else None
    if code in _DETERMINISTIC_CODES:
        return "definite"
    if not write:
        return "safe"
    if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
        # admission shed BEFORE a revision was dealt: a backed-off retry
        # lands in capacity that may have freed up
        return "safe"
    details = err.details() if hasattr(err, "details") else ""
    if code == grpc.StatusCode.UNAVAILABLE and "etcdserver:" in (details or ""):
        # server-side transient refusal (drift / not-leader / storage-fault
        # refusal): the handler answered, nothing was applied, and the
        # condition clears (fresh revision, new leader, fault window ends)
        return "safe"
    return "ambiguous"


class _RetryingCall:
    """Bounded, jitter-backoff retry around a unary call, gated by the
    safe-vs-ambiguous classification — an ambiguous write failure is NEVER
    retried (it surfaces to the caller, who owns the read-back). Attempts
    beyond the first are counted in ``counter[method]`` so harnesses that
    reconcile client RPC counts against server /metrics stay exact."""

    __slots__ = ("_call", "_write", "_retries", "_backoff", "_method",
                 "_counter")

    def __init__(self, call, write: bool, retries: int, backoff_s: float,
                 method: str, counter):
        self._call = call
        self._write = write
        self._retries = retries
        self._backoff = backoff_s
        self._method = method
        self._counter = counter

    def __call__(self, request, timeout=None, metadata=None):
        import random

        attempt = 0
        while True:
            try:
                return self._call(request, timeout=timeout, metadata=metadata)
            except grpc.RpcError as e:
                attempt += 1
                if (attempt > self._retries
                        or classify_rpc_error(e, self._write) != "safe"):
                    raise
                if self._counter is not None:
                    self._counter[self._method] += 1
                time.sleep(self._backoff * attempt
                           * random.uniform(0.5, 1.5))

    def future(self, request, timeout=None, metadata=None):
        # the pipelined path manages its own windows; no transparent retry
        return self._call.future(request, timeout=timeout, metadata=metadata)


class _TracedCall:
    """Wraps a grpc multicallable so every invocation carries a W3C
    ``traceparent`` metadata entry — the server parents its span tree under
    it, so a client-observed slow call is findable in ``/debug/traces`` by
    trace id. Continues the ambient span's trace when the caller is itself
    inside one. ``future`` (unary multicallables only) is the pipelined
    path bulk helpers use to keep a window of RPCs in flight on one
    channel."""

    __slots__ = ("_call",)

    def __init__(self, callable_):
        self._call = callable_

    @staticmethod
    def _md(metadata):
        return tuple(metadata or ()) + (("traceparent", make_traceparent()),)

    def __call__(self, request, timeout=None, metadata=None):
        return self._call(request, timeout=timeout, metadata=self._md(metadata))

    def future(self, request, timeout=None, metadata=None):
        return self._call.future(
            request, timeout=timeout, metadata=self._md(metadata))


def _traced_call(callable_):
    return _TracedCall(callable_)


class _FailoverCall:
    """One logical unary method over several endpoints (docs/replication.md):
    round-robin selection per call, with SAFE-ONLY failover — an attempt
    whose failure classifies ``safe`` (provably nothing applied: replica
    staleness refusal, admission shed, not-leader) moves on to the next
    endpoint; ``ambiguous`` and ``definite`` failures surface immediately,
    exactly like a single-endpoint call. Extra attempts land in
    ``client.endpoint_failovers`` (the kb_client_endpoint_failovers count
    the workload harness surfaces), and every successful response's header
    revision is recorded per endpoint — the harness's
    response-revision <= applied-watermark reconcile reads it."""

    __slots__ = ("_client", "_calls", "_targets", "_write", "_method")

    def __init__(self, client, calls, targets, write: bool, method: str):
        self._client = client
        self._calls = calls
        self._targets = targets
        self._write = write
        self._method = method

    def __call__(self, request, timeout=None, metadata=None):
        n = len(self._calls)
        start = self._client._next_endpoint()
        last: grpc.RpcError | None = None
        for k in range(n):
            i = (start + k) % n
            try:
                resp = self._calls[i](request, timeout=timeout,
                                      metadata=metadata)
            except grpc.RpcError as e:
                last = e
                if k == n - 1 or classify_rpc_error(e, self._write) != "safe":
                    raise
                self._client._note_failover(self._method)
                continue
            self._client._note_endpoint_revision(self._targets[i], resp)
            return resp
        raise last  # unreachable; keeps the contract explicit

    def future(self, request, timeout=None, metadata=None):
        # pipelined bulk paths manage their own windows; no failover
        i = self._client._next_endpoint() % len(self._calls)
        return self._calls[i].future(request, timeout=timeout,
                                     metadata=metadata)


class _RotatingStreamCall:
    """Stream multicallable over several endpoints: each stream OPEN picks
    the next endpoint round-robin. Failover for streams is the consumer's
    re-open (WatchMux revive opens a fresh stream → next endpoint)."""

    __slots__ = ("_client", "_calls")

    def __init__(self, client, calls):
        self._client = client
        self._calls = calls

    def __call__(self, request_iterator):
        i = self._client._next_endpoint() % len(self._calls)
        return self._calls[i](request_iterator)


@dataclass
class ClientKV:
    key: bytes
    value: bytes
    mod_revision: int


class EtcdCompatClient:
    def __init__(self, target: str | list[str] | tuple[str, ...] | None = None,
                 credentials: grpc.ChannelCredentials | None = None,
                 retries: int = 0, retry_backoff_s: float = 0.05,
                 endpoints: list[str] | None = None):
        """``retries`` > 0 arms transparent retry of SAFE failures only
        (classify_rpc_error): reads retry on anything, writes only on
        provably-not-applied refusals — an ambiguous write outcome always
        surfaces. ``self.retries_sent`` counts the extra attempts per
        method (harnesses add them to their reconcile counts).

        Multi-endpoint mode (``endpoints=[...]`` or a list ``target``):
        one channel per endpoint, unary calls round-robin across them
        with SAFE-ONLY failover to the next endpoint (a replica staleness
        refusal or not-leader moves on; an ambiguous write failure never
        does) — ``self.endpoint_failovers`` counts the extra attempts,
        and ``self.max_header_revision[endpoint]`` tracks the highest
        response revision each endpoint served (the replica harness's
        revision-consistency reconcile). Streams (Watch/LeaseKeepAlive)
        pick an endpoint per stream open."""
        if endpoints is None and not isinstance(target, str):
            endpoints = list(target or ())
        if endpoints is not None:
            eps = [e for e in endpoints if e]
            if not eps:
                raise ValueError("endpoints must name at least one target")
        else:
            eps = [target]
        self._endpoints = eps
        self._multi = endpoints is not None
        mk = (lambda t: grpc.secure_channel(t, credentials)) if credentials \
            else grpc.insecure_channel
        self.channels = [mk(t) for t in eps]
        self.channel = self.channels[0]  # single-endpoint back-compat
        self._retry_budget = retries
        self._retry_backoff_s = retry_backoff_s
        self.retries_sent: collections.Counter = collections.Counter()
        #: safe-only endpoint failovers (kb_client_endpoint_failovers)
        self.endpoint_failovers = 0
        self.failovers_by_method: collections.Counter = collections.Counter()
        #: endpoint -> highest response header revision it served
        self.max_header_revision: dict[str, int] = {}
        self._ep_lock = threading.Lock()
        self._ep_rr = 0
        p = rpc_pb2
        self._range = self._unary("/etcdserverpb.KV/Range", p.RangeRequest, p.RangeResponse)
        #: per-endpoint Range callables for snapshot-pinned pagination
        #: (list()): later pages MUST stay on the endpoint that pinned
        #: page 1's revision — a different replica may not have applied
        #: that revision yet (or may have a higher compact floor)
        self._range_per_ep = [
            _RetryingCall(call, False, retries, retry_backoff_s,
                          "/etcdserverpb.KV/Range", self.retries_sent)
            if retries > 0 else call
            for call in (
                _traced_call(ch.unary_unary(
                    "/etcdserverpb.KV/Range",
                    request_serializer=p.RangeRequest.SerializeToString,
                    response_deserializer=p.RangeResponse.FromString,
                ))
                for ch in self.channels
            )
        ] if self._multi else None
        self._txn = self._unary("/etcdserverpb.KV/Txn", p.TxnRequest, p.TxnResponse,
                                write=True)
        self._compact = self._unary("/etcdserverpb.KV/Compact", p.CompactionRequest, p.CompactionResponse,
                                    write=True)
        self._watch = self._stream(
            "/etcdserverpb.Watch/Watch", p.WatchRequest, p.WatchResponse)
        self._lease_grant = self._unary(
            "/etcdserverpb.Lease/LeaseGrant", p.LeaseGrantRequest, p.LeaseGrantResponse,
            write=True)
        self._lease_revoke = self._unary(
            "/etcdserverpb.Lease/LeaseRevoke", p.LeaseRevokeRequest, p.LeaseRevokeResponse,
            write=True)
        self._lease_ttl = self._unary(
            "/etcdserverpb.Lease/LeaseTimeToLive",
            p.LeaseTimeToLiveRequest, p.LeaseTimeToLiveResponse)
        self._lease_leases = self._unary(
            "/etcdserverpb.Lease/LeaseLeases", p.LeaseLeasesRequest, p.LeaseLeasesResponse)
        self._lease_keepalive = self._stream(
            "/etcdserverpb.Lease/LeaseKeepAlive",
            p.LeaseKeepAliveRequest, p.LeaseKeepAliveResponse)

    # ------------------------------------------------- endpoint selection
    def _next_endpoint(self) -> int:
        with self._ep_lock:
            i = self._ep_rr
            self._ep_rr += 1
            return i

    def _note_failover(self, method: str) -> None:
        with self._ep_lock:
            self.endpoint_failovers += 1
            self.failovers_by_method[method] += 1

    def _note_endpoint_revision(self, target: str, resp) -> None:
        header = getattr(resp, "header", None)
        rev = int(getattr(header, "revision", 0) or 0)
        if not rev:
            return
        with self._ep_lock:
            if rev > self.max_header_revision.get(target, 0):
                self.max_header_revision[target] = rev

    def _unary(self, method, req, resp, write: bool = False):
        calls = [
            _traced_call(ch.unary_unary(
                method,
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ))
            for ch in self.channels
        ]
        if self._multi:
            call = _FailoverCall(self, calls, self._endpoints, write, method)
        else:
            call = calls[0]
        if self._retry_budget > 0:
            call = _RetryingCall(call, write, self._retry_budget,
                                 self._retry_backoff_s, method,
                                 self.retries_sent)
        return call

    def _stream(self, method, req, resp):
        calls = [
            _traced_call(ch.stream_stream(
                method,
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ))
            for ch in self.channels
        ]
        if self._multi:
            return _RotatingStreamCall(self, calls)
        return calls[0]

    # --------------------------------------------------------------- writes
    @staticmethod
    def _create_txn(key: bytes, value: bytes, lease: int = 0) -> rpc_pb2.TxnRequest:
        req = rpc_pb2.TxnRequest()
        c = req.compare.add()
        c.result, c.target, c.key, c.mod_revision = (
            rpc_pb2.Compare.EQUAL, rpc_pb2.Compare.MOD, key, 0,
        )
        req.success.add().request_put.CopyFrom(
            rpc_pb2.PutRequest(key=key, value=value, lease=lease))
        req.failure.add().request_range.CopyFrom(rpc_pb2.RangeRequest(key=key))
        return req

    @staticmethod
    def _parse_put_txn(r) -> tuple[bool, int]:
        if r.succeeded:
            return True, r.responses[0].response_put.header.revision
        kvs = r.responses[0].response_range.kvs
        return False, kvs[0].mod_revision if kvs else 0

    def create(self, key: bytes, value: bytes, lease: int = 0) -> tuple[bool, int]:
        """(succeeded, revision) — revision is the new mod revision on
        success, the existing one on conflict. ``lease`` attaches the key
        to a granted lease (see :meth:`lease`)."""
        return self._parse_put_txn(self._txn(self._create_txn(key, value, lease)))

    def create_bulk(self, items: Iterable[tuple[bytes, bytes]], lease: int = 0,
                    window: int = 128) -> list[tuple[bool, int]]:
        """Pipelined creates: up to ``window`` Txn futures in flight on one
        channel, results in input order. This is the preload path of the
        workload replay harness — a sequential create() loop is bounded by
        one RTT per key, the future window by the server's commit rate."""
        out: list[tuple[bool, int]] = []
        pending: collections.deque = collections.deque()
        for key, value in items:
            if len(pending) >= window:
                out.append(self._parse_put_txn(pending.popleft().result()))
            pending.append(self._txn.future(self._create_txn(key, value, lease)))
        while pending:
            out.append(self._parse_put_txn(pending.popleft().result()))
        return out

    def update(self, key: bytes, value: bytes, mod_revision: int,
               lease: int = 0) -> tuple[bool, int]:
        req = rpc_pb2.TxnRequest()
        c = req.compare.add()
        c.result, c.target, c.key, c.mod_revision = (
            rpc_pb2.Compare.EQUAL, rpc_pb2.Compare.MOD, key, mod_revision,
        )
        req.success.add().request_put.CopyFrom(
            rpc_pb2.PutRequest(key=key, value=value, lease=lease))
        req.failure.add().request_range.CopyFrom(rpc_pb2.RangeRequest(key=key))
        r = self._txn(req)
        if r.succeeded:
            return True, r.responses[0].response_put.header.revision
        kvs = r.responses[0].response_range.kvs
        return False, kvs[0].mod_revision if kvs else 0

    def delete(self, key: bytes, mod_revision: int = 0) -> bool:
        req = rpc_pb2.TxnRequest()
        c = req.compare.add()
        c.result, c.target, c.key, c.mod_revision = (
            rpc_pb2.Compare.EQUAL, rpc_pb2.Compare.MOD, key, mod_revision,
        )
        if mod_revision == 0:
            got = self.get(key)
            if got is None:
                return False
            c.mod_revision = got.mod_revision
        req.success.add().request_delete_range.CopyFrom(rpc_pb2.DeleteRangeRequest(key=key))
        req.failure.add().request_range.CopyFrom(rpc_pb2.RangeRequest(key=key))
        return self._txn(req).succeeded

    def compact(self, revision: int) -> None:
        self._compact(rpc_pb2.CompactionRequest(revision=revision))

    # ---------------------------------------------------------------- reads
    def get(self, key: bytes, revision: int = 0,
            serializable: bool = False) -> ClientKV | None:
        r = self._range(rpc_pb2.RangeRequest(key=key, revision=revision,
                                             serializable=serializable))
        if not r.kvs:
            return None
        kv = r.kvs[0]
        return ClientKV(kv.key, kv.value, kv.mod_revision)

    def list(
        self, start: bytes, end: bytes, revision: int = 0, limit: int = 0,
        page: int = 1000, stats: dict | None = None,
        serializable: bool = False,
    ) -> tuple[list[ClientKV], int]:
        """Paginated list; returns (kvs, list_revision). ``stats`` (if
        given) has its ``"rpcs"`` entry incremented per Range RPC *issued*
        (before the call, so shed/errored pages are still counted) — the
        workload harness reconciles client-side RPC counts against the
        server's /metrics, which counts failed RPCs too, and pagination
        makes ops != RPCs. ``serializable`` marks the read bounded-
        staleness-tolerant: a replica serves it locally at its applied
        watermark instead of fencing on the leader (docs/replication.md);
        later pages pin the first page's snapshot revision either way.

        Multi-endpoint clients pin the whole pagination to ONE endpoint:
        once page 1 pinned a snapshot revision, a different replica may
        not have applied it yet (bounded wait then a future-revision
        refusal) or may have compacted/bootstrapped above it — so only
        the FIRST page fails over (safe-classified errors rotate to the
        next endpoint, counted in ``endpoint_failovers``)."""
        out: list[ClientKV] = []
        key = start
        list_rev = revision
        if self._range_per_ep is not None:
            n = len(self._range_per_ep)
            ep = self._next_endpoint() % n
        first_attempts = 0
        while True:
            want = min(page, limit - len(out)) if limit else page
            if stats is not None:
                stats["rpcs"] = stats.get("rpcs", 0) + 1
            req = rpc_pb2.RangeRequest(
                key=key, range_end=end, revision=list_rev, limit=want,
                serializable=serializable,
            )
            if self._range_per_ep is None:
                r = self._range(req)
            else:
                try:
                    r = self._range_per_ep[ep](req)
                except grpc.RpcError as e:
                    first_attempts += 1
                    if (not out and list_rev == revision
                            and first_attempts < n
                            and classify_rpc_error(e, False) == "safe"):
                        # nothing pinned yet: rotate like _FailoverCall.
                        # endpoint_failovers only — the retried page is
                        # already counted in the caller's stats["rpcs"],
                        # so failovers_by_method (which reconciles as an
                        # EXTRA server-side RPC) must not count it twice
                        ep = (ep + 1) % n
                        with self._ep_lock:
                            self.endpoint_failovers += 1
                        continue
                    raise
                self._note_endpoint_revision(self._endpoints[ep], r)
            if list_rev == 0:
                list_rev = r.header.revision  # pin the snapshot for later pages
            out.extend(ClientKV(kv.key, kv.value, kv.mod_revision) for kv in r.kvs)
            if not r.more or (limit and len(out) >= limit):
                return out, list_rev
            key = r.kvs[-1].key + b"\x00"

    def list_unpaged(
        self, start: bytes, end: bytes, revision: int = 0,
        serializable: bool = False,
    ) -> tuple[list[ClientKV], int]:
        """One unpaged Range (limit=0) — the informer-relist/snapshot shape
        the scheduler classifies BACKGROUND. ``list()`` always pages and so
        always rides the NORMAL lane; replaying realistic relist storms
        needs the heavyweight shape on the wire."""
        r = self._range(rpc_pb2.RangeRequest(
            key=start, range_end=end, revision=revision,
            serializable=serializable))
        return ([ClientKV(kv.key, kv.value, kv.mod_revision) for kv in r.kvs],
                r.header.revision)

    def count(self, start: bytes, end: bytes,
              serializable: bool = False) -> int:
        r = self._range(rpc_pb2.RangeRequest(key=start, range_end=end,
                                             count_only=True,
                                             serializable=serializable))
        return r.count

    def current_revision(self) -> int:
        """The server's committed revision (one linearizable empty-count
        Range) — the replica harness's fence-probe anchor."""
        return self._range(rpc_pb2.RangeRequest(
            key=b"\x00kb-probe", range_end=b"\x00kb-probe0",
            count_only=True)).header.revision

    def partition_borders(self, start: bytes, end: bytes) -> list[bytes]:
        """Storage partition borders (magic revision; reference kv.go:33)."""
        r = self._range(rpc_pb2.RangeRequest(
            key=start, range_end=end, revision=PARTITION_MAGIC_REVISION
        ))
        return [kv.key for kv in r.kvs]

    def parallel_list(
        self, start: bytes, end: bytes, revision: int = 0
    ) -> Iterator[ClientKV]:
        """Partition-parallel listing: one list-over-watch stream per
        partition, all concurrent, yielded in key order (the scale trick the
        reference's custom apiserver uses for huge ranges, SURVEY §5c)."""
        borders = self.partition_borders(start, end)
        if len(borders) < 2:
            kvs, _ = self.list(start, end, revision)
            yield from kvs
            return
        rev = revision or self._range(
            rpc_pb2.RangeRequest(key=start, range_end=end, limit=1)
        ).header.revision
        parts = list(zip(borders[:-1], borders[1:]))
        results: list[list[ClientKV] | None] = [None] * len(parts)

        def fetch(i, lo, hi):
            results[i] = list(self._stream_partition(lo, hi, rev))

        threads = [
            threading.Thread(target=fetch, args=(i, lo, hi), daemon=True)
            for i, (lo, hi) in enumerate(parts)
        ]
        for t in threads:
            t.start()
        for i, t in enumerate(threads):
            t.join()
            yield from results[i]  # partitions are key-ordered

    def _stream_partition(self, lo: bytes, hi: bytes, revision: int):
        """One list-over-watch range stream (negative start revision)."""
        requests: queue.Queue = queue.Queue()
        req = rpc_pb2.WatchRequest()
        req.create_request.key = lo
        req.create_request.range_end = hi
        req.create_request.start_revision = -revision
        requests.put(req)
        responses = self._watch(iter(requests.get, None))
        try:
            for resp in responses:
                for ev in resp.events:
                    yield ClientKV(ev.kv.key, ev.kv.value, ev.kv.mod_revision)
                if resp.canceled:
                    return
        finally:
            requests.put(None)

    # ---------------------------------------------------------------- leases
    def lease_grant(self, ttl: int, lease_id: int = 0) -> tuple[int, int]:
        """Grant a lease; returns (id, granted_ttl_seconds)."""
        r = self._lease_grant(rpc_pb2.LeaseGrantRequest(TTL=ttl, ID=lease_id))
        return r.ID, r.TTL

    def lease_revoke(self, lease_id: int) -> None:
        """Revoke: every attached key is deleted (watch-visible tombstones)."""
        self._lease_revoke(rpc_pb2.LeaseRevokeRequest(ID=lease_id))

    def lease_time_to_live(self, lease_id: int, keys: bool = False
                           ) -> tuple[int, int, list[bytes]]:
        """(remaining_ttl, granted_ttl, attached_keys). remaining_ttl is -1
        once the lease is expired or unknown."""
        r = self._lease_ttl(rpc_pb2.LeaseTimeToLiveRequest(ID=lease_id, keys=keys))
        return r.TTL, r.grantedTTL, list(r.keys)

    def lease_leases(self) -> list[int]:
        return [l.ID for l in self._lease_leases(rpc_pb2.LeaseLeasesRequest()).leases]

    def lease(self, ttl: int, keepalive_interval: float | None = None,
              ready_timeout: float = 30.0) -> "LeaseHandle":
        """Grant a lease and keep it alive from a background thread.

        The thread pings on a jittered cadence (default TTL/3 ±20% — a
        fleet of clients granted in the same instant must not land their
        keepalives in the same instant forever). Like :meth:`watch`, the
        first keepalive ack is fenced by a stack-dumping watchdog: if the
        server doesn't ack within ``ready_timeout`` every thread's stack is
        dumped and the stream cancelled, instead of a silent wedge that
        surfaces minutes later as an expired lease."""
        lease_id, granted = self.lease_grant(ttl)
        interval = keepalive_interval if keepalive_interval is not None \
            else max(granted / 3.0, 0.5)
        return LeaseHandle(self, lease_id, granted, interval, ready_timeout)

    # ---------------------------------------------------------------- watch
    def watch(
        self, key: bytes, range_end: bytes = b"", start_revision: int = 0,
        prev_kv: bool = False, ready_timeout: float = 30.0,
    ):
        """Returns (events_iterator, cancel_fn). Events are (type, ClientKV,
        prev ClientKV|None) tuples; the iterator ends on cancel.

        Blocks until the server acks registration (``created=True``):
        without the ack, a write issued right after watch() returns races
        the server-side ``watch_range`` registration — with start_revision
        0 there is no replay, so the event is silently missed and the
        caller waits forever (the intermittent test_client crud_watch
        wedge). A watchdog dumps every thread's stack and cancels the
        stream if the ack doesn't arrive within ``ready_timeout``."""
        requests: queue.Queue = queue.Queue()
        req = rpc_pb2.WatchRequest()
        req.create_request.key = key
        req.create_request.range_end = range_end
        req.create_request.start_revision = start_revision
        req.create_request.prev_kv = prev_kv
        requests.put(req)
        responses = self._watch(iter(requests.get, None))
        rpc_error = grpc.RpcError  # closure-bound: survives module teardown

        ack_lock = threading.Lock()
        acked = False
        fired = False

        def _ack_watchdog():
            nonlocal fired
            import faulthandler
            import sys

            with ack_lock:
                if acked:
                    return  # ack won the race with the timer firing
                fired = True
            sys.__stderr__.write(
                f"[client.watch] no created ack within {ready_timeout}s; "
                "dumping all thread stacks and cancelling the stream\n")
            faulthandler.dump_traceback(file=sys.__stderr__)
            sys.__stderr__.flush()
            responses.cancel()

        pending: list = []  # event-bearing responses seen before the ack
        watchdog = threading.Timer(ready_timeout, _ack_watchdog)
        watchdog.daemon = True
        watchdog.start()
        try:
            for resp in responses:
                with ack_lock:
                    acked = True  # any server response proves liveness
                if resp.events or resp.canceled:
                    # events()/the caller must still see these
                    pending.append(resp)
                if resp.created or resp.canceled:
                    break
        except rpc_error as e:
            raise TimeoutError(
                "watch registration not acked by server "
                f"(stream error: {e})") from e
        finally:
            watchdog.cancel()
        with ack_lock:
            if fired:
                # the timer cancelled the stream just as the ack landed:
                # the watch is dead, surface it instead of silently ending
                raise TimeoutError(
                    "watch stream cancelled by the registration watchdog")

        import itertools

        def events():
            try:
                for resp in itertools.chain(pending, responses):
                    if resp.canceled:
                        return
                    for ev in resp.events:
                        kind = "DELETE" if ev.type == kv_pb2.Event.DELETE else "PUT"
                        prev = (
                            ClientKV(ev.prev_kv.key, ev.prev_kv.value, ev.prev_kv.mod_revision)
                            if ev.HasField("prev_kv")
                            else None
                        )
                        yield kind, ClientKV(ev.kv.key, ev.kv.value, ev.kv.mod_revision), prev
            except rpc_error:
                return

        def cancel():
            requests.put(None)

        return events(), cancel

    def close(self) -> None:
        for ch in self.channels:
            ch.close()


class LeaseHandle:
    """A granted lease plus its background keepalive thread (see
    EtcdCompatClient.lease). ``alive`` flips False once the server reports
    the lease gone (TTL<=0 on the keepalive stream) or the stream dies."""

    def __init__(self, client: EtcdCompatClient, lease_id: int, ttl: int,
                 interval: float, ready_timeout: float):
        self.id = lease_id
        self.ttl = ttl
        self._interval = interval
        self._stop = threading.Event()
        self._expired = threading.Event()
        self._requests: queue.Queue = queue.Queue()
        self._responses = client._lease_keepalive(iter(self._requests.get, None))
        self._client = client
        self._rpc_error = grpc.RpcError  # closure-bound, survives teardown

        # first ping under the watchdog: prove the stream is live before
        # handing back a handle the caller will trust for TTL seconds
        fired = [False]
        done = [False]
        lock = threading.Lock()

        def _ack_watchdog():
            import faulthandler
            import sys

            with lock:
                if done[0]:
                    return
                fired[0] = True
            sys.__stderr__.write(
                f"[client.lease] no keepalive ack within {ready_timeout}s; "
                "dumping all thread stacks and cancelling the stream\n")
            faulthandler.dump_traceback(file=sys.__stderr__)
            sys.__stderr__.flush()
            self._responses.cancel()

        watchdog = threading.Timer(ready_timeout, _ack_watchdog)
        watchdog.daemon = True
        watchdog.start()
        try:
            self._ping()
        except (self._rpc_error, StopIteration) as e:
            raise TimeoutError(
                f"lease keepalive stream not acked by server: {e}") from e
        finally:
            with lock:
                done[0] = True
            watchdog.cancel()
        if fired[0]:
            raise TimeoutError(
                "lease keepalive stream cancelled by the registration watchdog")

        self._thread = threading.Thread(
            target=self._keepalive_loop, name="kb-lease-keepalive", daemon=True)
        self._thread.start()

    def _ping(self) -> int:
        self._requests.put(rpc_pb2.LeaseKeepAliveRequest(ID=self.id))
        resp = next(self._responses)
        if resp.TTL <= 0:
            self._expired.set()
        return resp.TTL

    def _keepalive_loop(self) -> None:
        import random

        while not self._stop.wait(self._interval * random.uniform(0.8, 1.2)):
            try:
                if self._ping() <= 0:
                    return  # lease gone server-side; don't spin on a corpse
            except (self._rpc_error, StopIteration):
                if not self._stop.is_set():
                    self._expired.set()
                return

    @property
    def alive(self) -> bool:
        return not self._expired.is_set()

    def revoke(self) -> None:
        """Stop keepalives and revoke: attached keys are deleted now."""
        self.close()
        self._client.lease_revoke(self.id)

    def close(self) -> None:
        """Stop keepalives; the lease then expires naturally server-side."""
        self._stop.set()
        self._requests.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


class MuxWatch:
    """One multiplexed watch (see :class:`WatchMux`): the server-assigned
    watch id plus reader-thread-maintained delivery counters. With resume
    armed, ``resumes`` counts server-side stream resets this watch
    survived (re-registered from last-delivered revision + 1);
    ``cancelled`` then only flips on TERMINAL cancels (compaction — the
    client must re-list)."""

    __slots__ = ("key", "range_end", "start_revision", "watch_id", "events",
                 "cancelled", "last_revision", "ready", "resumes",
                 "revisions", "baselined", "stream", "prev_kv", "sink")

    def __init__(self, key: bytes, range_end: bytes, start_revision: int = 0,
                 record: bool = False, prev_kv: bool = False, sink=None):
        self.key = key
        self.range_end = range_end
        self.start_revision = start_revision
        self.watch_id = -1
        self.events = 0
        self.cancelled = False
        self.last_revision = 0
        self.baselined = False  # watermark anchored at the created ack
        self.ready = threading.Event()
        self.resumes = 0
        self.revisions: list[int] | None = [] if record else None
        #: the stream currently carrying this watch — revive uses it to
        #: decide ownership, so one watch can never be re-registered on
        #: two live streams (set by _send_create)
        self.stream: object | None = None
        #: request prev_kv on (re-)registration (replication needs delete
        #: fidelity for the follower's own watchers)
        self.prev_kv = prev_kv
        #: optional delivery callback ``sink(events, header_revision)``,
        #: invoked on the reader thread IN ORDER — event batches with the
        #: wire events, progress marks with an empty tuple. The follower
        #: replication stream is the consumer (docs/replication.md).
        self.sink = sink

    def resume_revision(self) -> int:
        """Where a re-registration must start so no event is lost or
        duplicated: one past the delivery watermark (last delivered batch,
        or the registration revision the created ack baselined), or the
        original start when neither exists yet."""
        if self.last_revision or self.baselined:
            return self.last_revision + 1
        return self.start_revision


class _WatchMuxStream:
    """One Watch stream carrying many watches. The server's read loop
    handles create requests strictly in order, so created acks match the
    pending-add FIFO; event batches demux by ``watch_id``."""

    def __init__(self, client: "EtcdCompatClient", mux: "WatchMux | None" = None):
        self._requests: queue.Queue = queue.Queue()
        self._responses = client._watch(iter(self._requests.get, None))
        self._lock = threading.Lock()
        self._pending: collections.deque[MuxWatch] = collections.deque()
        self._by_id: dict[int, MuxWatch] = {}
        self._mux = mux
        self.dead = False
        self.closing = False
        self._reader = threading.Thread(
            target=self._read_loop, name="kb-watchmux", daemon=True)
        self._reader.start()

    def _send_create(self, w: MuxWatch, start_revision: int) -> None:
        """Append + send under one lock: concurrent adds must hit the wire
        in pending-FIFO order or created acks mismatch. Raises if the
        stream is already dead."""
        req = rpc_pb2.WatchRequest()
        req.create_request.key = w.key
        req.create_request.range_end = w.range_end
        req.create_request.start_revision = start_revision
        req.create_request.prev_kv = w.prev_kv
        with self._lock:
            if self.dead:
                raise TimeoutError("watch mux stream is dead")
            w.stream = self
            self._pending.append(w)
            self._requests.put(req)

    def request_progress(self) -> None:
        """Ask the server for ordered per-watch progress marks (bare
        headers carrying the fully-flushed floor, delivered through each
        watch's own queue so they cannot overtake owed events)."""
        req = rpc_pb2.WatchRequest()
        req.progress_request.SetInParent()
        with self._lock:
            if self.dead:
                return
            self._requests.put(req)

    def add(self, key: bytes, range_end: bytes, start_revision: int,
            timeout: float, record: bool = False, prev_kv: bool = False,
            sink=None) -> MuxWatch:
        w = MuxWatch(key, range_end, start_revision, record=record,
                     prev_kv=prev_kv, sink=sink)
        self._send_create(w, start_revision)
        if not w.ready.wait(timeout):
            raise TimeoutError(
                f"watch registration not acked within {timeout}s "
                f"(key={key!r})")
        return w

    def readd(self, w: MuxWatch) -> None:
        """Resume re-registration (no ready wait — called from reader/
        revive threads; the ack arrives on this stream's read loop)."""
        w.ready.clear()
        self._send_create(w, w.resume_revision())

    def _read_loop(self) -> None:
        rpc_error = grpc.RpcError  # closure-bound, survives teardown
        try:
            for resp in self._responses:
                if resp.created:
                    with self._lock:
                        w = self._pending.popleft() if self._pending else None
                    if w is not None:
                        w.watch_id = resp.watch_id
                        if (w.last_revision == 0 and w.start_revision == 0
                                and not w.baselined):
                            # live-only watch ("from now"): baseline the
                            # resume watermark at the registration
                            # revision the server acked, so a reset
                            # BEFORE the first delivery replays exactly
                            # the events committed since registration
                            w.last_revision = resp.header.revision
                            w.baselined = True
                        with self._lock:
                            self._by_id[resp.watch_id] = w
                        if resp.canceled:  # e.g. compacted start revision
                            w.cancelled = True
                        w.ready.set()
                if resp.events:
                    with self._lock:
                        w = self._by_id.get(resp.watch_id)
                    if w is not None:
                        # sink BEFORE advancing the resume watermark: a
                        # consumer crash mid-apply must re-receive this
                        # batch after the revive, never skip it
                        if w.sink is not None:
                            w.sink(list(resp.events), resp.header.revision)
                        w.events += len(resp.events)
                        w.last_revision = resp.header.revision
                        if w.revisions is not None:
                            w.revisions.extend(
                                ev.kv.mod_revision for ev in resp.events)
                elif not resp.created and not resp.canceled:
                    # bare header on a registered watch id = ordered
                    # progress mark: everything <= header.revision was
                    # already delivered on this stream, so the resume
                    # watermark may advance across the leader's revision
                    # gaps (watch_id -1 stream-level headers miss the map
                    # and are ignored)
                    with self._lock:
                        w = self._by_id.get(resp.watch_id)
                    if w is not None and resp.header.revision > w.last_revision:
                        if w.sink is not None:
                            w.sink((), resp.header.revision)
                        w.last_revision = resp.header.revision
                if resp.canceled and not resp.created:
                    with self._lock:
                        w = self._by_id.pop(resp.watch_id, None)
                    if w is None:
                        continue
                    mux = self._mux
                    if (mux is not None and mux.resume
                            and resp.compact_revision == 0):
                        # server-side stream reset (watcher dropped /
                        # fault-injected): re-register from the last
                        # delivered revision + 1 — the watch cache replays
                        # the gap, so no event is lost or duplicated
                        w.resumes += 1
                        try:
                            self.readd(w)
                        except TimeoutError:
                            w.cancelled = True
                            w.ready.set()
                    else:
                        # terminal: compacted history (client must
                        # re-list) or resume not armed
                        w.cancelled = True
        except (rpc_error, ValueError):
            pass  # stream torn down (close() or channel death)
        finally:
            with self._lock:
                self.dead = True
                stranded = list(self._pending) + list(self._by_id.values())
                self._pending.clear()
                self._by_id.clear()
                closing = self.closing
            mux = self._mux
            if mux is not None and mux.resume and not closing and stranded:
                # whole-stream death: revive on a fresh stream (off this
                # thread — the revive needs a new gRPC stream + re-adds)
                threading.Thread(
                    target=mux._revive, args=(self, stranded),
                    name="kb-watchmux-revive", daemon=True).start()
            else:
                for w in stranded:
                    w.cancelled = True
                    w.ready.set()

    def close(self) -> None:
        with self._lock:
            self.closing = True
        self._requests.put(None)


class WatchMux:
    """Many long-lived watches multiplexed over a few Watch streams.

    A :meth:`EtcdCompatClient.watch` session costs one client thread AND
    one server worker thread per watch — at informer scale (one watcher
    per controller) that is thousands of threads on each side. The mux
    rides the etcd protocol's native multiplexing instead: each stream
    carries any number of watches, so N watchers cost ``streams`` threads
    total. Deliveries are *counted* per watch (the workload harness's
    need), not queued — wire-lag attribution lives in the server's
    ``kb_watch_lag_seconds`` metric.

    ``resume=True`` arms chaos-grade robustness (docs/faults.md): a
    server-side stream reset (slow-consumer drop, fault injection) or a
    whole-stream death re-registers every surviving watch from its
    last-delivered revision + 1 — the server's watch cache replays the
    gap, so the delivered event sequence has no loss and no duplicates;
    only a compacted start revision is terminal (the client must
    re-list)."""

    def __init__(self, client: "EtcdCompatClient", streams: int = 4,
                 resume: bool = False, record_revisions: bool = False):
        if streams < 1:
            raise ValueError("streams must be >= 1")
        self._client = client
        self.resume = resume
        self._record = record_revisions
        self._streams = [_WatchMuxStream(client, mux=self)
                         for _ in range(streams)]
        self._revive_lock = threading.Lock()
        self._all: list[MuxWatch] = []
        self._all_lock = threading.Lock()
        self._closed = False
        self._rr = 0

    def add(self, key: bytes, range_end: bytes = b"", start_revision: int = 0,
            shard: int | None = None, timeout: float = 30.0,
            prev_kv: bool = False, sink=None) -> MuxWatch:
        if shard is None:
            shard, self._rr = self._rr, self._rr + 1
        s = self._streams[shard % len(self._streams)]
        w = s.add(key, range_end, start_revision, timeout,
                  record=self._record, prev_kv=prev_kv, sink=sink)
        with self._all_lock:
            self._all.append(w)
        return w

    def request_progress(self) -> None:
        """Ordered per-watch progress marks from every live stream (the
        replication stream's watermark-advance tick)."""
        for s in self._streams:
            if not s.dead:
                s.request_progress()

    def _revive(self, dead_stream: "_WatchMuxStream",
                stranded: list[MuxWatch]) -> None:
        """Replace a dead stream and re-register its watches from their
        resume revisions. Idempotent under partial failure: revives
        serialize on ``_revive_lock``, each watch is re-added only while
        it still BELONGS to the dead stream (``w.stream``), and a
        replacement that dies mid-revive hands its already-moved watches
        to its own revive — one watch can never be live on two streams.
        Bounded attempts with jittered backoff; watches the server never
        takes back get terminal cancels."""
        import random

        backoff = 0.1
        for _attempt in range(6):
            if self._closed:
                break
            todo = [w for w in stranded
                    if not w.cancelled and w.stream is dead_stream]
            if not todo:
                return  # every watch moved on (or terminally ended)
            # the lock covers ONLY the slot lookup/swap (never the backoff
            # sleeps below — kblint KB118/KB102); double-add safety comes
            # from the per-watch ownership gate (w.stream), not from
            # serializing whole revives
            target = None
            with self._revive_lock:
                try:
                    slot = self._streams.index(dead_stream)
                except ValueError:
                    slot = None  # replaced by an earlier attempt/revive
                if slot is not None:
                    try:
                        target = _WatchMuxStream(self._client, mux=self)
                        # install BEFORE re-adding: add() must never
                        # route to a stream this revive knows is gone
                        self._streams[slot] = target
                    except (grpc.RpcError, ValueError):
                        target = None
                else:
                    # a newer revive owns the slot: adopt a live stream
                    # from the rotation instead of minting an untracked
                    # (unclosable) one. A dead adoptee in the slot heals
                    # via its OWN revive.
                    target = next(
                        (s for s in self._streams if not s.dead), None)
            if target is not None:
                try:
                    for w in todo:
                        w.resumes += 1
                        target.readd(w)  # moves w.stream to target
                    return
                except (grpc.RpcError, TimeoutError, ValueError):
                    pass  # target died mid-re-add: watches already moved
                    # ride its own revive; the rest retry here
            time.sleep(backoff * random.uniform(0.5, 1.5))
            backoff = min(backoff * 2.0, 2.0)
        for w in stranded:
            if not w.cancelled and w.stream is dead_stream:
                w.cancelled = True
                w.ready.set()

    def watchers(self) -> list[MuxWatch]:
        with self._all_lock:
            return list(self._all)

    def total_events(self) -> int:
        return sum(w.events for w in self.watchers())

    def cancelled_count(self) -> int:
        return sum(1 for w in self.watchers() if w.cancelled)

    def resumed_total(self) -> int:
        return sum(w.resumes for w in self.watchers())

    def close(self) -> None:
        self._closed = True
        for s in self._streams:
            s.close()


class _KeepaliveMuxStream:
    """One LeaseKeepAlive stream multiplexing pings for many lease ids.
    The server answers requests in order, so ack matching is the send
    FIFO; each ack invokes the caller's callback with (latency_s, ttl)."""

    def __init__(self, client: "EtcdCompatClient"):
        self._requests: queue.Queue = queue.Queue()
        self._responses = client._lease_keepalive(iter(self._requests.get, None))
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._idle = threading.Condition(self._lock)
        self.sent = 0
        self.acked = 0
        self.expired_acks = 0
        self.dead = False
        self._reader = threading.Thread(
            target=self._read_loop, name="kb-leasemux", daemon=True)
        self._reader.start()

    def send(self, lease_id: int,
             on_ack: Callable[[float, int], None] | None = None) -> bool:
        with self._lock:
            if self.dead:
                return False
            # append + send under one lock (ack matching is the send FIFO)
            self._pending.append((time.monotonic(), on_ack))
            self.sent += 1
            self._requests.put(rpc_pb2.LeaseKeepAliveRequest(ID=lease_id))
        return True

    def _read_loop(self) -> None:
        rpc_error = grpc.RpcError
        try:
            for resp in self._responses:
                with self._lock:
                    t0, on_ack = (self._pending.popleft()
                                  if self._pending else (None, None))
                    self.acked += 1
                    if resp.TTL <= 0:
                        self.expired_acks += 1
                    self._idle.notify_all()
                if on_ack is not None and t0 is not None:
                    on_ack(time.monotonic() - t0, resp.TTL)
        except (rpc_error, ValueError):
            pass
        finally:
            with self._lock:
                self.dead = True
                self._idle.notify_all()

    def flush(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._lock:
            while self.acked < self.sent and not self.dead:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return self.acked >= self.sent

    def close(self) -> None:
        self._requests.put(None)


class LeaseMux:
    """Node-scale lease fan-out: pipelined grants plus keepalives for many
    lease ids multiplexed over a few LeaseKeepAlive streams (one
    :class:`LeaseHandle` per lease would cost a thread and a stream per
    node). Keepalives are fire-and-forget from the caller's perspective;
    acks are counted (and optionally called back) on the reader threads,
    and :meth:`flush` fences them all."""

    def __init__(self, client: "EtcdCompatClient", streams: int = 4):
        if streams < 1:
            raise ValueError("streams must be >= 1")
        self._client = client
        self._streams = [_KeepaliveMuxStream(client) for _ in range(streams)]

    def grant_bulk(self, n: int, ttl: int, window: int = 64) -> list[int]:
        """Grant ``n`` leases with pipelined LeaseGrant futures; returns
        the server-assigned ids in order."""
        ids: list[int] = []
        pending: collections.deque = collections.deque()
        for _ in range(n):
            if len(pending) >= window:
                ids.append(pending.popleft().result().ID)
            pending.append(self._client._lease_grant.future(
                rpc_pb2.LeaseGrantRequest(TTL=ttl)))
        while pending:
            ids.append(pending.popleft().result().ID)
        return ids

    def keepalive_async(self, lease_id: int, shard: int = 0,
                        on_ack: Callable[[float, int], None] | None = None) -> bool:
        return self._streams[shard % len(self._streams)].send(lease_id, on_ack)

    @property
    def sent(self) -> int:
        return sum(s.sent for s in self._streams)

    @property
    def acked(self) -> int:
        return sum(s.acked for s in self._streams)

    @property
    def expired_acks(self) -> int:
        return sum(s.expired_acks for s in self._streams)

    def flush(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        return all(s.flush(max(0.001, deadline - time.monotonic()))
                   for s in self._streams)

    def close(self) -> None:
        for s in self._streams:
            s.close()


class BrainClient:
    """Native protocol client (leaner than the etcd shim: explicit
    revisions, no txn encoding)."""

    def __init__(self, target: str, credentials: grpc.ChannelCredentials | None = None):
        self.channel = (
            grpc.secure_channel(target, credentials)
            if credentials
            else grpc.insecure_channel(target)
        )
        p = brain_pb2

        def u(name, req, resp):
            return _traced_call(self.channel.unary_unary(
                f"/brainpb.Brain/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ))

        def us(name, req, resp):
            return _traced_call(self.channel.unary_stream(
                f"/brainpb.Brain/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ))

        self._create = u("Create", p.CreateRequest, p.CreateResponse)
        self._update = u("Update", p.UpdateRequest, p.UpdateResponse)
        self._delete = u("Delete", p.BrainDeleteRequest, p.BrainDeleteResponse)
        self._compact = u("Compact", p.BrainCompactRequest, p.BrainCompactResponse)
        self._get = u("Get", p.GetRequest, p.GetResponse)
        self._range = u("Range", p.BrainRangeRequest, p.BrainRangeResponse)
        self._range_stream = us("RangeStream", p.BrainRangeRequest, p.BrainRangeResponse)
        self._count = u("Count", p.CountRequest, p.CountResponse)
        self._list_partition = u("ListPartition", p.ListPartitionRequest, p.ListPartitionResponse)
        self._watch = us("Watch", p.BrainWatchRequest, p.BrainWatchResponse)

    def create(self, key: bytes, value: bytes):
        r = self._create(brain_pb2.CreateRequest(key=key, value=value))
        return r.succeeded, r.revision

    def update(self, key: bytes, value: bytes, expected_revision: int):
        r = self._update(brain_pb2.UpdateRequest(
            key=key, value=value, expected_revision=expected_revision
        ))
        return r.succeeded, r.revision

    def delete(self, key: bytes, expected_revision: int = 0):
        r = self._delete(brain_pb2.BrainDeleteRequest(
            key=key, expected_revision=expected_revision
        ))
        return r.succeeded, r.revision

    def compact(self, revision: int) -> int:
        return self._compact(brain_pb2.BrainCompactRequest(revision=revision)).compacted_revision

    def get(self, key: bytes, revision: int = 0) -> ClientKV | None:
        r = self._get(brain_pb2.GetRequest(key=key, revision=revision))
        if not r.HasField("kv"):
            return None
        return ClientKV(r.kv.key, r.kv.value, r.kv.revision)

    def range(self, start: bytes, end: bytes, revision: int = 0, limit: int = 0):
        r = self._range(brain_pb2.BrainRangeRequest(
            start=start, end=end, revision=revision, limit=limit
        ))
        return [ClientKV(kv.key, kv.value, kv.revision) for kv in r.kvs], r.more

    def range_stream(self, start: bytes, end: bytes, revision: int = 0):
        for resp in self._range_stream(brain_pb2.BrainRangeRequest(
            start=start, end=end, revision=revision
        )):
            for kv in resp.kvs:
                yield ClientKV(kv.key, kv.value, kv.revision)

    def count(self, start: bytes, end: bytes) -> int:
        return self._count(brain_pb2.CountRequest(start=start, end=end)).count

    def list_partition(self, start: bytes, end: bytes) -> list[bytes]:
        return list(self._list_partition(
            brain_pb2.ListPartitionRequest(start=start, end=end)
        ).borders)

    def watch(self, prefix: bytes, start_revision: int = 0):
        for resp in self._watch(brain_pb2.BrainWatchRequest(
            prefix=prefix, start_revision=start_revision
        )):
            if resp.expired:
                raise RuntimeError("watch expired; re-list required")
            for ev in resp.events:
                yield ev

    def close(self) -> None:
        self.channel.close()
