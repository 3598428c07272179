"""FollowerRole: per-RPC routing policy + the revision fence.

One object answers every "may this follower serve this request, and how"
question (docs/replication.md):

- :meth:`gate_read` admits/blocks/refuses a Range/Count before it enters
  the scheduler lanes (local serving then rides the SAME lanes/batching
  as on the leader — the gate only decides consistency, never executes);
- :meth:`forward_txn` / :meth:`forward_unary` / :meth:`forward_keepalive`
  proxy the leader-only surfaces over a raw gRPC channel with status
  passthrough — an ambiguous forward outcome (DEADLINE/CANCELLED/bare
  UNAVAILABLE from the leader) reaches the client unchanged, so the
  safe-vs-ambiguous retry discipline (docs/faults.md) survives the hop;
- the role also implements the PeerService contract (``is_leader`` False,
  no-op ``sync_read_revision``) so every existing service keeps working
  unmodified: the brain front refuses writes, the watch service serves
  locally, the lease reaper never arms.

The fence (linearizable reads): fetch the leader's committed revision
(``/status`` over HTTP, singleflighted so a read burst costs one round
trip), wait until the local applied watermark reaches it (the TSO's
``wait_committed`` — the applier commits the watermark there), then serve
locally. A fence that cannot complete inside ``fence_timeout_s`` REFUSES
(``etcdserver: replica fence timeout``) — never a silently stale answer.

The staleness clock (serializable reads): a leader head fetched at an
instant bounds every revision committed before it, so once the watermark
covers that head, the follower is at most as stale as the instant is old.
Every fetch counts (the fence's, and one a progress tick,
:meth:`FollowerRole.sample_leader_head`), and the clock runs from the
newest covered one. The JAX role runs it only from the last instant the
watermark covered the highest head it had heard of, which under steady
writes and fences refuses reads while the follower is well inside the
bound.

Counterpart of ``kubebrain_tpu/replica/role.py``. ``grpc`` and the
generated protos are imported inside the forwarding paths only
(:meth:`FollowerRole._leader_channel_locked`, ``_stub``,
:meth:`~FollowerRole.forward_unary`, :meth:`~FollowerRole.forward_keepalive`),
so the role, its fence and its read gate load where neither is installed;
the fence's transport is ``HttpRevisionSyncer``, which uses ``urllib``.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any

from ..server.service.revision import HttpRevisionSyncer

#: how long an explicit-revision read slightly ahead of the watermark may
#: wait for replication to catch up before refusing as a future revision
FUTURE_WAIT_CAP_S = 1.0
#: fetched leader heads kept until the watermark covers them; past this
#: the oldest are dropped, which only makes the staleness clock slower
HEAD_SAMPLES = 4096


class ReplicaRefusedError(Exception):
    """A follower refusing to serve (never a wrong answer). ``reason`` is
    the kb_replica_refused_total label; transports map subclasses to the
    etcd statuses clients classify as safe-to-retry."""

    reason = "refused"


class StaleReplicaError(ReplicaRefusedError):
    """Bounded-staleness bound exceeded: refusal instead of a stale answer."""

    reason = "stale"


class FenceTimeoutError(ReplicaRefusedError):
    """The applied watermark did not reach the fence revision in time."""

    reason = "fence_timeout"


class LeaderUnreachableError(ReplicaRefusedError):
    """The leader could not be asked for the fence revision / a forward."""

    reason = "leader_unreachable"


class FutureRevisionWaitError(ReplicaRefusedError):
    """Explicit read revision still ahead of the watermark after waiting."""

    reason = "future_revision"


@dataclass(frozen=True)
class FollowerConfig:
    leader_address: str                 # leader client (gRPC) host:port
    leader_info: str                    # leader info/peer (HTTP) host:port
    max_staleness_rev: int = 0          # 0 = unbounded
    max_staleness_ms: float = 5000.0    # 0 = unbounded
    fence_timeout_s: float = 3.0
    progress_interval_s: float = 0.2    # replication progress-request cadence
    compact_sync_interval_s: float = 5.0
    #: gRPC channel credentials for the leader connection (forwarding +
    #: the replication stream) — a TLS-serving leader needs them; cli
    #: builds them from --ca-file (the /status fence fetch auto-probes
    #: http/https on its own)
    credentials: object = None


class FollowerRole:
    """The follower's routing/consistency brain. Also implements the
    PeerService surface so it can be passed wherever ``peers`` goes."""

    def __init__(self, backend: Any, config: FollowerConfig,
                 metrics: Any = None, fault_plane: Any = None,
                 identity: str = "follower") -> None:
        self.backend = backend
        self.config = config
        self.identity = identity
        self._metrics = metrics
        self._plane = fault_plane
        self._lock = threading.Lock()
        #: highest leader committed revision this follower has observed
        #: (events, progress notifications, fence fetches)
        self._leader_rev = 0
        #: monotonic instant the watermark last provably covered the then-
        #: known leader head — the zero point of the time-staleness bound
        self._fresh_t: float | None = None
        #: (fetch start, leader head) of fetches the watermark has not
        #: covered yet, oldest first: the head bounds every revision
        #: committed before the fetch started
        self._heads: deque[tuple[float, int]] = deque(maxlen=HEAD_SAMPLES)
        self._sample_after = 0.0  # no head sample before this instant
        self.served: Counter = Counter()
        self.forwarded: Counter = Counter()
        self.refused: Counter = Counter()
        # leader-revision fetch: the raw /status transport comes from the
        # reference's revision syncer, but fences must NOT ride its plain
        # singleflight — joining an already-in-flight fetch could hand a
        # fence a revision sampled BEFORE the read began (a real-time
        # linearizability hole). _fresh_leader_revision below runs a
        # TICKETED singleflight instead: a fence only accepts a fetch
        # that STARTED after it arrived (etcd's ReadIndex batching
        # discipline). The WATERMARK stays owned by the replication
        # applier — an HTTP poll proves nothing about applied events.
        self._syncer = HttpRevisionSyncer(
            lambda: config.leader_info, self._note_leader_rev)
        self._fl_cv = threading.Condition()
        self._fl_done = 0        # completed fetch generations
        self._fl_inflight = False
        self._fl_result: tuple[int | None, str | None] = (None, None)
        self._channel = None  # grpc.Channel to the leader, on first forward
        self._stubs: dict[str, object] = {}
        self._stream = None  # ReplicationStream, attached by start()
        if metrics is not None:
            metrics.register_gauge_fn(
                "kb.replica.applied.revision",
                lambda: float(self.applied_revision()))
            metrics.register_gauge_fn(
                "kb.replica.lag.revisions",
                lambda: float(self.lag_revisions()))
            metrics.register_gauge_fn(
                "kb.replica.lag.seconds", lambda: self.lag_seconds())

    # ------------------------------------------------------------ watermark
    def applied_revision(self) -> int:
        """The applied watermark: every leader event with revision <= this
        has been applied to the local store (the applier commits it into
        the local TSO, so rev-0 local reads resolve here too)."""
        return self.backend.tso.committed()

    def lag_revisions(self) -> int:
        with self._lock:
            leader = self._leader_rev
        return max(0, leader - self.applied_revision())

    def lag_seconds(self) -> float:
        """Seconds since the watermark last provably covered the leader
        head: since the start of the newest leader-head fetch it covers,
        or since it covered the highest head heard of. Infinity before
        the first sync (never served stale-blind)."""
        applied = self.applied_revision()
        with self._lock:
            while self._heads and self._heads[0][1] <= applied:
                t, _rev = self._heads.popleft()
                if self._fresh_t is None or t > self._fresh_t:
                    self._fresh_t = t
            fresh = self._fresh_t
        if fresh is None:
            return float("inf")
        return time.monotonic() - fresh

    def _note_leader_rev(self, revision: int,
                         fetched_at: float | None = None) -> None:
        """A leader revision heard of; ``fetched_at``: the monotonic
        instant its fetch started, for the staleness clock."""
        with self._lock:
            if revision > self._leader_rev:
                self._leader_rev = revision
            if fetched_at is not None:
                self._heads.append((fetched_at, revision))

    def sample_leader_head(self) -> None:
        """One leader-head fetch for the staleness clock, best effort:
        the replication stream takes one each progress tick. A failed
        fetch pauses the samples for ``compact_sync_interval_s``, so that
        an unreachable leader does not stretch every tick to the fetch's
        timeout."""
        t0 = time.monotonic()
        if t0 < self._sample_after or (
                self._plane is not None and self._plane.leader_unreachable()):
            return
        try:
            rev = self._syncer._fetch()
        except Exception:
            self._sample_after = (time.monotonic()
                                  + self.config.compact_sync_interval_s)
            return
        self._note_leader_rev(int(rev or 0), t0)

    def note_applied(self, watermark: int, leader_head: int) -> None:
        """Applier callback after a replicated block (or progress mark) is
        applied: ``watermark`` is the new applied revision, ``leader_head``
        the leader revision the stream vouched for at that instant."""
        now = time.monotonic()
        with self._lock:
            if leader_head > self._leader_rev:
                self._leader_rev = leader_head
            if watermark >= self._leader_rev:
                self._fresh_t = now

    # ----------------------------------------------------------- the fence
    def leader_revision(self, timeout: float | None = None) -> int:
        """The leader's committed revision, sampled by a fetch that
        STARTED after this call (ticketed singleflight): any fetch
        already in flight began before us, so its answer could predate a
        write this read must observe — concurrent fences share the NEXT
        fetch instead. Raises LeaderUnreachableError."""
        if self._plane is not None and self._plane.leader_unreachable():
            raise LeaderUnreachableError(
                "leader unreachable (fault injection)")
        wait_s = timeout if timeout is not None \
            else self.config.fence_timeout_s
        deadline = time.monotonic() + wait_s
        with self._fl_cv:
            # an in-flight fetch began before us: its answer is tainted
            # for a fence; the next generation is the first sound one.
            # A whole read burst shares that one next fetch (generation
            # singleflight) — at most two round trips ever queue.
            # Production is claimed INSIDE the wait loop (first waiter to
            # observe the slot free takes it), never pre-committed: a
            # pre-committed claimant that times out would leave a
            # generation nobody produces and wedge every later fence.
            need = self._fl_done + (2 if self._fl_inflight else 1)
            while True:
                if self._fl_done >= need:
                    rev, err = self._fl_result
                    if err is not None:
                        raise LeaderUnreachableError(err)
                    return int(rev or 0)
                if not self._fl_inflight and self._fl_done == need - 1:
                    self._fl_inflight = True
                    break  # we produce generation `need`
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._fl_cv.wait(remaining):
                    raise LeaderUnreachableError(
                        "leader /status fetch timed out")
        rev_val: int | None = None
        err_str: str | None = None
        fetched_at = time.monotonic()
        try:
            rev_val = self._syncer._fetch()
        except Exception as e:
            err_str = str(e)
        with self._fl_cv:
            self._fl_inflight = False
            self._fl_done = need
            self._fl_result = (rev_val, err_str)
            self._fl_cv.notify_all()
        if err_str is not None:
            raise LeaderUnreachableError(err_str)
        self._note_leader_rev(int(rev_val or 0), fetched_at)
        return int(rev_val or 0)

    def fence(self) -> int:
        """Linearizable-read fence: leader committed revision R, then wait
        until the applied watermark reaches R. Returns R. The wait rides
        the TSO's committed condition — the applier's ``tso.commit`` is
        the wake-up."""
        t0 = time.monotonic()
        # ONE deadline for the whole fence (leader fetch + watermark
        # wait): --fence-timeout-ms bounds the read's total block time,
        # not each of its phases separately
        deadline = t0 + self.config.fence_timeout_s
        try:
            if self._plane is not None and self._plane.fence_timeout():
                # injected stale-follower: the fence must REFUSE, proving
                # the degradation is a refusal, not a stale answer
                raise FenceTimeoutError("fence timeout (fault injection)")
            target = self.leader_revision(
                timeout=max(0.001, deadline - time.monotonic()))
            if not self.backend.tso.wait_committed(
                    target, timeout=max(0.001, deadline - time.monotonic())):
                raise FenceTimeoutError(
                    f"applied {self.applied_revision()} never reached fence "
                    f"{target} within {self.config.fence_timeout_s}s")
            return target
        finally:
            if self._metrics is not None:
                self._metrics.emit_histogram(
                    "kb.fence.wait.seconds", time.monotonic() - t0)

    # ------------------------------------------------------------- serving
    def gate_read(self, revision: int, serializable: bool) -> None:
        """Admit a Range/Count for local serving (docs/replication.md):

        - explicit revision <= watermark: serve (below the local compact
          floor the backend's own CompactedError refusal applies);
        - explicit revision ahead of the watermark: bounded wait for
          replication, then refuse as a future revision;
        - rev-0 serializable: staleness gate — refuse past the bound;
        - rev-0 linearizable: the revision fence.

        Raises a ReplicaRefusedError subclass; on return the caller serves
        locally through the normal scheduler lanes.
        """
        if revision:
            if revision <= self.applied_revision():
                return
            wait = min(FUTURE_WAIT_CAP_S, self.config.fence_timeout_s)
            if self.backend.tso.wait_committed(revision, timeout=wait):
                return
            self._refuse(FutureRevisionWaitError(
                f"revision {revision} ahead of applied watermark "
                f"{self.applied_revision()}"))
        if serializable:
            self.check_staleness()
            return
        try:
            self.fence()
        except ReplicaRefusedError as e:
            self._refuse(e)

    def check_staleness(self) -> None:
        """The bounded-staleness gate for serializable reads: lag past
        either bound is a REFUSAL (clients fail over), never a stale
        answer."""
        cfg = self.config
        if cfg.max_staleness_ms:
            lag_ms = self.lag_seconds() * 1000.0
            if lag_ms > cfg.max_staleness_ms:
                self._refuse(StaleReplicaError(
                    f"replica lag {lag_ms:.0f}ms > max-staleness-ms "
                    f"{cfg.max_staleness_ms:.0f}"))
        if cfg.max_staleness_rev:
            lag = self.lag_revisions()
            if lag > cfg.max_staleness_rev:
                self._refuse(StaleReplicaError(
                    f"replica lag {lag} revisions > max-staleness-rev "
                    f"{cfg.max_staleness_rev}"))

    def _refuse(self, err: ReplicaRefusedError) -> None:
        self.refused[err.reason] += 1
        if self._metrics is not None:
            self._metrics.emit_counter(
                "kb.replica.refused", 1, reason=err.reason)
        raise err

    def note_served(self, rpc: str) -> None:
        self.served[rpc] += 1
        if self._metrics is not None:
            self._metrics.emit_counter("kb.replica.served", 1, rpc=rpc)

    def _note_forwarded(self, rpc: str) -> None:
        self.forwarded[rpc] += 1
        if self._metrics is not None:
            self._metrics.emit_counter("kb.replica.forwarded", 1, rpc=rpc)

    # ---------------------------------------------------------- forwarding
    #: forwarded unary RPCs: name -> (method path, request and response
    #: message names in ``rpc_pb2``)
    _METHODS = {
        "txn": ("/etcdserverpb.KV/Txn", "TxnRequest", "TxnResponse"),
        "compact": ("/etcdserverpb.KV/Compact",
                    "CompactionRequest", "CompactionResponse"),
        "lease_grant": ("/etcdserverpb.Lease/LeaseGrant",
                        "LeaseGrantRequest", "LeaseGrantResponse"),
        "lease_revoke": ("/etcdserverpb.Lease/LeaseRevoke",
                         "LeaseRevokeRequest", "LeaseRevokeResponse"),
        "lease_ttl": ("/etcdserverpb.Lease/LeaseTimeToLive",
                      "LeaseTimeToLiveRequest", "LeaseTimeToLiveResponse"),
        "lease_leases": ("/etcdserverpb.Lease/LeaseLeases",
                         "LeaseLeasesRequest", "LeaseLeasesResponse"),
    }
    FORWARD_TIMEOUT_S = 10.0

    def _leader_channel_locked(self) -> Any:
        import grpc

        if self._channel is None:
            creds = self.config.credentials
            self._channel = (
                grpc.secure_channel(self.config.leader_address, creds)
                if creds is not None
                else grpc.insecure_channel(self.config.leader_address))
        return self._channel

    def _stub(self, name: str) -> Any:
        with self._lock:
            self._leader_channel_locked()
            stub = self._stubs.get(name)
            if stub is None:
                from ..proto import rpc_pb2

                method, req, resp = self._METHODS[name]
                req, resp = getattr(rpc_pb2, req), getattr(rpc_pb2, resp)
                stub = self._channel.unary_unary(
                    method, request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString)
                self._stubs[name] = stub
            return stub

    def _gate_forward(self) -> None:
        """Injected leader-unreachable window: refuse BEFORE sending, so
        the refusal is provably not-applied (clients may safely retry /
        fail over — the consistency ledger counts it definite)."""
        if self._plane is not None and self._plane.leader_unreachable():
            self.refused[LeaderUnreachableError.reason] += 1
            if self._metrics is not None:
                self._metrics.emit_counter(
                    "kb.replica.refused", 1,
                    reason=LeaderUnreachableError.reason)
            raise LeaderUnreachableError(
                "leader unreachable (fault injection)")

    def forward_unary(self, name: str, request: Any, context: Any) -> Any:
        """Forward one unary RPC to the leader. gRPC failures re-abort with
        the LEADER'S status code + details verbatim: the client's
        safe-vs-ambiguous classification must see exactly what a direct
        call would have seen (a swallowed DEADLINE re-labelled "not
        leader" would launder an ambiguous write into a safe retry)."""
        import grpc

        try:
            self._gate_forward()
        except LeaderUnreachableError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"etcdserver: leader unreachable: {e}")
        self._note_forwarded(name)
        try:
            return self._stub(name)(request, timeout=self.FORWARD_TIMEOUT_S)
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            details = e.details() if hasattr(e, "details") else ""
            context.abort(code or grpc.StatusCode.UNAVAILABLE,
                          details or "forward to leader failed")

    def forward_keepalive(self, request_iterator, context):
        """Pipe a LeaseKeepAlive stream through the leader (the reference's
        etcd-proxy watch piping, applied to the keepalive stream)."""
        import grpc

        from ..proto import rpc_pb2

        try:
            self._gate_forward()
        except LeaderUnreachableError as e:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"etcdserver: leader unreachable: {e}")
        with self._lock:
            self._leader_channel_locked()
            stream = self._stubs.get("_keepalive_stream")
            if stream is None:
                stream = self._channel.stream_stream(
                    "/etcdserverpb.Lease/LeaseKeepAlive",
                    request_serializer=(
                        rpc_pb2.LeaseKeepAliveRequest.SerializeToString),
                    response_deserializer=(
                        rpc_pb2.LeaseKeepAliveResponse.FromString))
                self._stubs["_keepalive_stream"] = stream
        def counted(it):
            for req in it:
                self._note_forwarded("lease_keepalive")
                yield req
        try:
            yield from stream(counted(request_iterator))
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code == grpc.StatusCode.CANCELLED:
                return  # client went away; not an error
            details = e.details() if hasattr(e, "details") else ""
            context.abort(code or grpc.StatusCode.UNAVAILABLE,
                          details or "keepalive forward to leader failed")

    # --------------------------------------------------- PeerService shape
    def is_leader(self) -> bool:
        return False

    def campaign(self) -> None:
        pass  # followers never campaign: the role is explicit, not elected

    def sync_read_revision(self) -> None:
        # the replication stream owns the watermark; a per-read HTTP sync
        # (the legacy follower mode) would defeat local serving entirely
        pass

    def forward_txn(self, request):  # noqa: ARG002 — brain-front contract
        return None

    def forward_watch(self, request_iterator):  # noqa: ARG002
        return None  # watches are served from the LOCAL pipeline

    def leader_peer_address(self) -> str:
        return self.config.leader_info

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        from .stream import ReplicationStream

        if self._stream is None:
            self._stream = ReplicationStream(self, self.backend,
                                             plane=self._plane)
            self._stream.start()

    def status(self) -> dict:
        lag_s = self.lag_seconds()
        return {
            "role": "follower",
            "leader_address": self.config.leader_address,
            "applied_revision": self.applied_revision(),
            "leader_revision": self._leader_rev,
            "lag_revisions": self.lag_revisions(),
            "lag_seconds": None if lag_s == float("inf") else round(lag_s, 3),
            "served": dict(self.served),
            "forwarded": dict(self.forwarded),
            "refused": dict(self.refused),
            "stream": (self._stream.status() if self._stream is not None
                       else {"state": "not_started"}),
        }

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
                self._stubs.clear()
        if self._metrics is not None:
            # the lag/watermark gauges registered in __init__ close over
            # this role: leaving them registered keeps a closed follower
            # reachable from the metrics registry and scrapes stale lag
            self._metrics.unregister_gauge_fn("kb.replica.applied.revision")
            self._metrics.unregister_gauge_fn("kb.replica.lag.revisions")
            self._metrics.unregister_gauge_fn("kb.replica.lag.seconds")
