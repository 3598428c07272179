"""The MVCC backend core — revision allocation, conditional writes, snapshot
reads, compaction, and the single-sequencer event pipeline.

Reference: pkg/backend/backend.go (Backend iface :44-84, NewBackend :145,
collectStorageWriteEvents :208), txn.go, range.go, watch.go, compact.go.

Threading model (mirrors the reference's goroutines, backend.go:178-183):

- any number of writer threads: deal a revision, run the engine batch, then
  post exactly one WatchEvent into the revision-indexed ring
  (``_notify``; reference txn.go:267-293). Every dealt revision is notified —
  valid, failed, or uncertain — or the sequencer would stall;
- ONE sequencer thread consumes ring slots strictly in revision order
  (``_collect_events``): commits the revision to the TSO, routes uncertain
  results to the async retry queue, and appends valid events to the watch
  cache + fan-out hub in batches of <= EVENT_BATCH;
- the async retry daemon repairs uncertain writes (retry.py);
- watch fan-out happens inline in the sequencer via WatcherHub.stream.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

from .. import coder
from ..storage import CASFailedError, KvStorage, Partition, UncertainResultError
from ..storage.errors import KeyNotFoundError, RevisionDriftBackError
from ..trace import TRACER
from ..util.env import txn_log
from . import creator
from .common import (
    COMPACT_KEY,
    LAST_REV_KEY,
    TOMBSTONE,
    KeyValue,
    RangeResult,
    Verb,
    WatchEvent,
)
from .errors import (
    CASRevisionMismatchError,
    CompactedError,
    FutureRevisionError,
    KeyExistsError,
    WatchExpiredError,
)
from .retry import AsyncFifoRetry
from .ring import Ring
from .scanner import CompactHistory, Scanner
from .tso import TSO
from .watcherhub import WatcherHub

# Reference constants, backend.go:39-42
WATCH_CACHE_CAPACITY = 200_000
EVENT_RING_CAPACITY = 100_000
EVENT_BATCH = 300

#: resolutions of one head read that compactions keep passing before it fails
HEAD_READ_ATTEMPTS = 8


@dataclass
class BackendConfig:
    prefix: bytes = b"/"
    skip_prefixes: list[bytes] = field(default_factory=list)
    watch_cache_capacity: int = WATCH_CACHE_CAPACITY
    event_ring_capacity: int = EVENT_RING_CAPACITY
    enable_etcd_compatibility: bool = True  # gates Count (reference range.go:188)
    scanner_workers: int = 8
    fanout_matcher: object | None = None  # vectorized watch matcher (fanout/)


class Backend:
    def __init__(self, store: KvStorage, config: BackendConfig | None = None):
        self.config = config or BackendConfig()
        self.store = store
        self.tso = TSO()
        self.watch_cache = Ring(self.config.watch_cache_capacity)
        self.watcher_hub = WatcherHub(fanout_matcher=self.config.fanout_matcher)
        # block-batched fan-out: a matcher that matches a whole drain block
        # in one device dispatch makes EVENT_BATCH chunking pure overhead —
        # hand the hub the full contiguous block
        self._hub_blocks = self.watcher_hub.prefers_blocks
        self.retry = AsyncFifoRetry(self._read_rev_record, self._retry_rewrite)
        scanner_kw = dict(
            get_compact_revision=lambda _snap: self._compact_revision_cached(),
            retry_min_revision=self.retry.min_revision,
            compact_history=CompactHistory(),
            max_workers=self.config.scanner_workers,
        )
        # engines with their own scan offload (cuda) supply the scanner
        self.scanner = store.make_scanner(**scanner_kw) or Scanner(store, **scanner_kw)
        # single-FFI-call write/delete fast paths when the engine provides them
        self._mvcc_write = getattr(store, "mvcc_write", None)
        self._mvcc_delete = getattr(store, "mvcc_delete", None)
        # grouped-commit engine executor (one engine round trip for a whole
        # write group, per-op demux) — engines without it fall back per-op
        self._engine_write_batch = getattr(store, "write_batch", None)
        # compact watermark cache: -1 unknown; refreshed at most once per
        # COMPACT_CACHE_TTL so hot reads don't pay an engine round-trip
        # (local compactions update it synchronously; the TTL bounds follower
        # staleness against a remote leader's compaction)
        self._compact_rev_cache = -1
        self._compact_cache_time = 0.0
        self._compact_lock = threading.Lock()
        # guards ONLY the two cache fields above — never held across
        # engine work. The TTL getter must not take _compact_lock itself:
        # compact() holds that across its whole GC pass, and every
        # Range/Count consults the getter (a convoy exactly like an
        # _rr_lock held across a pool rebuild)
        self._compact_cache_lock = threading.Lock()

        # revision-indexed event ring (reference backend.go:111; txn.go:291)
        self._ring_cap = self.config.event_ring_capacity
        self._ring: list[WatchEvent | None] = [None] * self._ring_cap
        self._ring_cond = threading.Condition()
        self._next_rev = 1  # next revision the sequencer expects
        self._draining = False  # exactly one drainer sequences at a time
        self._closed = False

        # resume the revision sequence on restart over an existing store
        recovered = self.recover_revision()
        if recovered:
            self.tso.init(recovered)
            self._next_rev = recovered + 1

        from ..util.env import crash_guard

        self._seq_thread = threading.Thread(
            target=crash_guard(self._collect_events), name="kb-sequencer", daemon=True
        )
        self._seq_thread.start()
        self.retry.run()

    def recover_revision(self) -> int:
        """Highest revision any write batch ever committed (LAST_REV_KEY is
        written inside every write batch); 0 on a fresh store."""
        try:
            raw = self.store.get(LAST_REV_KEY)
            rev, _ = coder.decode_rev_value(raw)
            return rev
        except (KeyNotFoundError, coder.CodecError):
            return 0

    def _await_revealed(self, revision: int) -> None:
        """Fence a definite write failure behind the sequencer floor.

        A conflict/notfound reveals storage state that can be AHEAD of the
        contiguous committed floor: the conflicting write is already
        storage-committed but its event not yet sequenced, so the caller's
        NEXT read (served at the floor) would travel back in time — a real
        stale-read anomaly our linearizability soak caught (a create
        conflicted against rev 18, then the same client's get served rev
        15; tests/test_linearizability.py). Wait (bounded) until the floor
        passes the revealed revision before surfacing the failure.
        ``revision < 0`` means "something newer exists but its revision is
        unknown" (a delete that found a fresh tombstone): sync to the
        storage watermark instead. MUST be called only after this op's own
        event was notified — the floor cannot pass our own dealt revision
        until then (self-deadlock).
        """
        if revision < 0:
            try:
                revision = self.recover_revision()
            except Exception:
                return  # best-effort fence: never mask the original error
        if revision > self.tso.committed():
            self.tso.wait_committed(revision, timeout=5.0)

    # =================================================================== writes
    def _commit_write(
        self,
        user_key: bytes,
        revision: int,
        new_record: bytes,
        expected_record: bytes | None,
        obj_value: bytes,
        ttl: int,
    ) -> None:
        """Record + object row + watermark as one atomic engine write.
        expected_record None ⇒ put-if-not-exist on the revision record.
        Uses the engine's single-call fast path when available."""
        rev_key = coder.encode_revision_key(user_key)
        obj_key = coder.encode_object_key(user_key, revision)
        last_val = coder.encode_rev_value(revision)
        if self._mvcc_write is not None:
            self._mvcc_write(
                rev_key, new_record, expected_record, obj_key, obj_value,
                LAST_REV_KEY, last_val, ttl,
            )
            return
        batch = self.store.begin_batch_write()
        if expected_record is None:
            batch.put_if_not_exist(rev_key, new_record, ttl)
        else:
            batch.cas(rev_key, new_record, expected_record, ttl)
        batch.put(obj_key, obj_value, ttl)
        batch.put(LAST_REV_KEY, last_val)
        batch.commit()

    def create(self, user_key: bytes, value: bytes, ttl: int | None = None,
               lease: int = 0) -> int:
        """Insert; returns the new revision. KeyExistsError carries the live
        revision on conflict. Reference txn.go:33 + creator/naive.go:53.
        ``ttl`` overrides the key-pattern TTL; ``lease`` attaches the key to
        a lease (kubebrain_tpu/lease) — expiry then happens via the reaper's
        revision-stamped delete, NOT an engine TTL, so it always wins over
        both."""
        if lease:
            ttl = self._lease_ttl(lease)  # raises LeaseNotFoundError
        rev = self.tso.deal()
        event = WatchEvent(revision=rev, verb=Verb.CREATE, key=user_key, value=value, valid=False)
        revealed = 0
        try:
            creator.create(self._commit_write, user_key, value, rev, ttl=ttl)
            event.valid = True
            self._lease_attach(user_key, lease)
            return rev
        except KeyExistsError as e:
            revealed = e.revision or -1  # rev-0 conflicts still fence
            raise
        except FutureRevisionError as e:
            revealed = e.current
            raise
        except UncertainResultError as e:
            event.err = e
            raise
        finally:
            # ring first: _notify is the side that must survive anything
            # else in this finally raising (a dealt-but-unnotified revision
            # stalls the sequencer forever); the log line is best-effort
            self._notify(event)
            txn_log("create", user_key, rev, event.err or sys.exc_info()[1])
            self.tso.wait_committed(rev, timeout=5.0)
            if revealed:
                self._await_revealed(revealed)

    def update(
        self, user_key: bytes, value: bytes, expected_revision: int,
        ttl: int | None = None, lease: int = 0,
    ) -> int:
        """Conditional overwrite: CAS(revision_key, expected→new) + Put(object).
        Reference txn.go:193-265. On revision mismatch raises
        CASRevisionMismatchError carrying the latest (revision, value) —
        re-read via the conflict fast path (txn.go:225-241). ``lease``
        re-attaches the key (0 = detach, etcd put-without-lease)."""
        if lease:
            ttl = self._lease_ttl(lease)  # raises LeaseNotFoundError
        # resolve the TTL before dealing: ttl_for_key can raise, and no
        # fallible call belongs between a deal and its notify-protected try
        ttl_resolved = creator.ttl_for_key(user_key) if ttl is None else ttl
        rev = self.tso.deal()
        event = WatchEvent(
            revision=rev, verb=Verb.PUT, key=user_key, value=value,
            prev_revision=expected_revision, valid=False,
        )
        ttl = ttl_resolved
        revealed = 0
        try:
            if rev <= expected_revision:
                # drift-back anomaly (reference txn.go:171-175): the dealt
                # revision must exceed the record it supersedes
                raise FutureRevisionError(rev, expected_revision)
            self._commit_write(
                user_key, rev,
                coder.encode_rev_value(rev),
                coder.encode_rev_value(expected_revision),
                value, ttl,
            )
            event.valid = True
            self._lease_reattach(user_key, lease)
            return rev
        except CASFailedError as e:
            observed = e.conflict.value if e.conflict else None
            latest_rev, latest_val = 0, None
            if observed is not None:
                try:
                    latest_rev, deleted = coder.decode_rev_value(observed)
                    if not deleted:
                        latest_val = self._read_object(user_key, latest_rev)
                except coder.CodecError:
                    pass
            revealed = latest_rev or -1
            raise CASRevisionMismatchError(user_key, latest_rev, latest_val) from e
        except UncertainResultError as e:
            event.err = e
            raise
        finally:
            self._notify(event)
            txn_log("update", user_key, rev, event.err or sys.exc_info()[1])
            self.tso.wait_committed(rev, timeout=5.0)
            if revealed:
                self._await_revealed(revealed)

    def delete(self, user_key: bytes, expected_revision: int = 0) -> tuple[int, KeyValue]:
        """Tombstone write. The reference pays three engine round-trips here
        (read record, read previous value, CAS batch — its documented delete
        weakness, txn.go:79-190, benchmark.md:56-61); with a native engine the
        whole read-validate-tombstone sequence is one call.
        Returns (new_revision, previous KeyValue)."""
        if self._mvcc_delete is not None:
            return self._delete_fast(user_key, expected_revision)
        record = self._read_rev_record(user_key)
        if record is None or record[1]:
            # nothing dealt yet — fence directly when the miss reveals a
            # possibly-not-yet-sequenced tombstone (a truly absent record
            # reveals nothing newer; see _await_revealed)
            if record is not None:
                self._await_revealed(record[0])
            raise KeyNotFoundError(user_key)
        latest_rev, _ = record
        if expected_revision and latest_rev != expected_revision:
            val = self._read_object(user_key, latest_rev)
            self._await_revealed(latest_rev)
            raise CASRevisionMismatchError(user_key, latest_rev, val)
        prev_value = self._read_object(user_key, latest_rev)
        rev = self.tso.deal()
        event = WatchEvent(
            revision=rev, verb=Verb.DELETE, key=user_key,
            prev_revision=latest_rev, prev_value=prev_value, valid=False,
        )
        revealed = 0
        try:
            if rev <= latest_rev:
                # drift-back anomaly (txn.go:171-175) — raised inside the
                # notify-protected region so the dealt revision is still
                # sequenced and the pipeline never stalls
                revealed = latest_rev
                raise FutureRevisionError(rev, latest_rev)
            self._commit_write(
                user_key, rev,
                coder.encode_rev_value(rev, deleted=True),
                coder.encode_rev_value(latest_rev),
                TOMBSTONE, 0,
            )
            event.valid = True
            self._lease_detach(user_key)
            return rev, KeyValue(user_key, prev_value or b"", latest_rev)
        except CASFailedError as e:
            observed = e.conflict.value if e.conflict else None
            lr, lv = 0, None
            if observed is not None:
                try:
                    lr, deleted = coder.decode_rev_value(observed)
                    lv = None if deleted else self._read_object(user_key, lr)
                except coder.CodecError:
                    pass
            revealed = lr or -1
            raise CASRevisionMismatchError(user_key, lr, lv) from e
        except UncertainResultError as e:
            event.err = e
            raise
        finally:
            self._notify(event)
            txn_log("delete", user_key, rev, event.err or sys.exc_info()[1])
            self.tso.wait_committed(rev, timeout=5.0)
            if revealed:
                self._await_revealed(revealed)

    def _delete_fast(self, user_key: bytes, expected_revision: int) -> tuple[int, KeyValue]:
        """Single-call delete via the engine (read+validate+tombstone under
        one lock). Failed deletes consume a revision here (dealt up front) —
        etcd semantics allow revision gaps."""
        rev = self.tso.deal()
        event = WatchEvent(revision=rev, verb=Verb.DELETE, key=user_key, valid=False)
        revealed = 0
        try:
            outcome, prev, latest = self._mvcc_delete(
                coder.encode_revision_key(user_key),
                expected_revision, rev,
                coder.encode_rev_value(rev, deleted=True),
                TOMBSTONE, LAST_REV_KEY, coder.encode_rev_value(rev),
            )
            if outcome == "not_found":
                # latest = tombstone revision; 0 = truly absent (no fence)
                revealed = latest
                raise KeyNotFoundError(user_key)
            if outcome == "mismatch":
                revealed = latest or -1
                raise CASRevisionMismatchError(
                    user_key, latest, None if prev == TOMBSTONE else prev
                )
            event.prev_revision = latest
            event.prev_value = prev
            event.valid = True
            self._lease_detach(user_key)
            return rev, KeyValue(user_key, prev or b"", latest)
        except RevisionDriftBackError as e:
            # engine-level drift (a concurrent write drew >= our revision):
            # same fenced, retryable contract as the slow path
            revealed = e.latest or -1
            raise FutureRevisionError(rev, e.latest) from e
        except UncertainResultError as e:
            event.err = e
            raise
        finally:
            self._notify(event)
            txn_log("delete", user_key, rev, event.err or sys.exc_info()[1])
            self.tso.wait_committed(rev, timeout=5.0)
            if revealed:
                self._await_revealed(revealed)

    # ============================================================ group commit
    def write_batch(self, ops: list) -> list:
        """Group commit: execute a batch of write ops as ONE commit group —
        the scheduler's write-batch executor (the write twin of
        :meth:`list_batch`). ``ops`` is a list of

        - ``("create", key, value, ttl, lease)``
        - ``("update", key, value, expected_revision, ttl, lease)``
        - ``("delete", key, expected_revision)``

        and the return list is aligned with it: an ``int`` revision for
        create/update, ``(revision, KeyValue)`` for delete, or an Exception
        instance to raise to that op's waiter alone (per-op demux — a CAS
        conflict fails its op, never the group).

        Mechanics (docs/writes.md): lease TTLs resolve first (a bad lease
        fails its op without consuming a revision, like the sequential
        paths); the surviving ops deal ONE contiguous revision block
        (``TSO.deal_block``) in op order; the engine applies the group in a
        single ``write_batch`` round trip with per-op conditional demux —
        each op validates against the state as mutated by earlier ops in
        the SAME group, so same-key ops inside a group behave exactly as
        back-to-back sequential commits; every dealt revision is notified
        into the event ring (valid, failed, or uncertain — the sequencer
        contract), all in one ring pass. Failed ops consume their dealt
        revision (notified invalid) exactly like the engine fast paths
        (`_delete_fast`) — etcd semantics allow revision gaps. Engines
        without ``write_batch`` fall back to the per-op sequential methods
        with identical results."""
        out: list = [None] * len(ops)
        if self._engine_write_batch is None or len(ops) == 1:
            for i, op in enumerate(ops):
                try:
                    out[i] = self._apply_single(op)
                except BaseException as e:
                    out[i] = e
            return out

        # phase 1 — lease/TTL resolution; failures consume no revision
        pending: list[dict] = []
        for i, op in enumerate(ops):
            kind = op[0]
            try:
                if kind == "create":
                    _, key, value, ttl, lease = op
                    if lease:
                        ttl = self._lease_ttl(lease)
                    ttl = creator.ttl_for_key(key) if ttl is None else ttl
                    pending.append(dict(i=i, kind=kind, key=key, value=value,
                                        ttl=ttl, lease=lease, expected=0))
                elif kind == "update":
                    _, key, value, expected, ttl, lease = op
                    if lease:
                        ttl = self._lease_ttl(lease)
                    ttl = creator.ttl_for_key(key) if ttl is None else ttl
                    pending.append(dict(i=i, kind=kind, key=key, value=value,
                                        ttl=ttl, lease=lease, expected=expected))
                elif kind == "delete":
                    _, key, expected = op
                    pending.append(dict(i=i, kind=kind, key=key, value=b"",
                                        ttl=0, lease=0, expected=expected))
                else:
                    raise ValueError(f"unknown write op kind {kind!r}")
            except BaseException as e:
                out[i] = e
        if not pending:
            return out

        # phase 2 — one contiguous revision block, dealt in op order
        base = self.tso.deal_block(len(pending))
        engine_ops: list[tuple] = []
        runnable: list[dict] = []  # pending ops that reach the engine
        revealed_max = 0
        revealed_watermark = False
        try:
            for j, p in enumerate(pending):
                rev = base + j
                p["rev"] = rev
                kind, key = p["kind"], p["key"]
                if kind == "create":
                    p["event"] = WatchEvent(revision=rev, verb=Verb.CREATE,
                                            key=key, value=p["value"], valid=False)
                    op_t = ("create", coder.encode_revision_key(key), rev,
                            coder.encode_rev_value(rev),
                            coder.encode_object_key(key, rev), p["value"],
                            LAST_REV_KEY, coder.encode_rev_value(rev), p["ttl"])
                elif kind == "update":
                    p["event"] = WatchEvent(revision=rev, verb=Verb.PUT, key=key,
                                            value=p["value"],
                                            prev_revision=p["expected"], valid=False)
                    if rev <= p["expected"]:
                        # drift-back anomaly (txn.go:171-175): the dealt revision
                        # must exceed the record it supersedes; the revision is
                        # consumed and notified invalid, like the sequential path
                        p["fail"] = FutureRevisionError(rev, p["expected"])
                        continue
                    op_t = ("update", coder.encode_revision_key(key),
                            coder.encode_rev_value(rev),
                            coder.encode_rev_value(p["expected"]),
                            coder.encode_object_key(key, rev), p["value"],
                            LAST_REV_KEY, coder.encode_rev_value(rev), p["ttl"])
                else:  # delete
                    p["event"] = WatchEvent(revision=rev, verb=Verb.DELETE,
                                            key=key, valid=False)
                    op_t = ("delete", coder.encode_revision_key(key),
                            p["expected"], rev,
                            coder.encode_rev_value(rev, deleted=True), TOMBSTONE,
                            LAST_REV_KEY, coder.encode_rev_value(rev))
                engine_ops.append(op_t)
                runnable.append(p)

            # phase 3 — ONE engine round trip with per-op outcome demux
            if engine_ops:
                try:
                    results = self._engine_write_batch(engine_ops)
                    if len(results) != len(engine_ops):
                        raise RuntimeError(
                            f"engine write_batch returned {len(results)} "
                            f"outcomes for {len(engine_ops)} ops")
                except UncertainResultError as e:
                    # group-atomic uncertainty: every op maybe-applied
                    results = [("uncertain", e)] * len(engine_ops)
                except BaseException as e:
                    results = [("error", e)] * len(engine_ops)
            else:
                results = []

            # phase 4 — map outcomes, run lease hooks, collect fences
            by_id = {id(p): r for p, r in zip(runnable, results)}
            for p in pending:
                i, rev, key = p["i"], p["rev"], p["key"]
                fail = p.get("fail")
                if fail is not None:
                    out[i] = fail
                else:
                    try:
                        res, rvl = self._demux_write_outcome(p, by_id[id(p)])
                    except BaseException as e:
                        # demux/lease-hook failure (e.g. a transient
                        # _read_object error building a CAS conflict) fails
                        # ONLY this op; the event keeps whatever validity
                        # was set before the raise, so a committed engine
                        # op stays watch-visible
                        res, rvl = e, 0
                    out[i] = res
                    if rvl == -1:
                        revealed_watermark = True
                    elif rvl:
                        revealed_max = max(revealed_max, rvl)
                err = out[i] if isinstance(out[i], BaseException) else None
                txn_log(p["kind"], key, rev, p["event"].err or err)
        finally:
            # phase 5 — one ring pass for the whole block, then the write
            # fence. In a finally like every sequential path's notify: a
            # dealt revision MUST always reach the ring, else the sequencer
            # can never advance past it and every later write stalls. A
            # phase-2 encoding failure leaves later ops eventless — they
            # still consumed their revisions, so they get invalid events
            # here (dealt and notified must never diverge).
            verbs = {"create": Verb.CREATE, "update": Verb.PUT,
                     "delete": Verb.DELETE}
            for j, p in enumerate(pending):
                if "event" not in p:
                    p["event"] = WatchEvent(revision=base + j,
                                            verb=verbs[p["kind"]],
                                            key=p["key"], valid=False)
            self._notify_many([p["event"] for p in pending])
            self.tso.wait_committed(base + len(pending) - 1, timeout=5.0)
        if revealed_watermark:
            self._await_revealed(-1)
        elif revealed_max:
            self._await_revealed(revealed_max)
        return out

    def _demux_write_outcome(self, p: dict, outcome) -> tuple:
        """One engine outcome → (result-or-Exception, revealed_revision).
        The mappings replicate the sequential paths' conflict handling
        byte for byte (create/creator.py, update, _delete_fast)."""
        kind, key, rev = p["kind"], p["key"], p["rev"]
        event = p["event"]
        status = outcome[0]
        if status == "uncertain":
            event.err = outcome[1]
            return outcome[1], 0
        if status == "error":
            return outcome[1], 0
        if kind == "delete":
            if status == "ok":
                _, prev, latest = outcome
                event.prev_revision = latest
                event.prev_value = prev
                event.valid = True
                self._lease_detach(key)
                return (rev, KeyValue(key, prev or b"", latest)), 0
            if status == "not_found":
                # outcome[2] = tombstone revision; 0 = truly absent (no fence)
                return KeyNotFoundError(key), outcome[2]
            if status == "mismatch":
                _, prev, latest = outcome
                return (CASRevisionMismatchError(
                    key, latest, None if prev == TOMBSTONE else prev),
                    latest or -1)
            if status == "drift":
                return FutureRevisionError(rev, outcome[1]), outcome[1] or -1
        elif kind == "create":
            if status == "ok":
                event.valid = True
                self._lease_attach(key, p["lease"])
                return rev, 0
            if status == "drift":
                return FutureRevisionError(rev, outcome[1]), outcome[1] or -1
            if status == "conflict":
                observed = outcome[1]
                if observed is None:
                    return KeyExistsError(key, 0), -1
                try:
                    old_rev, deleted = coder.decode_rev_value(observed)
                except coder.CodecError:
                    return KeyExistsError(key, 0), -1
                if deleted:
                    # a correct engine resolves tombstones itself (convert or
                    # drift); an engine that surfaces one is mapped like the
                    # creator's lost-race branch
                    return FutureRevisionError(rev, old_rev), old_rev or -1
                return KeyExistsError(key, old_rev), old_rev or -1
        else:  # update
            if status == "ok":
                event.valid = True
                self._lease_reattach(key, p["lease"])
                return rev, 0
            if status == "conflict":
                observed = outcome[1]
                latest_rev, latest_val = 0, None
                if observed is not None:
                    try:
                        latest_rev, deleted = coder.decode_rev_value(observed)
                        if not deleted:
                            latest_val = self._read_object(key, latest_rev)
                    except coder.CodecError:
                        pass
                return (CASRevisionMismatchError(key, latest_rev, latest_val),
                        latest_rev or -1)
            if status == "drift":
                return FutureRevisionError(rev, outcome[1]), outcome[1] or -1
        return RuntimeError(
            f"engine write_batch outcome {outcome!r} for op kind {kind}"), 0

    def _apply_single(self, op: tuple):
        """Per-op fallback for engines without ``write_batch`` — the
        sequential methods, so semantics cannot drift."""
        kind = op[0]
        if kind == "create":
            return self.create(op[1], op[2], ttl=op[3], lease=op[4])
        if kind == "update":
            return self.update(op[1], op[2], op[3], ttl=op[4], lease=op[5])
        if kind == "delete":
            return self.delete(op[1], op[2])
        raise ValueError(f"unknown write op kind {kind!r}")

    # ==================================================================== reads
    def current_revision(self) -> int:
        return self.tso.committed()

    def set_current_revision(self, revision: int) -> None:
        """Seed revision state (leader start / follower sync).
        Reference: leader.go:96-107 → backend.SetCurrentRevision."""
        self.tso.init(revision)
        with self._ring_cond:
            if revision + 1 > self._next_rev:
                self._next_rev = revision + 1
                # drop events below the new term's floor — they would never
                # be drained and would poison the wrap check
                for i, ev in enumerate(self._ring):
                    if ev is not None and ev.revision < self._next_rev:
                        self._ring[i] = None
            self._ring_cond.notify_all()

    def ingest_replicated(self, events: list[WatchEvent], watermark: int) -> None:
        """Follower role (``replica/``): adopt an already-sequenced
        replicated event block from the leader's stream — watch cache + hub
        fan-out + the committed revision floor, strictly DOWNSTREAM of the
        leader's sequencer. The local ring/TSO-deal path is never involved:
        followers deal nothing, so the block needs no re-sequencing — the
        stream's revision order IS the sequence. ``events`` may be empty
        (a progress mark crossing the leader's revision gaps); ``watermark``
        is the new applied floor (every leader event <= it has been applied
        to the local store before this call)."""
        now = time.monotonic()
        for e in events:
            e.ts = now
        if events:
            self._flush(events)
        if watermark > self.tso.committed():
            # commit (not init): fence waiters park on the TSO's committed
            # condition, and the watermark advance is their wake-up
            self.tso.commit(watermark)
            with self._ring_cond:
                if watermark + 1 > self._next_rev:
                    self._next_rev = watermark + 1

    def flushed_revision(self) -> int:
        """Highest revision guaranteed fully streamed into every hub
        subscriber queue (the sound floor for watch progress marks —
        ``WatcherHub.post_progress``). -1 while the pipeline is mid-drain
        or an event is pending at the floor (callers retry) — distinct
        from the legitimate floor 0 of a store that has served no writes.
        Gap revisions (failed/uncertain ops) count: every DEALT revision
        passes through the ring, so ``_next_rev - 1`` means "nothing
        below is owed"."""
        with self._ring_cond:
            if self._draining:
                return -1
            if self._ring[self._next_rev % self._ring_cap] is not None:
                return -1
            return self._next_rev - 1

    def get(self, user_key: bytes, revision: int = 0) -> KeyValue:
        """Point read at a snapshot: reverse-iterate the version chain from
        (key, read_rev) down, take the first row, reject tombstones.
        Reference range.go:34-121."""
        read_rev = self._read_revision_checked(revision)
        # reverse-iterate (key, read_rev) → (key, 0); highest version first,
        # the rev-0 record sorts last so a rev-0 first hit means "no versions"
        start = coder.encode_object_key(user_key, read_rev)
        end = coder.encode_revision_key(user_key)
        it = self.store.iter(start, end, snapshot_ts=self.store.get_timestamp_oracle(), limit=1)
        for ikey, value in it:
            _, rev = coder.decode(ikey)
            if rev == 0 or value == TOMBSTONE:
                break
            return KeyValue(user_key, value, rev)
        raise KeyNotFoundError(user_key)

    def list_(
        self, start: bytes, end: bytes, revision: int = 0, limit: int = 0
    ) -> RangeResult:
        """Range read at a snapshot; limit+1 detects More (range.go:124-171)."""
        def read(read_rev):
            kvs, more = self.scanner.range_(start, end, read_rev, limit)
            return RangeResult(kvs=kvs, revision=read_rev, more=more,
                               count=len(kvs))

        return self._at_head(revision, read)

    def list_wire(self, start: bytes, end: bytes, revision: int = 0,
                  limit: int = 0):
        """Range read returning ready RangeResponse.kvs wire bytes when the
        engine scanner has a C wire encoder; None otherwise. Returns
        (kvs_blob, count, more, read_rev)."""
        fast = getattr(self.scanner, "list_wire", None)
        if fast is None:
            return None
        def read(read_rev):
            # one C call does scan + wire encode; attribute it as the engine
            # compute stage so the raw fast path still shows up in traces
            with TRACER.stage("device_compute"):
                blob, n, more = fast(start, end, read_rev, limit)
            return blob, n, more, read_rev

        return self._at_head(revision, read)

    def count(self, start: bytes, end: bytes, revision: int = 0) -> tuple[int, int]:
        return self._at_head(revision, lambda read_rev: (
            self.scanner.count(start, end, read_rev), read_rev))

    def list_batch(self, queries: list) -> list:
        """Batched range reads — the scheduler's batch executor. ``queries``
        is a list of ``("list", start, end, revision, limit)`` /
        ``("count", start, end, revision)`` tuples; the return list is
        aligned with it, each element a RangeResult, a ``(count,
        read_rev)`` tuple, or an Exception instance to raise to that
        query's waiter alone (a compacted revision fails its query, not
        the batch). Read revisions resolve here, at execution start — the
        same point a sequential execution would resolve them, so rev-0
        batching preserves read-your-writes exactly like coalescing does.
        Engines with a query-batched scanner (``scan_batch``, the GPU
        mirror) answer every device-path query in ONE kernel dispatch;
        other engines fall back to per-query scans with identical results.
        A head query that a compaction passed before its scan runs again,
        as in :meth:`_at_head`.
        """
        out = self._list_batch_once(queries)
        for _ in range(HEAD_READ_ATTEMPTS - 1):
            again = [i for i, q in enumerate(queries)
                     if not q[3] and isinstance(out[i], CompactedError)]
            if not again:
                break
            for i, res in zip(again, self._list_batch_once(
                    [queries[i] for i in again])):
                out[i] = res
        return out

    def _list_batch_once(self, queries: list) -> list:
        out: list = [None] * len(queries)
        resolved: list[tuple[int, tuple, int]] = []
        for i, q in enumerate(queries):
            try:
                resolved.append((i, q, self._read_revision_checked(q[3])))
            except Exception as e:
                out[i] = e
        scan_batch = getattr(self.scanner, "scan_batch", None)
        if scan_batch is not None and len(resolved) > 1:
            specs = [
                ("count", q[1], q[2], rr) if q[0] == "count"
                else ("range", q[1], q[2], rr, q[4])
                for _i, q, rr in resolved
            ]
            results = scan_batch(specs)
            for (i, q, rr), res in zip(resolved, results):
                if isinstance(res, BaseException):
                    out[i] = res
                elif q[0] == "count":
                    out[i] = (res, rr)
                else:
                    kvs, more = res
                    out[i] = RangeResult(kvs=kvs, revision=rr, more=more,
                                         count=len(kvs))
            return out
        for i, q, rr in resolved:  # engine-generic sequential fallback
            try:
                if q[0] == "count":
                    out[i] = (self.scanner.count(q[1], q[2], rr), rr)
                else:
                    kvs, more = self.scanner.range_(q[1], q[2], rr, q[4])
                    out[i] = RangeResult(kvs=kvs, revision=rr, more=more,
                                         count=len(kvs))
            except Exception as e:
                out[i] = e
        return out

    def list_by_stream(
        self, start: bytes, end: bytes, revision: int = 0
    ) -> tuple[int, Iterator[list[KeyValue]]]:
        read_rev = self._read_revision_checked(revision)
        return read_rev, self.scanner.range_stream(start, end, read_rev)

    def get_partitions(self, start: bytes, end: bytes) -> list[Partition]:
        """User-key partition borders for client-side partition-wise listing
        (reference range.go:208-244, magic revision 1888 in etcd/kv.go:33)."""
        lo, hi = coder.internal_range(start, end)
        parts = self.store.get_partitions(lo, hi)
        out: list[Partition] = []
        left = start
        for p in parts[:-1]:
            if coder.is_internal_key(p.right):
                user_key, _ = coder.decode(p.right)
            else:
                user_key = p.right
            if user_key <= left or (end and user_key >= end):
                continue
            out.append(Partition(left, user_key))
            left = user_key
        out.append(Partition(left, end))
        return out

    # ================================================================== compact
    def compact(self, revision: int) -> int:
        """Compact to min(requested, committed, min-uncertain − 1); persist the
        watermark (fences readers), then GC per border pair.
        Reference compact.go:31-126."""
        with self._compact_lock:
            target = min(revision, self.tso.committed())
            retry_min = self.retry.min_revision()
            if retry_min:
                target = min(target, retry_min - 1)
            current = self._compact_revision_at(None)
            if target <= current:
                return current
            self._persist_compact_floor_locked(target, current)
            for left, right in self._compact_borders():
                self.scanner.compact(left, right, target)
            return target

    def _persist_compact_floor_locked(self, target: int, current: int) -> None:
        """Persist + cache the compact watermark (callers hold
        ``_compact_lock``) — shared by :meth:`compact` and the follower's
        GC-free :meth:`set_compact_floor` so the record format and cache
        invalidation can never diverge between the two."""
        self._set_compact_record(target, current)
        with self._compact_cache_lock:
            self._compact_rev_cache = target
            self._compact_cache_time = time.monotonic()

    def set_compact_floor(self, revision: int) -> int:
        """Persist the compact watermark WITHOUT running GC borders — the
        follower bootstrap/resync case (``replica/``): the local
        store was built from post-GC leader state, so there is nothing to
        collect, only history below ``revision`` to fence off (reads under
        it refuse as compacted — the honest etcd answer for a follower
        whose replicated history starts at its bootstrap revision)."""
        with self._compact_lock:
            current = self._compact_revision_at(None)
            if revision <= current:
                return current
            self._persist_compact_floor_locked(revision, current)
            return revision

    def _compact_borders(self) -> list[tuple[bytes, bytes]]:
        """Internal-key border pairs covering the configured prefix minus
        skip-prefixes (reference compact.go:107-126)."""
        prefix = self.config.prefix
        lo, hi = coder.internal_range(prefix, coder.prefix_end(prefix) if prefix else b"")
        borders: list[tuple[bytes, bytes]] = []
        left = lo
        for skip in sorted(self.config.skip_prefixes):
            s_lo = coder.encode_revision_key(skip)
            s_hi = coder.encode_revision_key(coder.prefix_end(skip))
            if s_lo > left:
                borders.append((left, s_lo))
            left = s_hi
        borders.append((left, hi))
        return borders

    def _set_compact_record(self, revision: int, old: int) -> None:
        batch = self.store.begin_batch_write()
        value = coder.encode_rev_value(revision)
        if old == 0:
            try:
                batch.put_if_not_exist(COMPACT_KEY, value)
                batch.commit()
                return
            except CASFailedError:
                batch = self.store.begin_batch_write()
                old = self._compact_revision_at(None)
        batch.cas(COMPACT_KEY, value, coder.encode_rev_value(old))
        batch.commit()

    def _compact_revision_at(self, snapshot: int | None) -> int:
        try:
            raw = self.store.get(COMPACT_KEY, snapshot_ts=snapshot)
        except KeyNotFoundError:
            return 0
        rev, _ = coder.decode_rev_value(raw)
        return rev

    def _compact_revision_cached(self) -> int:
        # cache fields ride their own tiny lock (kblint KB120: the
        # lock-free RMW raced _persist_compact_floor_locked's update); the
        # STORE read happens outside any hold, and the install is
        # monotonic — a refresh that raced a concurrent compaction can
        # only raise the floor, never resurrect a pre-compact one (the
        # watermark itself never decreases; -1 means invalidated)
        with self._compact_cache_lock:
            now = time.monotonic()
            cached = self._compact_rev_cache
            if cached >= 0 and now - self._compact_cache_time <= 1.0:
                return cached
        fetched = self._compact_revision_at(None)
        with self._compact_cache_lock:
            if fetched > self._compact_rev_cache:
                self._compact_rev_cache = fetched
            if now > self._compact_cache_time:
                self._compact_cache_time = now
            return self._compact_rev_cache

    def compact_revision(self) -> int:
        return self._compact_revision_at(None)

    # ==================================================================== watch
    def watch(self, prefix: bytes = b"", revision: int = 0, queue_factory=None):
        """Prefix-watch sugar over watch_range."""
        end = coder.prefix_end(prefix) if prefix else b""
        return self.watch_range(prefix, end, revision, queue_factory=queue_factory)

    def watch_range(self, start: bytes, end: bytes, revision: int = 0, queue_factory=None):
        """Subscribe-then-replay watch registration (reference watch.go:37-96):
        subscribe to the hub FIRST, then replay history from the cache for
        events in (revision, hub-subscription point]; raise WatchExpiredError
        when the requested revision pre-dates the cache so the client re-lists.
        Returns (watcher_id, queue) — the queue yields event batches and a
        None poison pill on close."""
        def validate() -> None:
            if not revision:
                return
            compacted = self._compact_revision_cached()
            if revision < compacted:
                # etcd semantics: watching below the compact watermark is
                # unservable history — cancel so the client re-lists
                raise WatchExpiredError(f"want {revision}, compacted {compacted}")
            oldest = self.watch_cache.oldest_revision()
            if len(self.watch_cache) == 0:
                if revision < self.tso.committed():
                    raise WatchExpiredError(f"cache empty, want {revision}")
            elif self.watch_cache.has_evicted():
                # once the ring has dropped events, oldest-1 may name a real
                # evicted event — match the reference's strict check
                # (ring.FindEvents "low" when revision < oldest, watch.go)
                if revision < oldest:
                    raise WatchExpiredError(f"want {revision}, cache oldest {oldest}")
            elif revision < oldest - 1:
                # never-full cache: oldest-1 is the pre-history revision the
                # first cached event was written against — replay is complete
                raise WatchExpiredError(f"want {revision}, cache oldest {oldest}")

        wid, q, _replayed = self.watcher_hub.add_watcher_with_replay(
            start, end, revision, self.watch_cache, validate=validate,
            queue_factory=queue_factory,
        )
        return wid, q

    def unwatch(self, wid: int) -> None:
        self.watcher_hub.delete_watcher(wid)

    # ========================================================== event pipeline
    def _notify(self, event: WatchEvent) -> None:
        """Post one event into the revision-indexed ring (txn.go:267-293) and
        opportunistically sequence it inline. Raises if the ring wraps — the
        invariant crash the reference keeps (panic "watch push buffer full",
        txn.go:287-290)."""
        idx = event.revision % self._ring_cap
        with self._ring_cond:
            if self._ring[idx] is not None:
                raise RuntimeError("event ring wrapped: sequencer too far behind")
            self._ring[idx] = event
            self._ring_cond.notify_all()
        # inline drain: in the common (uncontended) case the writer sequences
        # its own event synchronously, skipping a cross-thread wakeup —
        # functionally the reference's always-hot spin sequencer
        # (backend.go:212-224) without burning a core
        self._drain()

    def _notify_many(self, events: list[WatchEvent]) -> None:
        """Post a whole commit group's events into the ring under ONE lock
        acquisition, then drain once — the group-commit analogue of
        :meth:`_notify` (a group of G writes pays one ring pass and one
        sequencer wakeup instead of G)."""
        if not events:
            return
        with self._ring_cond:
            for event in events:
                idx = event.revision % self._ring_cap
                if self._ring[idx] is not None:
                    raise RuntimeError(
                        "event ring wrapped: sequencer too far behind")
                self._ring[idx] = event
            self._ring_cond.notify_all()
        self._drain()

    def _drain(self) -> None:
        """Consume contiguous ready revisions in order. Exactly one drainer
        runs at a time (ordering through cache + hub must match revision
        order); others return immediately — their events are picked up by
        the active drainer's re-check loop."""
        while True:
            with self._ring_cond:
                if self._draining or self._closed:
                    return
                ready: list[WatchEvent] = []
                while True:
                    idx = self._next_rev % self._ring_cap
                    ev = self._ring[idx]
                    if ev is None or ev.revision != self._next_rev:
                        break
                    self._ring[idx] = None
                    self._next_rev += 1
                    ready.append(ev)
                if not ready:
                    return
                self._draining = True
            try:
                batch: list[WatchEvent] = []
                for event in ready:
                    self.tso.commit(event.revision)
                    event.ts = time.monotonic()
                    if event.err is not None and isinstance(event.err, UncertainResultError):
                        self.retry.append(event)
                    elif event.valid:
                        batch.append(event)
                    if len(batch) >= EVENT_BATCH and not self._hub_blocks:
                        self._flush(batch)
                        batch = []
                self._flush(batch)
            finally:
                with self._ring_cond:
                    self._draining = False
            # loop: events may have landed while we processed

    def _collect_events(self) -> None:
        """Background drainer (reference collectStorageWriteEvents,
        backend.go:208-270): picks up whatever writers didn't sequence
        inline (e.g. events posted while another drainer was mid-flush)."""
        while True:
            with self._ring_cond:
                if self._closed:
                    return
                idx = self._next_rev % self._ring_cap
                # while another thread drains, its re-check loop takes what
                # is ready: calling _drain then only returns at once, and
                # looping on it would spin against the drainer
                if self._ring[idx] is None or self._draining:
                    self._ring_cond.wait(timeout=0.2)
                    # wait() reacquired the condition: the post-wait close
                    # check rides the SAME hold — the bare re-read outside
                    # the lock had no guard in common with close()'s
                    # write (kblint KB120)
                    if self._closed:
                        return
            self._drain()

    def _flush(self, batch: list[WatchEvent]) -> None:
        if not batch:
            return
        for e in batch:
            self.watch_cache.add(e)
        self.watcher_hub.stream(batch)

    # ============================================================ lease hooks
    # (the lease subsystem attaches a registry as ``_kb_lease`` via
    # lease.ensure_lease; without one, PutRequest.lease degrades to the
    # legacy ID:=TTL interpretation for raw embedders)
    def _lease_ttl(self, lease: int) -> int:
        """Engine TTL for a write under ``lease``. With the registry armed
        the answer is always 0: expiry must be the reaper's revision-stamped
        MVCC delete, never a silent engine-level drop — an explicit lease
        beats every key-pattern TTL (creator.ttl_for_key precedence,
        docs/storage_engine.md)."""
        reg = getattr(self, "_kb_lease", None)
        if reg is None:
            return int(lease)  # legacy stub semantics: the lease id IS its TTL
        reg.require(lease)  # LeaseNotFoundError for unknown/expired leases
        return 0

    def _lease_attach(self, user_key: bytes, lease: int) -> None:
        reg = getattr(self, "_kb_lease", None)
        if reg is None or not lease:
            return
        try:
            reg.attach(lease, user_key)
        except Exception:
            # the lease was revoked between require() and commit: the write
            # stands (etcd's applier has the same window, serialized only
            # by raft ordering) and the next put/delete re-binds the key
            pass

    def _lease_reattach(self, user_key: bytes, lease: int) -> None:
        reg = getattr(self, "_kb_lease", None)
        if reg is None:
            return
        try:
            reg.reattach(user_key, lease)
        except Exception:
            pass  # same revoke race as _lease_attach

    def _lease_detach(self, user_key: bytes) -> None:
        reg = getattr(self, "_kb_lease", None)
        if reg is not None:
            reg.detach_key(user_key)

    # ============================================================ retry support
    def _read_rev_record(self, user_key: bytes) -> tuple[int, bool] | None:
        try:
            raw = self.store.get(coder.encode_revision_key(user_key))
        except KeyNotFoundError:
            return None
        try:
            return coder.decode_rev_value(raw)
        except coder.CodecError:
            return None

    def _read_object(self, user_key: bytes, revision: int) -> bytes | None:
        try:
            val = self.store.get(coder.encode_object_key(user_key, revision))
        except KeyNotFoundError:
            return None
        return None if val == TOMBSTONE else val

    def _retry_rewrite(self, event: WatchEvent, record: tuple[int, bool]) -> None:
        """Idempotent overwrite at a fresh revision (retry.go:222-264): the
        uncertain op DID land; emit a proper event via the normal write path."""
        old_rev, deleted = record
        rev = self.tso.deal()
        new_event = WatchEvent(
            revision=rev, verb=event.verb, key=event.key, value=event.value,
            prev_revision=old_rev, valid=False,
        )
        try:
            self._commit_write(
                event.key, rev,
                coder.encode_rev_value(rev, deleted=deleted),
                coder.encode_rev_value(old_rev, deleted=deleted),
                TOMBSTONE if deleted else event.value,
                creator.ttl_for_key(event.key),
            )
            new_event.valid = True
        except CASFailedError:
            pass  # superseded meanwhile: nothing to repair
        except UncertainResultError as e:
            new_event.err = e
        finally:
            self._notify(new_event)

    # ================================================================ lifecycle
    def reset_term(self) -> None:
        """Leadership lost: wipe the watch pipeline so no stale state is ever
        served. The reference panics the whole process for this ("simple and
        rude", leader.go:109-118); dropping every watcher (poison pills force
        clients to re-list/re-watch) and poisoning the scan mirror gives the
        same observable contract without the restart."""
        self.watcher_hub.close()
        if hasattr(self.scanner, "mark_uncertain"):
            self.scanner.mark_uncertain()
        with self._compact_cache_lock:
            self._compact_rev_cache = -1  # re-read the watermark from storage

    def _read_revision_checked(self, revision: int) -> int:
        # the watermark before the head: a compaction's target was committed
        # when it was set, so the head read after it is at or above it
        compacted = self._compact_revision_cached()
        committed = self.tso.committed()
        read_rev = revision or committed
        if revision > committed:
            raise FutureRevisionError(revision, committed)
        if compacted and read_rev < compacted:
            raise CompactedError(read_rev, compacted)
        return read_rev

    def _at_head(self, revision: int, read):
        """``read(read_rev)`` at ``revision`` resolved. etcd serves a
        revision-0 Range from one read view at the current revision and
        never answers it ErrCompacted; here a head read is resolved before
        its scan, and a compaction that lands in between can pass it. A
        head read then resolves again, at the newer head."""
        for _ in range(HEAD_READ_ATTEMPTS - 1):
            try:
                return read(self._read_revision_checked(revision))
            except CompactedError:
                if revision:
                    raise
        return read(self._read_revision_checked(revision))

    def close(self) -> None:
        # the lease reaper issues deletes through this backend: stop it (and
        # checkpoint remaining TTLs) while the sequencer is still alive
        reaper = getattr(self, "_kb_lease_reaper", None)
        if reaper is not None:
            reaper.close()
        # the request scheduler (sched.ensure_scheduler attaches it here)
        # must unblock queued readers before the scan pipeline goes away
        sched = getattr(self, "_kb_scheduler", None)
        if sched is not None:
            sched.close()
        with self._ring_cond:
            self._closed = True
            self._ring_cond.notify_all()
        self._seq_thread.join(timeout=2.0)
        self.retry.close()
        self.watcher_hub.close()
        self.scanner.close()


def wait_for_revision(backend: Backend, revision: int, timeout: float = 5.0) -> bool:
    """Test helper: block until the sequencer has committed ``revision``
    (reference waitUntilRevisionEqualOrTimeout, backend_test.go:1437)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if backend.tso.committed() >= revision:
            return True
        time.sleep(0.002)
    return False
