"""ReplicaApplier: replicated wire events → local MVCC rows + watch fan-out.

Apply path (docs/replication.md): one replicated event batch becomes ONE
tracked engine batch — revision record + object row per event, the
LAST_REV watermark row once — committed through the storage stack's
normal write surface. On the cuda engine that surface is the tracked batch
whose commit records the whole block's version rows into the scanner's
``_DeltaIndex`` in ONE call, in revision order: replicated blocks seal
into the delta exactly like local group commits do, and the entire
mirror/merge/compaction machinery runs unchanged underneath.

Counterpart of ``kubebrain_tpu/replica/apply.py``. It imports no
``proto``: the delete event type is the named constant ``EVENT_DELETE``,
so the wiring below the front loads without ``protobuf``.

Ordering contract: the replication stream delivers events strictly
revision-ascending (etcd watch semantics + WatchMux resume's no-loss/
no-dup guarantee), so the applier can (a) write rows unconditionally
(idempotent on the rare stream-replacement overlap), (b) hand the block
to ``Backend.ingest_replicated`` — watch cache + hub + the TSO committed
floor — and (c) advance the applied watermark to the batch header
revision. Progress notifications (no events) advance the watermark across
the leader's revision gaps (failed ops consume revisions but stream
nothing); the leader only emits them for fully-flushed floors, so the
advance can never skip an owed event.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from .. import coder
from ..backend import creator
from ..backend.common import LAST_REV_KEY, TOMBSTONE, Verb, WatchEvent

#: ``mvccpb.Event_DELETE``, the wire type of a delete event (``kv.proto``:
#: ``enum EventType { PUT = 0; DELETE = 1; }``), named here so the apply
#: path loads without the generated protos
EVENT_DELETE = 1
#: bootstrap rows per engine batch (bounds peak batch size while keeping
#: the delta-seal granularity coarse enough to merge efficiently)
BOOTSTRAP_CHUNK = 512


class ReplicaApplier:
    def __init__(self, backend, role=None):
        self.backend = backend
        self.store = backend.store
        self._role = role
        self._lock = threading.Lock()  # serializes applies across streams
        self.applied_events = 0
        self.applied_batches = 0

    # ------------------------------------------------------------ bootstrap
    def apply_bootstrap(self, kvs: "Sequence[Any]",
                        revision: int) -> None:
        """Seed a stateless follower from one leader list pinned at
        ``revision``: every (key, value, mod_revision) becomes its MVCC row
        pair, the compact floor moves to ``revision`` (history below the
        bootstrap is unservable — refused as compacted, the honest etcd
        answer), and the watermark opens at ``revision``."""
        with self._lock:
            for i in range(0, len(kvs), BOOTSTRAP_CHUNK):
                batch = self.store.begin_batch_write()
                for kv in kvs[i:i + BOOTSTRAP_CHUNK]:
                    self._put_rows(batch, kv.key, kv.mod_revision, kv.value,
                                   deleted=False)
                batch.commit()
            # the watermark row lands ONLY after every row chunk is
            # durable: on a persistent engine, a crash mid-bootstrap must
            # recover to revision 0 and re-bootstrap (idempotent), never
            # to a watermark claiming rows that were still in later chunks
            batch = self.store.begin_batch_write()
            batch.put(LAST_REV_KEY, coder.encode_rev_value(revision))
            batch.commit()
            self.backend.ingest_replicated([], revision)
            self.backend.set_compact_floor(revision)
        if self._role is not None:
            self._role.note_applied(revision, revision)

    # --------------------------------------------------------- wire events
    def apply_wire_events(self, events: "Sequence[Any]",
                          header_revision: int) -> None:
        """One replicated batch (possibly empty = progress notification)."""
        with self._lock:
            watermark = self.backend.tso.committed()
            fresh = [ev for ev in events if ev.kv.mod_revision > watermark]
            if fresh:
                batch = self.store.begin_batch_write()
                local: list[WatchEvent] = []
                for ev in fresh:
                    local.append(self._apply_one(batch, ev))
                batch.put(LAST_REV_KEY,
                          coder.encode_rev_value(local[-1].revision))
                batch.commit()
                self.applied_events += len(local)
                self.applied_batches += 1
                # cache + hub + committed floor, downstream of the leader's
                # sequencer (never the local ring/TSO deal path)
                self.backend.ingest_replicated(
                    local, max(header_revision, local[-1].revision))
            elif header_revision > watermark:
                # progress mark: the leader vouches everything <= header is
                # flushed to this stream — cross the revision gap
                self.backend.ingest_replicated([], header_revision)
        if self._role is not None:
            self._role.note_applied(
                self.backend.tso.committed(), header_revision)

    def _apply_one(self, batch: Any, ev: Any) -> WatchEvent:
        key = bytes(ev.kv.key)
        rev = int(ev.kv.mod_revision)
        if ev.type == EVENT_DELETE:
            self._put_rows(batch, key, rev, TOMBSTONE, deleted=True)
            event = WatchEvent(revision=rev, verb=Verb.DELETE, key=key)
        else:
            value = bytes(ev.kv.value)
            self._put_rows(batch, key, rev, value, deleted=False)
            create_rev = int(ev.kv.create_revision)
            verb = Verb.CREATE if create_rev == rev else Verb.PUT
            event = WatchEvent(revision=rev, verb=verb, key=key, value=value,
                               prev_revision=0 if verb == Verb.CREATE
                               else create_rev)
        if ev.HasField("prev_kv"):
            event.prev_revision = int(ev.prev_kv.mod_revision)
            event.prev_value = bytes(ev.prev_kv.value)
        return event

    def _put_rows(self, batch: Any, key: bytes, rev: int, value: bytes,
                  deleted: bool) -> None:
        # same TTL policy as the leader's write path: replicated lease
        # expiry arrives as ordinary delete EVENTS (the reaper's revision-
        # stamped tombstones), while legacy key-pattern TTLs (/events/)
        # are engine-level on the leader with no delete event — applying
        # the same pattern keeps both sides expiring in step
        ttl = 0 if deleted else (creator.ttl_for_key(key) or 0)
        batch.put(coder.encode_revision_key(key),
                  coder.encode_rev_value(rev, deleted=deleted), ttl)
        batch.put(coder.encode_object_key(key, rev), value, ttl)
