"""etcd3 Watch service: one gRPC stream = one watcher session holding many
watches, each pumping from its backend queue into the shared response stream.

Reference: pkg/server/etcd/watch.go. Protocol points kept:

- each WatchCreateRequest spawns an independent watch with its own cancel
  (watch.go:83-117);
- **negative start revision ⇒ "range stream"**: the client is asking for a
  List delivered over the watch channel (batches of PUT events at the list
  revision, then a cancel) — the custom-apiserver partition-listing trick
  (watch.go:101,150-152,204);
- a watcher whose start revision fell out of the history cache is cancelled
  with compact_revision=1, forcing the client to re-list (watch.go:174-186);
- progress requests answer with a bare header (watch_id −1).
"""

from __future__ import annotations

import queue
import threading

from ...backend import Backend, WatchExpiredError
from ...backend.watcherhub import ProgressMarker
from ...proto import rpc_pb2
from ...trace import emit_histogram
from . import shim


def events_response(batch, watch_id, want_prev, no_put, no_delete):
    """Wire WatchResponse for one event batch (None if fully filtered) —
    shared by the sync and aio pumps so the protocol can't drift."""
    from ...proto import kv_pb2

    resp = rpc_pb2.WatchResponse(
        header=shim.header(batch[-1].revision), watch_id=watch_id
    )
    for ev in batch:
        pe = shim.to_event(ev, want_prev)
        if (pe.type == kv_pb2.Event.PUT and no_put) or (
            pe.type == kv_pb2.Event.DELETE and no_delete
        ):
            continue
        resp.events.append(pe)
    return resp if resp.events else None


def dropped_response(current_revision, watch_id):
    return rpc_pb2.WatchResponse(
        header=shim.header(current_revision), watch_id=watch_id, canceled=True,
        cancel_reason="etcdserver: watcher dropped (slow consumer)",
    )


def compacted_response(current_revision, compact_revision, watch_id):
    return rpc_pb2.WatchResponse(
        header=shim.header(current_revision), watch_id=watch_id,
        created=True, canceled=True,
        compact_revision=max(compact_revision, 1),
        cancel_reason="etcdserver: mvcc: required revision has been compacted",
    )


class WatchService:
    def __init__(self, backend: Backend, peers=None, replica=None):
        self.backend = backend
        self.peers = peers
        #: follower role: watches serve from the LOCAL pipeline — the
        #: replication applier feeds the local cache + hub, so follower
        #: watchers ride the same fan-out machinery as on the leader
        self.replica = replica

    def Watch(self, request_iterator, context):
        if self.replica is not None:
            self.replica.note_served("watch")
        if self.peers is not None and not self.peers.is_leader():
            # followers serve watches from the leader's pipeline
            # (reference etcd_proxy.go:239: watch forwarding)
            forwarded = self.peers.forward_watch(request_iterator)
            if forwarded is not None:
                yield from forwarded
                return
        out: queue.Queue = queue.Queue(maxsize=1024)
        session = _WatchSession(self.backend, out, context)
        reader = threading.Thread(
            target=session.read_loop, args=(request_iterator,), daemon=True
        )
        reader.start()
        try:
            while True:
                item = out.get()
                # poisoned (a _send could not deliver in order): stop
                # BEFORE yielding, so the wire sequence stays a strict
                # PREFIX of the enqueued order — truncation is harmless
                # (clients resume from their last delivered revision),
                # an internal gap is not (docs/replication.md)
                if item is None or session.poisoned:
                    return
                yield item
        finally:
            session.close()

    def _sentinel(self):  # pragma: no cover
        pass


class _WatchSession:
    def __init__(self, backend: Backend, out: queue.Queue, context):
        self.backend = backend
        self.out = out
        self.context = context
        self._lock = threading.Lock()
        self._watches: dict[int, tuple[int, threading.Event]] = {}  # watch_id -> (hub wid, stop)
        self._next_id = 0
        self._closed = False
        #: set when a response could not be enqueued in order: the stream
        #: writer truncates at its next pop instead of delivering past an
        #: invisible gap (set-once, read without the lock)
        self.poisoned = False

    # --------------------------------------------------------------- requests
    def read_loop(self, request_iterator) -> None:
        try:
            for req in request_iterator:
                which = req.WhichOneof("request_union")
                if which == "create_request":
                    self._create(req.create_request)
                elif which == "cancel_request":
                    self._cancel(req.cancel_request.watch_id, "watch cancelled by client")
                elif which == "progress_request":
                    self._send(
                        rpc_pb2.WatchResponse(
                            header=shim.header(self.backend.current_revision()),
                            watch_id=-1,
                        )
                    )
                    # ordered per-watch progress marks (docs/replication.md):
                    # the out-of-band -1 header above can overtake event
                    # batches still in the per-watch queues, so replication
                    # watermarks ride markers through those SAME queues —
                    # a mark's revision is sound exactly because every owed
                    # event was enqueued before it
                    self._post_progress()
        except Exception:
            pass  # stream closed / client gone
        self._send(None)

    def _create(self, creq) -> None:
        with self._lock:
            self._next_id += 1
            watch_id = creq.watch_id if creq.watch_id > 0 else self._next_id
        from ..service.revision import is_list_over_watch

        if is_list_over_watch(creq.start_revision):
            # negative revision: list-over-watch range stream (watch.go:150)
            t = threading.Thread(
                target=self._range_stream, args=(creq, watch_id), daemon=True
            )
            t.start()
            return
        end = bytes(creq.range_end)
        if not end:
            end = bytes(creq.key) + b"\x00"  # single-key watch
        elif end == b"\x00":
            end = b""  # etcd convention: range_end "\0" = everything >= key
        # the created ack's header revision is read BEFORE registration: it
        # must lower-bound every event this subscription will deliver, so a
        # resume-from-ack-revision+1 client (WatchMux resume) can never
        # skip an owed event — a post-registration read races the pump
        # (docs/faults.md)
        created_rev = self.backend.current_revision()
        try:
            wid, q = self.backend.watch_range(
                bytes(creq.key), end, int(creq.start_revision)
            )
        except WatchExpiredError:
            self._send(
                compacted_response(
                    self.backend.current_revision(),
                    self.backend.compact_revision(),
                    watch_id,
                )
            )
            return
        stop = threading.Event()
        with self._lock:
            if self._closed:
                self.backend.unwatch(wid)
                return
            self._watches[watch_id] = (wid, stop)
        self._send(
            rpc_pb2.WatchResponse(
                header=shim.header(created_rev),
                watch_id=watch_id,
                created=True,
            )
        )
        no_put = rpc_pb2.WatchCreateRequest.NOPUT in creq.filters
        no_delete = rpc_pb2.WatchCreateRequest.NODELETE in creq.filters
        pump = threading.Thread(
            target=self._pump,
            args=(watch_id, wid, q, stop, bool(creq.prev_kv), no_put, no_delete,
                  bool(creq.progress_notify)),
            daemon=True,
        )
        pump.start()

    def _post_progress(self) -> None:
        """Queue a ProgressMarker for each of this session's watches at the
        sequencer's fully-flushed floor. The floor read returns -1 while
        the drainer is mid-pass — retry briefly; under sustained writes
        the events themselves advance the client's watermark, so giving up
        is only a skipped idle-time mark, never a correctness issue. A
        floor of 0 (fresh store, nothing ever written) is valid but not
        worth a mark — watermarks start at 0."""
        import time as _time

        rev = -1
        for _ in range(50):
            rev = self.backend.flushed_revision()
            if rev >= 0:
                break
            _time.sleep(0.002)
        if rev <= 0:
            return
        with self._lock:
            hub_wids = [wid for wid, _stop in self._watches.values()]
        for hw in hub_wids:
            self.backend.watcher_hub.post_progress(hw, rev)

    # ----------------------------------------------------------------- pumps
    PROGRESS_INTERVAL = 60.0  # etcd sends ~10min; apiserver only needs "periodic"

    def _pump(self, watch_id, wid, q, stop, want_prev, no_put, no_delete,
              progress_notify=False) -> None:
        import time as _time

        # lag gate: only events committed after this pump started count
        # toward the wire-lag histogram — replayed catch-up batches carry
        # their ORIGINAL commit ts (possibly minutes old) and would record
        # bogus multi-second lag on every reconnect-with-replay
        registered = _time.monotonic()
        last_sent = registered
        while not stop.is_set():
            try:
                batch = q.get(timeout=0.5)
            except queue.Empty:
                if (
                    progress_notify
                    and _time.monotonic() - last_sent >= self.PROGRESS_INTERVAL
                ):
                    # watch bookmark: bare header so the client can advance
                    # its resourceVersion without events (apiserver
                    # watchcache progress notify)
                    last_sent = _time.monotonic()
                    self._send(
                        rpc_pb2.WatchResponse(
                            header=shim.header(self.backend.current_revision()),
                            watch_id=watch_id,
                        )
                    )
                continue
            if batch is None or getattr(q, "kb_dropped", False):
                # hub dropped us (slow consumer) or backend closed: cancel
                # so the client re-watches (watcherhub.go:82-90). The
                # dropped flag is checked BEFORE every delivery so batches
                # buffered past the drop point are never sent — the
                # delivered sequence stays a prefix (the drop protocol's
                # no-invisible-gap contract, watcherhub.delete_watcher)
                self._send(dropped_response(self.backend.current_revision(), watch_id))
                self._remove(watch_id)
                return
            if isinstance(batch, ProgressMarker):
                # ordered progress mark: bare header on THIS watch id,
                # after every owed event (queue FIFO carries the proof)
                last_sent = _time.monotonic()
                self._send(
                    rpc_pb2.WatchResponse(
                        header=shim.header(batch.revision),
                        watch_id=watch_id,
                    )
                )
                continue
            resp = events_response(batch, watch_id, want_prev, no_put, no_delete)
            if resp is not None:
                last_sent = _time.monotonic()
                self._send(resp)
                if batch[0].ts >= registered:
                    # commit -> wire handoff for this watcher (the hub emits
                    # the commit -> queue point; the spread between the two
                    # is pump/backlog time)
                    emit_histogram(
                        "kb.watch.lag.seconds", last_sent - batch[0].ts,
                        point="wire",
                    )

    def _range_stream(self, creq, watch_id: int) -> None:
        """List delivered over the watch protocol (reference watcher.List,
        watch.go:204-273): PUT event batches at the snapshot revision, then a
        clean cancel."""
        from ...backend.errors import CompactedError, FutureRevisionError
        from ..service.revision import decode_list_revision

        revision = decode_list_revision(creq.start_revision)
        from ...sched import SchedOverloadError, ensure_scheduler

        try:
            rev, stream = ensure_scheduler(self.backend).list_by_stream(
                bytes(creq.key), bytes(creq.range_end), revision
            )
        except SchedOverloadError as e:
            # shed by admission control: cancel without a compact marker so
            # the client retries the same revision instead of re-listing
            self._send(
                rpc_pb2.WatchResponse(
                    header=shim.header(self.backend.current_revision()),
                    watch_id=watch_id,
                    created=True,
                    canceled=True,
                    cancel_reason=str(e),
                )
            )
            return
        except (CompactedError, FutureRevisionError) as e:
            self._send(
                rpc_pb2.WatchResponse(
                    header=shim.header(self.backend.current_revision()),
                    watch_id=watch_id,
                    created=True,
                    canceled=True,
                    compact_revision=getattr(e, "compacted", 1),
                    cancel_reason=str(e),
                )
            )
            return
        self._send(
            rpc_pb2.WatchResponse(header=shim.header(rev), watch_id=watch_id, created=True)
        )
        from ...proto import kv_pb2

        for batch in stream:
            resp = rpc_pb2.WatchResponse(header=shim.header(rev), watch_id=watch_id)
            for kv in batch:
                resp.events.append(
                    kv_pb2.Event(type=kv_pb2.Event.PUT, kv=shim.to_kv(kv))
                )
            self._send(resp)
        self._send(
            rpc_pb2.WatchResponse(
                header=shim.header(rev), watch_id=watch_id, canceled=True
            )
        )

    # -------------------------------------------------------------- plumbing
    def _cancel(self, watch_id: int, reason: str) -> None:
        self._remove(watch_id)
        self._send(
            rpc_pb2.WatchResponse(
                header=shim.header(self.backend.current_revision()),
                watch_id=watch_id,
                canceled=True,
                cancel_reason=reason,
            )
        )

    def _remove(self, watch_id: int) -> None:
        with self._lock:
            entry = self._watches.pop(watch_id, None)
        if entry:
            wid, stop = entry
            stop.set()
            self.backend.unwatch(wid)

    def _send(self, item) -> None:
        try:
            self.out.put(item, timeout=5.0)
        except queue.Full:
            # Stream writer wedged. Silently dropping one response would
            # open an invisible GAP in a delivered-in-order stream: a
            # later response (an event batch, or worse a progress mark)
            # would vouch for revisions the client never received, and a
            # resume watermark would skip them forever — the replica
            # watermark-corruption shape (docs/replication.md). Evicting
            # queued responses to fit a pill is just as gappy (the
            # consumer races the eviction and can deliver a newer queued
            # response after an older one was discarded). Poison the
            # session instead: the stream writer truncates BEFORE its
            # next delivery, so the wire sequence is a strict prefix of
            # the enqueued order — the client sees the stream end and
            # resumes from its last delivered revision, losing nothing.
            self.poisoned = True
            self.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            entries = list(self._watches.values())
            self._watches.clear()
        for wid, stop in entries:
            stop.set()
            self.backend.unwatch(wid)
