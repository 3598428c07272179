"""ReplicationStream: the follower's resumable feed from the leader.

Transport is the etcd Watch protocol itself — one whole-keyspace watch
(``prev_kv`` so follower-local watchers keep full delete fidelity) ridden
through the client's :class:`~kubebrain_tpu_torch.client.WatchMux` with resume
armed: a server-side stream reset (slow-consumer drop, fault injection,
leader restart inside the cache window) re-registers from the applied
watermark + 1 and the leader's watch cache replays the gap — no event
lost, none duplicated (the client's exactly-once resume, reused wholesale).

Watermark advancement across revision gaps: failed leader ops consume
revisions but stream nothing, so event revisions alone under-count the
applied floor. The stream sends a watch *progress request* every
``progress_interval_s``; the leader answers (per watch, through the
watcher's own queue, so ordering with in-flight events holds — see
``WatcherHub.post_progress``) with its fully-flushed floor, and the
applier advances the watermark to it.

Degradation ladder (docs/replication.md):

1. stream reset → WatchMux resume from watermark + 1 (invisible);
2. whole-stream death / injected ``repl_reset`` → reconnect + re-register
   from watermark + 1 (replayed from the leader's watch cache);
3. resume expired (watermark fell out of the cache) / terminal compacted
   cancel → RESYNC: one leader list pinned at head R, applied as a diff
   against local state (puts for changed keys, tombstones at R for
   vanished keys), compact floor moved to R — coarse, like a kube relist,
   but never wrong;
4. leader unreachable → the stream idles, lag grows, and the serving gate
   degrades to explicit-revision-only: bounded-staleness reads REFUSE
   past the bound, fences time out — refusals, not stale answers.

Counterpart of ``kubebrain_tpu/replica/stream.py``, on the port's client:
it imports ``grpc`` through it, so it runs where the front runs (the CPU).
``FollowerRole.start`` imports this module inside the call.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

from ..backend.common import TOMBSTONE, Verb, WatchEvent
from ..client import EtcdCompatClient, WatchMux
from .apply import ReplicaApplier

_RECONNECT_BACKOFF_MAX_S = 2.0


class ReplicationStream:
    def __init__(self, role, backend, plane=None, client_factory=None):
        self.role = role
        self.backend = backend
        self._plane = plane
        self._client_factory = client_factory or (
            lambda: EtcdCompatClient(role.config.leader_address,
                                     credentials=role.config.credentials))
        self.applier = ReplicaApplier(backend, role=role)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.state = "init"
        self.resets = 0          # stream teardowns this side initiated
        self.bootstraps = 0      # full bootstrap/resync passes
        self.mux_resumes = 0     # server-side resets survived via resume
        self._force_reset = False  # test hook: one deliberate reset

    def reset(self) -> None:
        """Tear the stream down at the next tick (tests/chaos tooling);
        the following pass resumes from the applied watermark + 1."""
        self._force_reset = True

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is None:
            from ..util.env import crash_guard

            self._thread = threading.Thread(
                target=crash_guard(self._run), name="kb-replica-stream",
                daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()

    def status(self) -> dict:
        return {
            "state": self.state,
            "resets": self.resets,
            "bootstraps": self.bootstraps,
            "mux_resumes": self.mux_resumes,
            "applied_events": self.applier.applied_events,
            "applied_batches": self.applier.applied_batches,
        }

    # ------------------------------------------------------------ main loop
    def _run(self) -> None:
        backoff = 0.2
        while not self._stop.is_set():
            if self._plane is not None and self._plane.leader_unreachable():
                self.state = "leader_unreachable"
                self._stop.wait(0.2)
                continue
            client = mux = None
            clean = False
            try:
                client = self._client_factory()
                if self.backend.tso.committed() == 0:
                    self.state = "bootstrapping"
                    self._bootstrap(client)
                mux = WatchMux(client, streams=1, resume=True)
                watch = mux.add(
                    b"", b"\x00",
                    start_revision=self.backend.tso.committed() + 1,
                    prev_kv=True, sink=self.applier.apply_wire_events,
                    timeout=30.0)
                if watch.cancelled:
                    # resume window expired server-side (compacted cancel):
                    # rung 3 of the ladder — full resync
                    self.state = "resync"
                    self._resync(client)
                    clean = True
                    continue
                self.state = "streaming"
                backoff = 0.2
                clean = self._tick_loop(mux, watch)
            except Exception as e:  # reconnect with backoff (rung 2)
                self.state = f"reconnecting ({type(e).__name__})"
            finally:
                base = self.mux_resumes
                if mux is not None:
                    self.mux_resumes = base + mux.resumed_total()
                    mux.close()
                if client is not None:
                    client.close()
            if not clean:
                self._stop.wait(backoff)
                backoff = min(backoff * 2.0, _RECONNECT_BACKOFF_MAX_S)

    def _tick_loop(self, mux: WatchMux, watch: Any) -> bool:
        """Progress-request ticker (and a leader-head sample for the
        role's staleness clock) + fault gates + compact sync. Returns
        True when the teardown was deliberate (no reconnect backoff)."""
        cfg = self.role.config
        next_compact_sync = time.monotonic() + cfg.compact_sync_interval_s
        while not self._stop.wait(cfg.progress_interval_s):
            if watch.cancelled:
                # terminal cancel (compacted resume point): reconnect, and
                # the registration path takes the resync rung
                return False
            if self._force_reset:
                self._force_reset = False
                self.resets += 1
                self.state = "reset (requested)"
                return True
            if self._plane is not None:
                if self._plane.repl_reset():
                    # injected replication-stream reset: tear the stream
                    # down client-side; the next pass resumes from the
                    # watermark + 1 and must lose nothing
                    self.resets += 1
                    self.state = "reset (fault injection)"
                    return True
                if self._plane.leader_unreachable():
                    self.resets += 1
                    self.state = "leader_unreachable"
                    return True
            mux.request_progress()
            self.role.sample_leader_head()
            now = time.monotonic()
            if now >= next_compact_sync:
                next_compact_sync = now + cfg.compact_sync_interval_s
                self._sync_compact()
        return True  # close() requested

    # ---------------------------------------------------- bootstrap/resync
    def _bootstrap(self, client: EtcdCompatClient) -> None:
        """Stateless cold start: one leader list pinned at head R, applied
        as creates at their mod revisions; compact floor = R (history
        below the bootstrap is honestly unservable); watch then starts at
        R + 1."""
        kvs, rev = client.list(b"", b"\x00", page=1000)
        self.applier.apply_bootstrap(kvs, rev)
        self.bootstraps += 1

    def _resync(self, client: EtcdCompatClient) -> None:
        """Rung 3: the watermark fell out of the leader's watch cache. One
        leader list at head R diffed against local state — puts for new/
        changed keys, synthesized tombstones at R for keys the leader no
        longer has (the coarse kube-relist shape: follower watchers see
        one DELETE per vanished key at R, never a silent disappearance) —
        then the compact floor moves to R over the unservable gap."""
        kvs, rev = client.list(b"", b"\x00", page=1000)
        wm = self.backend.tso.committed()
        local_kvs, _ = self.backend.scanner.range_(b"", b"", wm, 0)
        local = {kv.key: kv.revision for kv in local_kvs}
        batch = self.store_batch()
        watch_events: list[WatchEvent] = []
        for kv in kvs:
            if local.pop(kv.key, None) == kv.mod_revision:
                continue  # unchanged across the partition
            # the applier's row writer, so the row format AND the leader's
            # key-pattern TTL policy can never diverge from the streaming
            # apply path (an /events/ row resynced without its TTL would
            # ghost on the follower forever)
            self.applier._put_rows(batch, kv.key, kv.mod_revision, kv.value,
                                   deleted=False)
            watch_events.append(WatchEvent(
                revision=kv.mod_revision, verb=Verb.PUT, key=kv.key,
                value=kv.value))
        for key in local:  # vanished while we were partitioned
            self.applier._put_rows(batch, key, rev, TOMBSTONE, deleted=True)
            watch_events.append(WatchEvent(
                revision=rev, verb=Verb.DELETE, key=key))
        batch.commit()
        watch_events.sort(key=lambda e: e.revision)
        self.backend.ingest_replicated(
            [e for e in watch_events if e.revision > wm], rev)
        self.backend.set_compact_floor(rev)
        self.role.note_applied(rev, rev)
        self.bootstraps += 1

    def store_batch(self):
        return self.backend.store.begin_batch_write()

    # -------------------------------------------------------- compact sync
    def _leader_status(self) -> dict | None:
        """The leader's /status payload via the role's shared transport
        (HttpRevisionSyncer.fetch_status: http/https auto-probing + schema
        cache — one implementation for the fence and this sync);
        best-effort, None on failure."""
        try:
            return self.role._syncer.fetch_status()
        except Exception:
            return None

    def _sync_compact(self) -> None:
        """Adopt the leader's compact watermark: fetch /status, then run a
        LOCAL compaction to the same revision — followers GC their own
        version chains (replicated updates accumulate history exactly like
        the leader's), fenced by the same CompactedError refusal."""
        fetched_at = time.monotonic()
        payload = self._leader_status()
        if payload is None:
            return  # best-effort: staleness accounting copes
        rev = int(payload.get("revision", 0))
        if rev:
            self.role._note_leader_rev(rev, fetched_at)
        compacted = int(payload.get("compact_revision", 0) or 0)
        try:
            if compacted > self.backend.compact_revision():
                self.backend.compact(compacted)
        except Exception as e:
            print(f"[replica] compact sync to {compacted} failed: {e!r}",
                  file=sys.stderr)
