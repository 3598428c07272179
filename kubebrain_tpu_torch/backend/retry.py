"""Async FIFO repair of uncertain write results.

Reference: pkg/backend/retry (queue.go:23-81, retry.go:142-264). When a
distributed engine's commit times out, the write *may or may not* have
landed (``UncertainResultError``). The write path reports failure to the
client but posts an invalid event; the sequencer appends it here. This loop
then, for every queued event older than ``probe_after`` seconds:

1. re-reads the key's revision record;
2. if the record's mod revision still equals the uncertain op's revision, the
   op **did** land — but no valid event was ever emitted, so watchers and
   readers would disagree with storage. Repair: idempotently rewrite the same
   value at a *fresh* revision via CAS (retry.go:222-264), which emits a
   proper event through the normal write path;
3. otherwise the op never landed (or was already superseded) — drop it.

``min_revision()`` (retry.go:123) lower-bounds compaction: compacting past an
unresolved uncertain write could garbage-collect the very record step 2 needs.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable

from .common import Verb, WatchEvent

logger = logging.getLogger("kubebrain")

# A head event whose resolution keeps failing (persistent engine fault on one
# key) must not wedge the FIFO and pin the compaction watermark forever: after
# this many failed attempts it is dropped with a loud log (the reference makes
# exactly one attempt per tick and drops on the first definitive answer).
MAX_RESOLVE_ATTEMPTS = 8


class AsyncFifoRetry:
    def __init__(
        self,
        read_rev_record: Callable[[bytes], tuple[int, bool] | None],
        rewrite: Callable[[WatchEvent, tuple[int, bool]], None],
        check_interval: float = 1.0,
        probe_after: float = 5.0,
        max_attempts: int = MAX_RESOLVE_ATTEMPTS,
    ):
        self._read_rev_record = read_rev_record
        self._rewrite = rewrite
        self._check_interval = check_interval
        self._probe_after = probe_after
        self._max_attempts = max_attempts
        self._lock = threading.Lock()
        self._queue: deque[list] = deque()  # [event, enqueued_at, attempts]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._metrics = None

    def set_metrics(self, metrics) -> None:
        """Arm repair observability: ``kb_retry_queue_depth`` (scrape-time
        gauge) + ``kb_uncertain_repairs_total{outcome=}`` — under chaos the
        uncertain-write FIFO is a serving-path component and its progress
        must be scrape-visible (docs/faults.md)."""
        self._metrics = metrics
        if metrics is not None:
            metrics.register_gauge_fn("kb.retry.queue.depth",
                                      lambda: float(len(self)))

    def _count_outcome(self, outcome: str) -> None:
        if self._metrics is not None:
            self._metrics.emit_counter("kb.uncertain.repairs", 1,
                                       outcome=outcome)

    def append(self, event: WatchEvent) -> None:
        with self._lock:
            self._queue.append([event, time.monotonic(), 0])

    def min_revision(self) -> int:
        """Smallest unresolved uncertain revision; 0 when queue empty."""
        with self._lock:
            if not self._queue:
                return 0
            return min(entry[0].revision for entry in self._queue)

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def process_ready(self, now: float | None = None) -> int:
        """Resolve every queued event old enough to probe; returns count.

        Split out of the loop for deterministic tests (the reference drives
        this via TestUncertainRewrite, backend_test.go:1268-1386).
        """
        now = time.monotonic() if now is None else now
        resolved = 0
        while True:
            with self._lock:
                if not self._queue:
                    return resolved
                entry = self._queue[0]
                event, enqueued, attempts = entry
                if now - enqueued < self._probe_after:
                    return resolved
            # resolve BEFORE popping: while the repair is in flight the event
            # must keep fencing compaction via min_revision() (the revision
            # record _resolve reads could otherwise be GC'd under us), and an
            # engine hiccup in _resolve must not drop the event — the
            # reference queue holds the item until handled (retry.go:161-220)
            try:
                self._resolve(event)
            except Exception:
                with self._lock:
                    entry[2] = attempts + 1
                    give_up = entry[2] >= self._max_attempts
                    if give_up and self._queue and self._queue[0] is entry:
                        self._queue.popleft()
                if give_up:
                    self._count_outcome("gave_up")
                    logger.exception(
                        "uncertain-write repair for key=%r rev=%d dropped after "
                        "%d failed attempts; storage may disagree with the "
                        "event stream for this key",
                        event.key, event.revision, entry[2],
                    )
                    continue
                logger.warning(
                    "uncertain-write repair for key=%r rev=%d failed "
                    "(attempt %d/%d); will retry",
                    event.key, event.revision, entry[2], self._max_attempts,
                    exc_info=True,
                )
                return resolved  # leave at head; retry next tick
            with self._lock:
                if self._queue and self._queue[0] is entry:
                    self._queue.popleft()
            resolved += 1

    def _resolve(self, event: WatchEvent) -> None:
        record = self._read_rev_record(event.key)
        if record is None:
            # key vanished entirely: op failed or was compacted away
            self._count_outcome("dropped")
            return
        rev, deleted = record
        if rev != event.revision:
            # op never landed, or a later write superseded it: drop
            self._count_outcome("dropped")
            return
        if deleted != (event.verb == Verb.DELETE):
            self._count_outcome("dropped")
            return
        self._rewrite(event, record)
        self._count_outcome("rewritten")

    # ----------------------------------------------------------------- daemon
    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="kb-async-retry", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._check_interval):
            try:
                self.process_ready()
            except Exception:  # keep the repair loop alive, but never silently
                logger.exception("uncertain-write repair tick failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
