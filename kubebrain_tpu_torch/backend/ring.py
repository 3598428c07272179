"""Fixed-size watch-history cache.

Reference: pkg/backend/ring.go:31-118 — a mutex-guarded circular buffer of
events ordered by revision; ``find_events(rev)`` binary-searches and copies
the suffix with revision >= rev. Watchers that ask for a revision older than
the oldest cached event must re-list (backend/watch.go:78-84).
"""

from __future__ import annotations

import threading

from .common import WatchEvent


class RingOverflowError(Exception):
    pass


class Ring:
    """Circular buffer of events in strictly increasing revision order (the
    single sequencer is the only writer). ``find_events`` binary-searches the
    rotated array in place — no O(cache) copy under the lock at 200k events
    (a watch registration holds the hub lock while replaying)."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self._cap = capacity
        self._buf: list[WatchEvent] = []
        self._start = 0  # index of oldest
        self._evicted = False
        self._lock = threading.Lock()

    def add(self, event: WatchEvent) -> None:
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(event)
            else:
                self._buf[self._start] = event
                self._start = (self._start + 1) % self._cap
                self._evicted = True

    def has_evicted(self) -> bool:
        """True once any event has been dropped off the tail — after that,
        ``oldest_revision() - 1`` may correspond to a real, evicted event."""
        with self._lock:
            return self._evicted

    def _at(self, logical_index: int) -> WatchEvent:
        return self._buf[(self._start + logical_index) % len(self._buf)]

    def oldest_revision(self) -> int:
        """0 when empty."""
        with self._lock:
            return self._buf[self._start].revision if self._buf else 0

    def latest_revision(self) -> int:
        with self._lock:
            if not self._buf:
                return 0
            return self._buf[(self._start - 1) % len(self._buf)].revision

    def find_events(self, revision: int) -> list[WatchEvent]:
        """All cached events with event.revision >= revision, in order.

        Reference ring.go:84-118 (sort.Search + suffix copy) — binary search
        over the rotated array, copying out only the matching suffix.
        """
        with self._lock:
            n = len(self._buf)
            lo, hi = 0, n
            while lo < hi:
                mid = (lo + hi) // 2
                if self._at(mid).revision < revision:
                    lo = mid + 1
                else:
                    hi = mid
            return [self._at(i) for i in range(lo, n)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
