"""Revision allocator (timestamp oracle).

Reference: pkg/backend/tso/tso.go:21-80. Two counters:

- ``deal``    — the next revision to hand out; ``deal()`` atomically
  increments and returns a fresh, unique revision (tso.go:52).
- ``commit``  — the highest revision known to be *sequenced into the event
  stream*; everything <= commit is visible to readers (tso.go:57-71).

``init(rev)`` seeds both at leader election from the storage logical clock /
election record (tso.go:73; leader.go:96-107), and ``commit`` bumps ``deal``
forward on leader transfer so a new leader never re-deals old revisions.
"""

from __future__ import annotations

import threading
import time


class TSO:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._lock = self._cond  # commit/deal share the condition's lock
        self._deal = 0
        self._commit = 0

    def deal(self) -> int:
        with self._lock:
            self._deal += 1
            return self._deal

    def deal_block(self, n: int) -> int:
        """Atomically reserve ``n`` consecutive revisions; returns the first.
        The group-commit write path (Backend.write_batch) deals one block
        per group so the whole group occupies a contiguous ring span and the
        sequencer drains it in one pass. Every revision of the block MUST be
        notified (valid, failed, or uncertain) or the sequencer stalls —
        the same contract as ``deal()``."""
        if n <= 0:
            raise ValueError(f"deal_block needs n >= 1, got {n}")
        with self._lock:
            first = self._deal + 1
            self._deal += n
            return first

    def commit(self, revision: int) -> None:
        with self._lock:
            if revision > self._commit:
                self._commit = revision
            if self._deal < self._commit:
                self._deal = self._commit
            self._cond.notify_all()

    def wait_committed(self, revision: int, timeout: float) -> bool:
        """Block until committed >= revision. Writers use this so a client
        that completed a write immediately reads its own write (the reference
        gets the same effect from its always-caught-up spin sequencer,
        backend.go:212-224)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._commit < revision:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    return self._commit >= revision
            return True

    def committed(self) -> int:
        with self._lock:
            return self._commit

    def dealt(self) -> int:
        with self._lock:
            return self._deal

    def init(self, revision: int) -> None:
        with self._lock:
            if revision > self._commit:
                self._commit = revision
            if revision > self._deal:
                self._deal = revision
