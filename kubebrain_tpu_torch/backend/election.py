"""Leader election anchored in the storage engine.

Reference: pkg/backend/election/election.go:49-188 + the campaign wrapper at
pkg/server/service/leader/leader.go:82-158. There is no peer consensus — the
KV engine is the source of truth: the lock is a record at a well-known key,
acquired/renewed with PutIfNotExist/CAS. The record carries the holder
identity, lease metadata, AND the storage logical clock observed at each lock
operation (reference Describe() returns "identity,tso") — the winner seeds its
revision sequencer from that clock so revisions stay monotonic across terms.

Timing mirrors the reference: lease 8s / renew every 5s / retry every 1s
(leader.go:87-91). On losing leadership the reference *panics* to clear dirty
watch state ("simple and rude", leader.go:109-118); here the campaign invokes
``on_stopped_leading`` and the server layer resets the backend term instead
(watch cache + watcher hub are wiped — same observable contract: watchers are
cancelled and clients must re-list).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..storage import CASFailedError, KvStorage
from ..storage.errors import KeyNotFoundError
from ..util.env import crash_guard
from .common import ELECTION_KEY

logger = logging.getLogger("kubebrain")

LEASE_SECONDS = 8.0
RENEW_INTERVAL = 5.0
RETRY_INTERVAL = 1.0


@dataclass
class LockRecord:
    holder: str
    acquired_at: float
    renewed_at: float
    lease_seconds: float
    tso: int  # storage logical clock at the last lock op
    meta: dict | None = None  # holder-published metadata (e.g. client address)

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "LockRecord":
        payload = json.loads(raw.decode())
        payload.setdefault("meta", None)
        return cls(**payload)

    def expired(self, now: float) -> bool:
        return now - self.renewed_at > self.lease_seconds


class ResourceLock:
    """CAS lock record manager (reference NewResourceLockManager,
    election.go:49-188)."""

    def __init__(
        self,
        store: KvStorage,
        identity: str,
        key: bytes = ELECTION_KEY,
        meta: dict | None = None,
    ):
        self._store = store
        self.identity = identity
        self._key = key
        self.meta = meta or {}

    def get(self) -> LockRecord | None:
        try:
            return LockRecord.from_bytes(self._store.get(self._key))
        except KeyNotFoundError:
            return None

    def create(self, now: float | None = None, lease_seconds: float = LEASE_SECONDS) -> LockRecord:
        now = time.time() if now is None else now
        record = LockRecord(
            holder=self.identity, acquired_at=now, renewed_at=now,
            lease_seconds=lease_seconds, tso=self._store.get_timestamp_oracle(),
            meta=self.meta,
        )
        batch = self._store.begin_batch_write()
        batch.put_if_not_exist(self._key, record.to_bytes())
        batch.commit()
        return record

    def update(self, old: LockRecord, new: LockRecord) -> LockRecord:
        new.tso = max(self._store.get_timestamp_oracle(), old.tso)
        batch = self._store.begin_batch_write()
        batch.cas(self._key, new.to_bytes(), old.to_bytes())
        batch.commit()
        return new


class LeaderElection:
    """Campaign loop (reference leader.go:82-158 over k8s leaderelection)."""

    def __init__(
        self,
        lock: ResourceLock,
        on_started_leading: Callable[[int], None] | None = None,
        on_stopped_leading: Callable[[], None] | None = None,
        lease_seconds: float = LEASE_SECONDS,
        renew_interval: float = RENEW_INTERVAL,
        retry_interval: float = RETRY_INTERVAL,
    ):
        self._lock = lock
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._lease = lease_seconds
        self._renew = renew_interval
        self._retry = retry_interval
        self._stop = threading.Event()
        self._is_leader = threading.Event()
        self._thread: threading.Thread | None = None
        self._current: LockRecord | None = None

    # ----------------------------------------------------------------- queries
    def is_leader(self) -> bool:
        return self._is_leader.is_set()

    def leader_identity(self) -> str | None:
        rec = self._lock.get()
        if rec is None:
            return None
        if rec.expired(time.time()):
            return None
        return rec.holder

    def wait_for_leadership(self, timeout: float) -> bool:
        return self._is_leader.wait(timeout)

    # ---------------------------------------------------------------- campaign
    def try_acquire_once(self, now: float | None = None) -> bool:
        """One acquire/renew attempt; True iff we hold the lock afterwards.

        Any storage error — CAS loss, uncertain result, engine/network
        failure, even a malformed lock record — means we could NOT prove we
        hold the lock, so we must report not-leader. Treating an error as
        anything else risks two concurrent leaders: the reference's
        leaderelection machinery likewise treats renew errors as lease loss
        (leader.go:109-118 panics on loss).
        """
        now = time.time() if now is None else now
        try:
            rec = self._lock.get()
            if rec is None:
                self._current = self._lock.create(now, lease_seconds=self._lease)
                return True
            if rec.holder == self._lock.identity:
                new = LockRecord(
                    holder=rec.holder, acquired_at=rec.acquired_at,
                    renewed_at=now, lease_seconds=self._lease, tso=rec.tso,
                    meta=self._lock.meta,
                )
                self._current = self._lock.update(rec, new)
                return True
            if rec.expired(now):
                new = LockRecord(
                    holder=self._lock.identity, acquired_at=now,
                    renewed_at=now, lease_seconds=self._lease, tso=rec.tso,
                    meta=self._lock.meta,
                )
                self._current = self._lock.update(rec, new)
                return True
            return False
        except CASFailedError:
            return False
        except Exception:
            logger.exception("lock op failed for %s; assuming not leader", self._lock.identity)
            return False

    def campaign(self) -> None:
        self._thread = threading.Thread(
            target=crash_guard(self._loop), name="kb-campaign", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.try_acquire_once():
                start_rev = self._current.tso if self._current else 0
                self._is_leader.set()
                if self._on_started:
                    self._on_started(start_rev)
                self._hold()
            else:
                self._stop.wait(self._retry)

    def _hold(self) -> None:
        while not self._stop.wait(self._renew):
            if not self.try_acquire_once():
                break
        self._is_leader.clear()
        if self._on_stopped and not self._stop.is_set():
            self._on_stopped()

    def resign(self) -> None:
        self._is_leader.clear()

    def close(self) -> None:
        self._stop.set()
        self._is_leader.clear()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class StubLeaderElection:
    """Always-leader stub for single-node servers and tests
    (reference pkg/server/service/leader/stub.go:19-39)."""

    def __init__(self, identity: str = "stub", leader: bool = True):
        self.identity = identity
        self._leader = leader

    def is_leader(self) -> bool:
        return self._leader

    def leader_identity(self) -> str | None:
        return self.identity if self._leader else None

    def wait_for_leadership(self, timeout: float) -> bool:
        return self._leader

    def campaign(self) -> None:
        pass

    def close(self) -> None:
        pass
