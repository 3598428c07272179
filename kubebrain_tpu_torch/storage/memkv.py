"""In-memory versioned sorted-map engine — the deterministic test fake.

Reference: pkg/storage/memkv (skiplist.go:30, batch.go, iter.go). Differences
by design:

- The logical clock is a commit counter, not wall-clock ns (skiplist.go:57) —
  deterministic tests.
- Snapshot isolation is real: every committed batch gets one timestamp and
  every key keeps its version history, so an ``iter`` at snapshot S never
  observes a commit > S (the reference fakes this with a whole-store mutex
  held across the batch, skiplist.go:82-85).
- Partitions are configurable via ``split_points`` so partition-parallel scans
  and border adjustment are testable without a distributed engine — the role
  the mock TiKV cluster plays in the reference tests (backend_test.go:171-178).
"""

from __future__ import annotations

import bisect
import threading
import time

from . import BatchWrite, Iter, KvStorage, Partition, register_engine
from .errors import CASFailedError, Conflict, KeyNotFoundError

_PUT_IF_NOT_EXIST = 0
_CAS = 1
_PUT = 2
_DEL = 3
_DEL_CURRENT = 4


class _Version:
    __slots__ = ("ts", "value", "expire_at")

    def __init__(self, ts: int, value: bytes | None, expire_at: float):
        self.ts = ts
        self.value = value  # None == engine-level deletion
        self.expire_at = expire_at  # 0.0 == no TTL


class MemKv(KvStorage):
    def __init__(
        self,
        split_points: list[bytes] | None = None,
        ttl_supported: bool = True,
    ):
        self._lock = threading.RLock()
        self._keys: list[bytes] = []  # sorted index of every key ever written
        self._versions: dict[bytes, list[_Version]] = {}
        self._ts = 0
        self._split_points = sorted(split_points or [])
        self._ttl_supported = ttl_supported

    # ------------------------------------------------------------- clock/shards
    def get_timestamp_oracle(self) -> int:
        with self._lock:
            return self._ts

    def get_partitions(self, start: bytes, end: bytes) -> list[Partition]:
        borders = [start]
        for sp in self._split_points:
            if start < sp and (not end or sp < end):
                borders.append(sp)
        borders.append(end)
        return [Partition(borders[i], borders[i + 1]) for i in range(len(borders) - 1)]

    # ------------------------------------------------------------------- reads
    def _live_value(self, key: bytes, snapshot_ts: int | None, now: float) -> bytes | None:
        """Latest value at the snapshot, honoring TTL; None if absent/deleted."""
        versions = self._versions.get(key)
        if not versions:
            return None
        ts = self._ts if snapshot_ts is None else snapshot_ts
        for v in reversed(versions):
            if v.ts <= ts:
                if v.value is None:
                    return None
                if self._ttl_supported and v.expire_at and now >= v.expire_at:
                    return None
                return v.value
        return None

    def get(self, key: bytes, snapshot_ts: int | None = None) -> bytes:
        with self._lock:
            val = self._live_value(key, snapshot_ts, time.time())
            if val is None:
                raise KeyNotFoundError(key)
            return val

    def iter(
        self,
        start: bytes,
        end: bytes,
        snapshot_ts: int | None = None,
        limit: int = 0,
    ) -> Iter:
        reverse = bool(end) and start > end
        with self._lock:
            now = time.time()
            ts = self._ts if snapshot_ts is None else snapshot_ts
        return _LazyIter(self, start, end, ts, now, limit, reverse)

    # ------------------------------------------------------------------ writes
    def begin_batch_write(self) -> BatchWrite:
        return _MemBatch(self)

    def write_batch(self, ops: list) -> list:
        """Grouped MVCC commit under ONE store-lock acquisition with per-op
        conditional demux (the group-commit engine contract,
        docs/writes.md). ``ops`` is a list of

        - ``("create", rev_key, new_rev, rev_val, obj_key, obj_val,
          last_key, last_val, ttl)``
        - ``("update", rev_key, rev_val, expected, obj_key, obj_val,
          last_key, last_val, ttl)``
        - ``("delete", rev_key, expected_rev, new_rev, new_record,
          tombstone, last_key, last_val)``

        Each op validates against the state as mutated by earlier ops in
        the SAME group and either applies atomically (its own commit
        timestamp, exactly like a sequential batch commit) or fails alone.
        Outcomes, aligned with ``ops``:

        - create/update: ``("ok",)`` or ``("conflict", observed_record)``
          or ``("drift", latest_rev)`` (create over a same-or-newer
          tombstone);
        - delete: the ``mvcc_delete`` quadruple —
          ``("ok", prev_value, latest_rev)`` / ``("not_found", None,
          latest_rev)`` / ``("mismatch", prev_value, latest_rev)`` /
          ``("drift", latest_rev)``.

        The create op resolves the creator's tombstone-conversion branch
        in-engine (naive.go:83-86): under the store lock there is no
        read-then-CAS race, so the two-attempt loop collapses to a branch.
        Record parsing uses the shared MVCC codec — the same format the
        native engine's C `kb_mvcc_delete` parses."""
        from .. import coder

        out: list = []
        with self._lock:
            now = time.time()
            for op in ops:
                kind = op[0]
                if kind == "create":
                    out.append(self._wb_create(op, now, coder))
                elif kind == "update":
                    out.append(self._wb_update(op, now))
                elif kind == "delete":
                    out.append(self._wb_delete(op, now, coder))
                else:
                    out.append(("error", ValueError(f"bad op kind {kind!r}")))
        return out

    def _wb_apply(self, puts: list[tuple[bytes, bytes, int]], now: float) -> None:
        """One successful group member = one commit timestamp (identical to
        a sequential ``begin_batch_write().commit()``); TTL is per row —
        the record and object rows carry the member's TTL, the watermark
        row never does, exactly like ``Backend._commit_write``."""
        self._ts += 1
        for key, value, ttl in puts:
            expire_at = now + ttl if ttl else 0.0
            self._append(key, _Version(self._ts, value, expire_at))

    def _wb_create(self, op, now: float, coder):
        _, rev_key, new_rev, rev_val, obj_key, obj_val, last_key, last_val, ttl = op
        cur = self._live_value(rev_key, None, now)
        if cur is not None:
            try:
                old_rev, deleted = coder.decode_rev_value(cur)
            except coder.CodecError:
                return ("conflict", cur)
            if not deleted:
                return ("conflict", cur)
            if old_rev >= new_rev:
                return ("drift", old_rev)
            # deleted at a lower revision: create becomes an update over the
            # tombstone (creator conversion, resolved in-engine)
        self._wb_apply([(rev_key, rev_val, ttl), (obj_key, obj_val, ttl),
                        (last_key, last_val, 0)], now)
        return ("ok",)

    def _wb_update(self, op, now: float):
        _, rev_key, rev_val, expected, obj_key, obj_val, last_key, last_val, ttl = op
        cur = self._live_value(rev_key, None, now)
        if cur != expected:
            return ("conflict", cur)
        self._wb_apply([(rev_key, rev_val, ttl), (obj_key, obj_val, ttl),
                        (last_key, last_val, 0)], now)
        return ("ok",)

    def _wb_delete(self, op, now: float, coder):
        _, rev_key, expected_rev, new_rev, new_record, tombstone, last_key, last_val = op
        cur = self._live_value(rev_key, None, now)
        if cur is None:
            return ("not_found", None, 0)
        try:
            latest, deleted = coder.decode_rev_value(cur)
        except coder.CodecError:
            return ("not_found", None, 0)
        if deleted:
            return ("not_found", None, latest)
        ukey, _ = coder.decode(rev_key)
        prev = self._live_value(coder.encode_object_key(ukey, latest), None, now)
        if expected_rev and latest != expected_rev:
            return ("mismatch", prev, latest)
        if new_rev <= latest:
            return ("drift", latest)
        self._wb_apply([(rev_key, new_record, 0),
                        (coder.encode_object_key(ukey, new_rev), tombstone, 0),
                        (last_key, last_val, 0)], now)
        return ("ok", prev, latest)

    def mvcc_delete(self, rev_key: bytes, expected_rev: int, new_rev: int,
                    new_record: bytes, tombstone: bytes, last_key: bytes,
                    last_val: bytes) -> tuple:
        """One-call read-validate-tombstone delete (the native engine's
        ``kb_mvcc_delete`` contract) — the sequential delete then takes
        ``Backend._delete_fast``, where a failed delete consumes its dealt
        revision exactly like a failed group member, so grouped and
        sequential revision streams stay byte-identical on this engine."""
        from .. import coder
        from .errors import RevisionDriftBackError

        with self._lock:
            out = self._wb_delete(
                ("delete", rev_key, expected_rev, new_rev, new_record,
                 tombstone, last_key, last_val), time.time(), coder)
        if out[0] == "drift":
            raise RevisionDriftBackError(
                f"revision drift on delete (latest {out[1]})", latest=out[1])
        return out

    def _commit(self, ops: list[tuple]) -> None:
        with self._lock:
            now = time.time()
            # Validate all conditional ops against latest state first
            # (all-or-nothing; reference memkv serializes batches under the
            # store mutex, batch.go:146-167).
            for idx, op in enumerate(ops):
                kind, key = op[0], op[1]
                cur = self._live_value(key, None, now)
                if kind == _PUT_IF_NOT_EXIST and cur is not None:
                    raise CASFailedError(Conflict(idx, key, cur))
                if kind == _CAS and cur != op[3]:
                    raise CASFailedError(Conflict(idx, key, cur))
                if kind == _DEL_CURRENT and cur != op[2]:
                    raise CASFailedError(Conflict(idx, key, cur))
            self._ts += 1
            ts = self._ts
            for op in ops:
                kind, key = op[0], op[1]
                if kind in (_PUT_IF_NOT_EXIST, _CAS, _PUT):
                    value, ttl = op[2], op[-1]
                    expire_at = now + ttl if ttl else 0.0
                    self._append(key, _Version(ts, value, expire_at))
                else:  # _DEL / _DEL_CURRENT
                    self._append(key, _Version(ts, None, 0.0))

    def _append(self, key: bytes, version: _Version) -> None:
        if key not in self._versions:
            self._versions[key] = []
            bisect.insort(self._keys, key)
        self._versions[key].append(version)

    def bulk_gc(self, vkeys, vlens, vrevs, rkeys, rlens, rrevs, rtomb) -> int:
        """Compaction fast path mirroring the native engine's contract
        (native.py:bulk_gc): delete every victim object row and CAS-guarded
        revision record under ONE lock acquisition with one commit
        timestamp — the same logical deletions the per-victim batch path
        produces (MVCC deletion markers, hidden from iter/get, physically
        freed by prune_versions), without a one-op batch commit per
        revision record. Arrays: uint8[N, W] fixed-width user keys +
        lens + uint64 revs; ``rtomb`` marks records whose expected value
        carries the deletion flag. Returns the number of revision records
        deleted (CAS mismatches skip, exactly like ``del_current``)."""
        import numpy as np

        from .. import coder

        vlens = np.asarray(vlens, dtype=np.int64)
        rlens = np.asarray(rlens, dtype=np.int64)
        deleted = 0
        with self._lock:
            now = time.time()
            self._ts += 1
            marker = _Version(self._ts, None, 0.0)
            for j in range(len(vlens)):
                uk = vkeys[j, : vlens[j]].tobytes()
                self._append(coder.encode_object_key(uk, int(vrevs[j])), marker)
            for j in range(len(rlens)):
                uk = rkeys[j, : rlens[j]].tobytes()
                rkey = coder.encode_revision_key(uk)
                expected = coder.encode_rev_value(
                    int(rrevs[j]), deleted=bool(rtomb[j]))
                if self._live_value(rkey, None, now) != expected:
                    continue  # rewritten since the caller's snapshot
                self._append(rkey, marker)
                deleted += 1
        return deleted

    # --------------------------------------------------------------- lifecycle
    def prune_versions(self, keep_after_ts: int) -> int:
        """Physically free history invisible to snapshots >= keep_after_ts
        (same contract as the native engine's kb_prune)."""
        freed = 0
        with self._lock:
            now = time.time()
            dead_keys: set[bytes] = set()
            for key in list(self._versions):
                versions = self._versions[key]
                last_visible = None
                for i, v in enumerate(versions):
                    if v.ts <= keep_after_ts:
                        last_visible = i
                if last_visible:
                    del versions[:last_visible]
                    freed += last_visible
                dead = all(
                    v.ts <= keep_after_ts
                    and (v.value is None
                         or (self._ttl_supported and v.expire_at and now >= v.expire_at))
                    for v in versions
                )
                if dead and versions:
                    freed += len(versions)
                    del self._versions[key]
                    dead_keys.add(key)
            if dead_keys:
                # ONE filtered rebuild of the sorted key list: a per-key
                # `del self._keys[idx]` is an O(n) memmove each, which a
                # compaction GC'ing ~half a million whole chains turns
                # into minutes of pure list surgery (O(dead · n))
                self._keys = [k for k in self._keys if k not in dead_keys]
        return freed

    def version_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._versions.values())

    def support_ttl(self) -> bool:
        return self._ttl_supported

    def close(self) -> None:
        with self._lock:
            self._keys.clear()
            self._versions.clear()


class _LazyIter(Iter):
    """Streaming snapshot iterator: each ``next()`` advances a *key-based*
    cursor under the store lock, so the engine never materializes the whole
    range up front (the reference iterates the skiplist lazily, iter.go).
    The snapshot timestamp pins visibility against concurrent COMMITS; like
    the native engine, ``prune_versions(keep_after_ts)`` only preserves
    history for snapshots >= its watermark — an iterator pinned BELOW a
    later prune watermark may observe pruned keys vanish mid-scan (callers
    hold the compaction fence for exactly this reason, backend/retry.py)."""

    def __init__(self, store: "MemKv", start: bytes, end: bytes, ts: int,
                 now: float, limit: int, reverse: bool):
        self._store = store
        self._start = start
        self._end = end
        self._ts = ts
        self._now = now
        self._limit = limit
        self._reverse = reverse
        self._cursor: bytes | None = None  # last key returned or skipped
        self._emitted = 0

    def _next_pos(self, keys: list[bytes]) -> int | None:
        if self._reverse:
            # reverse contract: end <= k <= start, descending
            if self._cursor is None:
                pos = bisect.bisect_right(keys, self._start) - 1
            else:
                pos = bisect.bisect_left(keys, self._cursor) - 1
            if pos < 0 or keys[pos] < self._end:
                return None
            return pos
        if self._cursor is None:
            pos = bisect.bisect_left(keys, self._start)
        else:
            pos = bisect.bisect_right(keys, self._cursor)
        if pos >= len(keys) or (self._end and keys[pos] >= self._end):
            return None
        return pos

    def next(self) -> tuple[bytes, bytes]:
        if self._limit and self._emitted >= self._limit:
            raise StopIteration
        store = self._store
        with store._lock:
            while True:
                pos = self._next_pos(store._keys)
                if pos is None:
                    raise StopIteration
                k = store._keys[pos]
                self._cursor = k
                val = store._live_value(k, self._ts, self._now)
                if val is not None:
                    self._emitted += 1
                    return (k, val)


class _MemBatch(BatchWrite):
    def __init__(self, store: MemKv):
        self._store = store
        self._ops: list[tuple] = []

    def put_if_not_exist(self, key: bytes, value: bytes, ttl_seconds: int = 0) -> None:
        self._ops.append((_PUT_IF_NOT_EXIST, key, value, ttl_seconds))

    def cas(self, key: bytes, new_value: bytes, old_value: bytes, ttl_seconds: int = 0) -> None:
        self._ops.append((_CAS, key, new_value, old_value, ttl_seconds))

    def put(self, key: bytes, value: bytes, ttl_seconds: int = 0) -> None:
        self._ops.append((_PUT, key, value, ttl_seconds))

    def delete(self, key: bytes) -> None:
        self._ops.append((_DEL, key))

    def del_current(self, key: bytes, expected_value: bytes) -> None:
        self._ops.append((_DEL_CURRENT, key, expected_value))

    def commit(self) -> None:
        self._store._commit(self._ops)
        self._ops = []


register_engine("memkv", MemKv)
