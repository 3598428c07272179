"""Create (insert) path.

Reference: pkg/backend/creator/naive.go:53-98. A create is the atomic write

    PutIfNotExist(revision_key, rev_value(new_rev)) + Put(object_key, value)

On CAS conflict the engine hands back the observed revision record
(``Conflict.value``), which enables two conversions without extra reads:

- the record is a **tombstone with a lower revision** — the key was deleted;
  convert create→update by CAS-ing over the tombstone (naive.go:83-86);
- the record vanished between conflict and inspection (compacted-away
  delete) — retry the create once (naive.go:70-72).

A live record means the key exists: surface ``KeyExistsError`` with the
existing revision so the etcd shim can return txn-failed + current kv.

``commit_write(user_key, revision, new_record, expected_record, obj_value,
ttl)`` is the backend's atomic record+object+watermark writer
(Backend._commit_write) — batch-based or the engine's single-call fast path.
"""

from __future__ import annotations

from .. import coder
from ..storage import CASFailedError
from .errors import FutureRevisionError, KeyExistsError

EVENTS_TTL_PREFIX = b"/events/"
EVENTS_TTL_SECONDS = 3600

#: The reference's key-pattern TTL (util.go:28-42, lease.go) — demoted to a
#: flag-gated fallback now that real leases exist (kubebrain_tpu/lease).
#: Precedence (docs/storage_engine.md): an explicit ``PutRequest.lease``
#: always wins (Backend._lease_ttl returns 0 — reaper-owned expiry); the
#: pattern applies only to lease-less writes, and only while this flag is
#: on (``--legacy-ttl-patterns``, default on for kube-apiserver compat).
LEGACY_TTL_PATTERNS = True


def ttl_for_key(user_key: bytes) -> int:
    """Key-pattern TTL fallback for writes without an explicit lease."""
    if not LEGACY_TTL_PATTERNS:
        return 0
    return EVENTS_TTL_SECONDS if user_key.startswith(EVENTS_TTL_PREFIX) else 0


def create(commit_write, user_key: bytes, value: bytes, revision: int, ttl: int | None = None) -> None:
    """Insert ``user_key``=``value`` at ``revision``; raises KeyExistsError
    (with the live revision) or propagates engine errors (incl. uncertain).
    ``ttl`` (etcd lease attachment) overrides the key-pattern TTL."""
    ttl = ttl_for_key(user_key) if ttl is None else ttl
    new_record = coder.encode_rev_value(revision)
    for _attempt in range(2):
        try:
            commit_write(user_key, revision, new_record, None, value, ttl)
            return
        except CASFailedError as e:
            observed = e.conflict.value if e.conflict else None
            if observed is None:
                # record disappeared under us (compacted delete): retry create
                continue
            try:
                old_rev, deleted = coder.decode_rev_value(observed)
            except coder.CodecError:
                raise KeyExistsError(user_key, 0) from e
            if deleted:
                if old_rev < revision:
                    # deleted key: create becomes an update over the tombstone
                    try:
                        commit_write(user_key, revision, new_record, observed,
                                     value, ttl)
                        return
                    except CASFailedError as e2:
                        # two creates raced over the same tombstone and we
                        # lost: surface the WINNER's revision (the caller
                        # fences its read floor on it — the stale old_rev
                        # would make the fence a no-op and reopen the
                        # ahead-of-floor stale read); -1 = revealed state
                        # of unknown revision, fence to the watermark
                        observed2 = e2.conflict.value if e2.conflict else None
                        if observed2 is not None:
                            try:
                                rev2, del2 = coder.decode_rev_value(observed2)
                            except coder.CodecError:
                                raise KeyExistsError(user_key, 0) from e2
                            if not del2:
                                raise KeyExistsError(user_key, rev2) from e2
                            raise FutureRevisionError(revision, rev2) from e2
                        raise FutureRevisionError(revision, -1) from e2
                # Tombstone from a delete that RACED us and drew a HIGHER
                # revision than ours: the key does not exist, so KeyExists
                # would claim a state that never was (caught by the
                # linearizability soak, tests/test_linearizability.py), and
                # committing at our stale revision would break per-key
                # revision monotonicity. Same drift-back anomaly as
                # update/delete (reference txn.go:171-175): definite,
                # retryable failure — the caller re-deals a fresh revision.
                raise FutureRevisionError(revision, old_rev) from e
            raise KeyExistsError(user_key, old_rev) from e
    raise KeyExistsError(user_key, 0)
