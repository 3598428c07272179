"""Shared group-commit executor over an engine's one-call MVCC fast paths.

The group-commit engine contract (``write_batch``; docs/writes.md) wants
one engine round trip per write GROUP. Engines whose primitives already
collapse a whole MVCC write into one call (``mvcc_write`` /
``mvcc_delete`` — the native C store via FFI, the kbstored tier via its
wire protocol) get a correct ``write_batch`` from this module: a loop of
those one-call primitives with the per-op conditional outcomes demuxed
into the shared outcome tuples. The group still wins everything above the
engine (one scheduler dispatch, one contiguous revision block, one ring
pass); the engine round trips stay per-op until the engine grows a native
grouped op (the C/wire framing is future work — the loop IS the
documented fallback shape).

Outcome vocabulary (aligned with ``ops``):

- create/update: ``("ok",)`` | ``("conflict", observed_record)`` |
  ``("drift", latest_rev)``;
- delete: ``("ok", prev, latest)`` | ``("not_found", None, latest)`` |
  ``("mismatch", prev, latest)`` | ``("drift", latest)``;
- any op: ``("uncertain", exc)`` (maybe-applied — the caller poisons the
  mirror / routes to the retry daemon) or ``("error", exc)``.

The create op carries the creator's tombstone-conversion semantics
(backend/creator.py, naive.go:53-98): put-if-not-exist, and on conflict
with a LOWER-revision tombstone a CAS over the observed record — with the
lost-race branches mapped to the same drift/conflict outcomes the
sequential creator raises.
"""

from __future__ import annotations

from .. import coder
from .errors import (
    CASFailedError,
    RevisionDriftBackError,
    StorageError,
    UncertainResultError,
)


def mvcc_write_batch(store, ops: list) -> list:
    """Execute the engine-level write-group ``ops`` via ``store``'s
    ``mvcc_write`` / ``mvcc_delete`` fast paths, one outcome per op.
    Ops apply strictly in order; a failed op never blocks later ones."""
    out: list = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "create":
                out.append(_create(store, op))
            elif kind == "update":
                out.append(_update(store, op))
            elif kind == "delete":
                out.append(store.mvcc_delete(*op[1:]))
            else:
                out.append(("error", ValueError(f"bad op kind {kind!r}")))
        except RevisionDriftBackError as e:
            out.append(("drift", e.latest))
        except UncertainResultError as e:
            out.append(("uncertain", e))
        except StorageError as e:
            out.append(("error", e))
    return out


def _update(store, op) -> tuple:
    _, rev_key, rev_val, expected, obj_key, obj_val, last_key, last_val, ttl = op
    try:
        store.mvcc_write(rev_key, rev_val, expected, obj_key, obj_val,
                         last_key, last_val, ttl)
        return ("ok",)
    except CASFailedError as e:
        return ("conflict", e.conflict.value if e.conflict else None)


def _create(store, op) -> tuple:
    _, rev_key, new_rev, rev_val, obj_key, obj_val, last_key, last_val, ttl = op
    for _attempt in range(2):
        try:
            store.mvcc_write(rev_key, rev_val, None, obj_key, obj_val,
                             last_key, last_val, ttl)
            return ("ok",)
        except CASFailedError as e:
            observed = e.conflict.value if e.conflict else None
            if observed is None:
                continue  # record vanished under us (compacted delete): retry
            try:
                old_rev, deleted = coder.decode_rev_value(observed)
            except coder.CodecError:
                return ("conflict", observed)
            if not deleted:
                return ("conflict", observed)
            if old_rev >= new_rev:
                # tombstone from a racing delete with a same-or-newer
                # revision: drift-back, definite + retryable (creator.py)
                return ("drift", old_rev)
            try:
                # deleted key: create becomes an update over the tombstone
                store.mvcc_write(rev_key, rev_val, observed, obj_key, obj_val,
                                 last_key, last_val, ttl)
                return ("ok",)
            except CASFailedError as e2:
                observed2 = e2.conflict.value if e2.conflict else None
                if observed2 is None:
                    return ("drift", -1)  # unknown winner: watermark fence
                try:
                    rev2, del2 = coder.decode_rev_value(observed2)
                except coder.CodecError:
                    return ("conflict", None)
                if not del2:
                    return ("conflict", observed2)
                return ("drift", rev2)
    return ("conflict", None)
