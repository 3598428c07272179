"""Internal key codec — the MVCC data model.

Reference: pkg/backend/coder/normal.go:26-71 and rev.go:32-47. The reference
encodes an *internal* storage key as

    magic(4B) + user_key + split_byte + big_endian_u64(revision)

so that (a) all versions of one user key are adjacent in engine key order with
revisions ascending, and (b) a dedicated *revision key* (revision == 0) sorts
immediately before the version chain and holds the latest revision + deletion
flag as its value — the CAS target for every write.

This rebuild keeps the same data model but makes two TPU-first changes:

1. The split byte is ``0x00`` instead of ``'$'``. With NUL-free user keys
   (Kubernetes registry paths always are), byte-lexicographic order of the
   *padded fixed-width* device representation equals the logical
   (user_key, revision) order, which is what lets the range-scan kernel compare
   zero-padded ``uint8[N, KEY_WIDTH]`` rows directly. Keys containing NULs are
   still encoded/decoded unambiguously (the trailing 9 bytes are fixed-width)
   but their *grouping order* relative to prefix-keys is not guaranteed, same
   caveat class as the reference's ``'$'``.
2. Batch (numpy) encode/pack helpers live in ``kubebrain_tpu_torch.ops.keys`` so the
   device block store can vectorize without per-key Python.

Revision *values* (stored under the revision key) follow the reference:
8 bytes big-endian = live revision; 9 bytes (revision + 1 flag byte) = the key
is deleted at that revision (rev.go:32-47).
"""

from __future__ import annotations

import struct

# Distinct from the reference's magic (\x57\xfb\x80\x8b) — ours is ASCII "kbT0".
MAGIC = b"kbT0"
SPLIT = 0x00
REV_WIDTH = 8
SUFFIX_WIDTH = 1 + REV_WIDTH  # split byte + big-endian u64 revision
HEADER_WIDTH = len(MAGIC)

_REV_STRUCT = struct.Struct(">Q")


class CodecError(ValueError):
    """Raised when bytes do not parse as an internal key / revision value."""


def encode_object_key(user_key: bytes, revision: int) -> bytes:
    """Internal key holding the object value at ``revision``.

    Reference: coder/normal.go:26-56 (EncodeObjectKey).
    """
    return b"".join((MAGIC, user_key, b"\x00", _REV_STRUCT.pack(revision)))


def encode_revision_key(user_key: bytes) -> bytes:
    """Internal key (revision 0) whose value is the latest-revision record.

    Reference: coder/normal.go:53 (revision key = object key at revision 0).
    """
    return encode_object_key(user_key, 0)


def decode(internal_key: bytes) -> tuple[bytes, int]:
    """Split an internal key back into (user_key, revision).

    Reference: coder/normal.go:58-71 — validates magic and split byte.
    """
    if len(internal_key) < HEADER_WIDTH + SUFFIX_WIDTH + 1:
        raise CodecError(f"internal key too short: {len(internal_key)}B")
    if internal_key[:HEADER_WIDTH] != MAGIC:
        raise CodecError("bad magic prefix")
    if internal_key[-SUFFIX_WIDTH] != SPLIT:
        raise CodecError("bad split byte")
    user_key = internal_key[HEADER_WIDTH:-SUFFIX_WIDTH]
    (revision,) = _REV_STRUCT.unpack(internal_key[-REV_WIDTH:])
    return user_key, revision


def is_internal_key(raw: bytes) -> bool:
    return (
        len(raw) > HEADER_WIDTH + SUFFIX_WIDTH
        and raw[:HEADER_WIDTH] == MAGIC
        and raw[-SUFFIX_WIDTH] == SPLIT
    )


def encode_rev_value(revision: int, deleted: bool = False) -> bytes:
    """Value stored under the revision key. Reference: coder/rev.go:20-30."""
    raw = _REV_STRUCT.pack(revision)
    return raw + b"\x01" if deleted else raw


def decode_rev_value(value: bytes) -> tuple[int, bool]:
    """Parse a revision-key value into (revision, deleted).

    Reference: coder/rev.go:32-47 — 8B = live, 9B = deleted-at-revision.
    """
    if len(value) == REV_WIDTH:
        return _REV_STRUCT.unpack(value)[0], False
    if len(value) == REV_WIDTH + 1:
        return _REV_STRUCT.unpack(value[:REV_WIDTH])[0], True
    raise CodecError(f"bad revision value length {len(value)}")


def prefix_end(prefix: bytes) -> bytes:
    """Smallest key strictly greater than every key with ``prefix``.

    Reference: pkg/backend/util.go:50 (PrefixEnd). All-0xff prefixes have no
    upper bound; we return b"" sentinel meaning "to infinity" (callers treat an
    empty end as unbounded, matching etcd's \\0 semantics for ranges).
    """
    buf = bytearray(prefix)
    for i in reversed(range(len(buf))):
        if buf[i] != 0xFF:
            buf[i] += 1
            return bytes(buf[: i + 1])
    return b""


MAX_REVISION = 2**64 - 1  # bound sentinel; real revisions start at 1


def _bound_after_all_versions(user_key: bytes) -> bytes:
    """Internal key sorting after every version row of ``user_key`` and
    before any longer/greater user key's rows."""
    return encode_object_key(user_key, MAX_REVISION)


def internal_range(start_user_key: bytes, end_user_key: bytes) -> tuple[bytes, bytes]:
    """Map a user-key range [start, end) onto internal-key space.

    The start bound is the start key's revision key (revision 0, sorts before
    all its versions); the end bound is the end key's revision key so that all
    versions of keys < end are included. Reference: pkg/backend/range.go:151.

    NUL-bearing *bounds* (etcd continuation tokens are ``last_key + b"\\0"``)
    would interleave with the NUL split byte + small-revision rows of
    ``last_key``; since stored keys are NUL-free, such a bound is canonicalized
    by truncating at the first NUL: "everything > base" for a start bound /
    "everything <= base" for an end bound — both are the position just after
    base's version chain.
    """
    if b"\x00" in start_user_key:
        base = start_user_key.split(b"\x00", 1)[0]
        lo = _bound_after_all_versions(base)
    else:
        lo = encode_revision_key(start_user_key)
    if not end_user_key:
        hi = prefix_end(MAGIC)
    elif b"\x00" in end_user_key:
        base = end_user_key.split(b"\x00", 1)[0]
        hi = _bound_after_all_versions(base)
    else:
        hi = encode_revision_key(end_user_key)
    return lo, hi
