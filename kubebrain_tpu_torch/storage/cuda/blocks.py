"""Device-resident sorted block mirror of the MVCC keyspace.

Counterpart of ``kubebrain_tpu/storage/tpu/blocks.py``. The authoritative
store stays on the host; the scan-hot columns (packed user key, revision,
tombstone flag) are mirrored into GPU memory as P sorted partitions padded
to a common row count. Values never leave the host: the kernels decide
*which* rows are visible, and the host materializes bytes by row index from
per-partition byte arenas.

The device columns are held in the layout the visibility kernels read
(``ops/scan.py``): keys int32[P, C, N] chunk-major and sign-flipped,
revisions int64[P, N], tombstones int8[P, N]. It is built once per publish.
Partition borders are user-key-aligned, so no version chain straddles two
partitions and the kernels need no carry between them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops import keys as keyops
from ...ops.scan import prepare_layout
from .encode import KeyEncoding, build_encoding

TTL_PREFIX = b"/events/"


@dataclass
class Mirror:
    # device, in the kernel layout. With a live ``encoding`` the key columns
    # hold ENCODED rows (storage/cuda/encode.py) whose lexicographic order
    # equals raw byte order; ``lens_host`` then holds encoded-suffix lengths.
    keys_dev: torch.Tensor     # int32[P, C, N] chunk-major, sign-flipped
    revs_dev: torch.Tensor     # int64[P, N]
    tomb_dev: torch.Tensor     # int8[P, N]
    n_valid_dev: torch.Tensor  # int32[P]
    # host copies (row-aligned with the device arrays)
    keys_host: np.ndarray   # uint32[P, N, C]
    lens_host: np.ndarray   # int32[P, N]
    revs_host: np.ndarray   # uint64[P, N]
    tomb_host: np.ndarray   # bool[P, N]
    n_valid: np.ndarray     # int32[P]
    # values: one byte arena + offsets per partition
    val_arena: list[np.ndarray]    # uint8[...]
    val_offsets: list[np.ndarray]  # uint64[nv+1]
    snapshot_ts: int
    max_rev: int
    key_width: int = 0              # RAW packed key width (bytes)
    encoding: KeyEncoding | None = None
    ttl_host: np.ndarray | None = None  # bool[P, N]

    @property
    def partitions(self) -> int:
        return self.keys_host.shape[0]

    @property
    def rows(self) -> int:
        return int(self.n_valid.sum())

    @property
    def raw_key_width(self) -> int:
        return self.key_width or self.keys_host.shape[2] * 4

    def user_key(self, p: int, i: int) -> bytes:
        if self.encoding is not None:
            return self.encoding.decode_one(
                self.keys_host[p, i], int(self.lens_host[p, i]))
        row = keyops.chunks_to_u8(self.keys_host[p, i : i + 1])[0]
        return row[: int(self.lens_host[p, i])].tobytes()

    def decoded_keys(self, p: int, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(raw_u8, raw_lens) for row indices of one partition — the one
        decode funnel: encoded key bytes turn back into raw bytes only here,
        for the caller's visible rows."""
        if self.encoding is not None:
            return self.encoding.decode_rows(
                self.keys_host[p][rows], self.lens_host[p][rows])
        return (keyops.chunks_to_u8(self.keys_host[p][rows]),
                self.lens_host[p][rows])

    def materialize(self, p: int, rows: np.ndarray):
        """Bulk (keys, values, revisions) for sorted row indices of one
        partition."""
        k_u8, k_lens = self.decoded_keys(p, rows)
        keys = [k_u8[i, : int(k_lens[i])].tobytes() for i in range(len(k_u8))]
        o = self.val_offsets[p].astype(np.int64)
        arena = self.val_arena[p]
        values = [arena[o[i] : o[i + 1]].tobytes() for i in map(int, rows)]
        revs = self.revs_host[p][rows]
        return keys, values, revs

    def partition_first_keys(self) -> list[bytes]:
        return [
            self.user_key(p, 0) if self.n_valid[p] > 0 else b""
            for p in range(self.partitions)
        ]


def rows_to_arrays(rows: list[tuple[bytes, int, bytes]], width: int):
    """Python (user_key, rev, value) rows → the array sextuple
    ``(keys_u8, lens, revs, tomb, arena, offsets)``."""
    from ...backend.common import TOMBSTONE

    n = len(rows)
    keys_u8 = np.zeros((n, width), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    revs = np.zeros(n, dtype=np.uint64)
    tomb = np.zeros(n, dtype=bool)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    chunks_vals = []
    off = 0
    for i, (k, rev, v) in enumerate(rows):
        keys_u8[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
        lens[i] = len(k)
        revs[i] = rev
        tomb[i] = v == TOMBSTONE
        chunks_vals.append(v)
        off += len(v)
        offsets[i + 1] = off
    arena = (np.frombuffer(b"".join(chunks_vals), dtype=np.uint8).copy()
             if rows else np.zeros(0, np.uint8))
    return keys_u8, lens, revs, tomb, arena, offsets


def merge_sorted_arrays(a, b):
    """Merge two RAW row-array sextuples into one sorted by (key, revision):
    one stable argsort over ``key || big-endian revision`` compared as
    void scalars (memcmp order)."""
    keys_u8 = np.concatenate([a[0], b[0]])
    lens = np.concatenate([a[1], b[1]])
    revs = np.concatenate([a[2], b[2]])
    tomb = np.concatenate([a[3], b[3]])
    n, w = keys_u8.shape
    rev_be = revs[:, None].astype(">u8").view(np.uint8).reshape(n, 8)
    sort_rows = np.ascontiguousarray(np.concatenate([keys_u8, rev_be], axis=1))
    perm = np.argsort(sort_rows.view([("v", f"V{w + 8}")]).reshape(n),
                      kind="stable")
    arena = np.concatenate([a[4], b[4]])
    offsets = np.concatenate([
        a[5].astype(np.int64)[:-1],
        b[5].astype(np.int64)[:-1] + len(a[4]),
        np.array([len(arena)], dtype=np.int64),
    ]).astype(np.uint64)
    new_arena, new_offsets = keyops.gather_arena(arena, offsets, perm)
    return keys_u8[perm], lens[perm], revs[perm], tomb[perm], new_arena, new_offsets


def padded_capacity(count: int) -> int:
    """Row capacity for a partition holding ``count`` rows: the next power
    of two past 1.25x headroom (at least 256)."""
    want = max(256, int(count * 1.25) + 1)
    cap = 256
    while cap < want:
        cap *= 2
    return cap


def compute_ttl_flags(keys_u8: np.ndarray, lens: np.ndarray) -> np.ndarray:
    ttl_pref = np.frombuffer(TTL_PREFIX, dtype=np.uint8)
    if len(keys_u8) == 0:
        return np.zeros(0, dtype=bool)
    pref = keys_u8[:, : len(ttl_pref)]
    return (pref == ttl_pref).all(axis=1) & (lens >= len(ttl_pref))


def _upload(keys_h, revs_h, tomb_h, n_valid, device):
    """Host row-major columns → the device kernel layout."""
    keys_t, revs, tomb8 = prepare_layout(keys_h, revs_h, tomb_h)
    put = lambda a: torch.from_numpy(a).to(device)
    return put(keys_t), put(revs), put(tomb8), put(np.asarray(n_valid, np.int32))


def build_mirror_from_arrays(
    keys_u8: np.ndarray,
    lens: np.ndarray,
    revs: np.ndarray,
    tomb: np.ndarray,
    arena: np.ndarray,
    offsets: np.ndarray,
    device,
    key_width: int,
    snapshot_ts: int,
    n_parts: int | None = None,
    encode: bool = False,
) -> Mirror:
    """Sorted RAW row arrays → partitioned, padded, device-resident Mirror.

    ``n_parts`` partitions (default 1) split at user-key boundaries.
    ``encode=True`` builds an order-preserving prefix dictionary from the
    snapshot keys (storage/cuda/encode.py) and stores ENCODED rows, so the
    device key column shrinks from ``key_width`` to ``encoding.width`` bytes
    per row while every kernel compare stays byte-order-exact."""
    n_parts = n_parts or 1
    n = len(keys_u8)
    if keys_u8.shape[1] != key_width:
        padded = np.zeros((n, key_width), dtype=np.uint8)
        padded[:, : keys_u8.shape[1]] = keys_u8[:, :key_width]
        keys_u8 = padded

    encoding = build_encoding(keys_u8, lens, raw_width=key_width) \
        if (encode and n) else None
    if encoding is not None:
        store_u8, store_lens = encoding.encode_keys(keys_u8, lens)
        store_width = encoding.width
    else:
        store_u8, store_lens, store_width = keys_u8, lens, key_width

    # user-key-aligned balanced split offsets (vectorized boundary detect)
    if n:
        same_prev = np.zeros(n, dtype=bool)
        same_prev[1:] = (keys_u8[1:] == keys_u8[:-1]).all(axis=1)
    splits = [0]
    target = max(1, (n + n_parts - 1) // n_parts)
    for p in range(1, n_parts):
        pos = min(p * target, n)
        while 0 < pos < n and same_prev[pos]:
            pos += 1
        splits.append(max(pos, splits[-1]))
    splits.append(n)
    counts = [splits[i + 1] - splits[i] for i in range(n_parts)]
    n_max = padded_capacity(max(counts) if counts else 0)

    c = store_width // 4
    keys_h = np.zeros((n_parts, n_max, c), dtype=np.uint32)
    lens_h = np.zeros((n_parts, n_max), dtype=np.int32)
    revs_h = np.zeros((n_parts, n_max), dtype=np.uint64)
    tomb_h = np.zeros((n_parts, n_max), dtype=bool)
    ttl_h = np.zeros((n_parts, n_max), dtype=bool)
    arenas, offs = [], []
    off64 = offsets.astype(np.int64)
    for p in range(n_parts):
        lo, hi = splits[p], splits[p + 1]
        nv = hi - lo
        if nv:
            keys_h[p, :nv] = keyops.bytes_to_chunks(store_u8[lo:hi])
            lens_h[p, :nv] = store_lens[lo:hi]
            revs_h[p, :nv] = revs[lo:hi]
            tomb_h[p, :nv] = tomb[lo:hi]
            ttl_h[p, :nv] = compute_ttl_flags(keys_u8[lo:hi], lens[lo:hi])
        arenas.append(arena[off64[lo] : off64[hi]].copy())
        offs.append((off64[lo : hi + 1] - off64[lo]).astype(np.uint64))
    n_valid = np.array(counts, dtype=np.int32)

    keys_d, revs_d, tomb_d, nv_d = _upload(keys_h, revs_h, tomb_h, n_valid, device)
    return Mirror(
        keys_dev=keys_d, revs_dev=revs_d, tomb_dev=tomb_d, n_valid_dev=nv_d,
        keys_host=keys_h, lens_host=lens_h, revs_host=revs_h, tomb_host=tomb_h,
        n_valid=n_valid, val_arena=arenas, val_offsets=offs,
        snapshot_ts=snapshot_ts,
        max_rev=int(revs.max()) if n else 0,
        key_width=key_width, encoding=encoding, ttl_host=ttl_h,
    )


def build_mirror(
    rows: list[tuple[bytes, int, bytes]],
    device,
    key_width: int,
    snapshot_ts: int,
    n_parts: int | None = None,
    encode: bool = False,
) -> Mirror:
    """Python-row convenience path (tests / generic engines)."""
    return build_mirror_from_arrays(
        *rows_to_arrays(rows, key_width), device, key_width, snapshot_ts,
        n_parts=n_parts, encode=encode,
    )


def mirror_from_reference(arrays, device) -> Mirror:
    """A Mirror from another mirror's host arrays — how state is carried
    across from the JAX engine's published mirror. Takes numpy only.

    ``arrays`` maps ``keys_host`` (uint32[P, N, C]), ``lens_host``,
    ``revs_host``, ``tomb_host``, ``n_valid``, ``val_arena``,
    ``val_offsets``, ``snapshot_ts``, ``max_rev``, ``key_width``, optionally
    ``ttl_host``, and ``encoding``: None or a mapping of ``boundaries``,
    ``strips``, ``suffix_width``, ``raw_width``."""
    enc = arrays.get("encoding")
    encoding = None
    if enc is not None:
        encoding = KeyEncoding(
            boundaries=list(enc["boundaries"]), strips=list(enc["strips"]),
            suffix_width=int(enc["suffix_width"]),
            raw_width=int(enc["raw_width"]))
    keys_h = np.ascontiguousarray(arrays["keys_host"], dtype=np.uint32)
    revs_h = np.asarray(arrays["revs_host"], dtype=np.uint64)
    tomb_h = np.asarray(arrays["tomb_host"], dtype=bool)
    n_valid = np.asarray(arrays["n_valid"], dtype=np.int32)
    keys_d, revs_d, tomb_d, nv_d = _upload(keys_h, revs_h, tomb_h, n_valid, device)
    ttl = arrays.get("ttl_host")
    return Mirror(
        keys_dev=keys_d, revs_dev=revs_d, tomb_dev=tomb_d, n_valid_dev=nv_d,
        keys_host=keys_h,
        lens_host=np.asarray(arrays["lens_host"], dtype=np.int32),
        revs_host=revs_h, tomb_host=tomb_h, n_valid=n_valid,
        val_arena=[np.asarray(a, np.uint8) for a in arrays["val_arena"]],
        val_offsets=[np.asarray(o, np.uint64) for o in arrays["val_offsets"]],
        snapshot_ts=int(arrays["snapshot_ts"]), max_rev=int(arrays["max_rev"]),
        key_width=int(arrays["key_width"]), encoding=encoding,
        ttl_host=None if ttl is None else np.asarray(ttl, dtype=bool),
    )
