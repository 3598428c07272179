"""Device-resident sorted block mirror of the MVCC keyspace.

Counterpart of ``kubebrain_tpu/storage/tpu/blocks.py``. The authoritative
store stays on the host; the scan-hot columns (packed user key, revision,
tombstone flag) are mirrored into GPU memory as P sorted partitions padded
to a common row count. Values never leave the host: the kernels decide
*which* rows are visible, and the host materializes bytes by row index from
per-partition byte arenas.

The device columns are held in the layout the visibility kernels read
(``ops/scan.py``): keys int32[P, C, N] chunk-major and sign-flipped,
revisions int64[P, N], tombstone and TTL-key flags int8[P, N]. They are
split over the slots of a mesh (``parallel/mesh.py``): each slot holds P/D
contiguous partitions as a :class:`MirrorShard` of its own tensors (one
slot holds them all). A full build uploads every column; the incremental
paths (the write-path delta merge and compaction) work on the host copies
in the mirror's stored domain and re-upload only the partitions they
changed, on the slots that hold them; a clean slot's shard is carried over
as it is (counterpart of ``_assemble_sharded``,
``kubebrain_tpu/storage/tpu/blocks.py:353-388``). Partition borders are
user-key-aligned, so no version chain straddles two partitions (or two
slots) and the kernels need no carry between them. The key encoding, and
with it C, is one for all slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops import keys as keyops
from ...ops.scan import prepare_layout
from ...parallel.mesh import Mesh
from .encode import KeyEncoding, build_encoding

TTL_PREFIX = b"/events/"


@dataclass(frozen=True)
class MirrorShard:
    """One slot's device columns, in the kernel layout: partitions
    ``[lo, lo + k)`` of the mirror. With a live encoding the key column
    holds ENCODED rows (storage/cuda/encode.py) whose lexicographic order
    equals raw byte order."""
    device: torch.device   # the slot (a mesh may name a device twice)
    lo: int
    keys: torch.Tensor     # int32[k, C, N] chunk-major, sign-flipped
    revs: torch.Tensor     # int64[k, N]
    tomb: torch.Tensor     # int8[k, N]
    ttl: torch.Tensor      # int8[k, N] row belongs to a TTL (/events/) key
    n_valid: torch.Tensor  # int32[k]

    @property
    def parts(self) -> int:
        return self.keys.shape[0]


@dataclass
class Mirror:
    shards: tuple[MirrorShard, ...]  # the device columns, slot by slot
    # host copies (row-aligned with the device arrays); ``lens_host`` holds
    # encoded-suffix lengths under a live ``encoding``
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
    # host TTL flag column (row-aligned with the shards' ttl): the stored-domain
    # merge and compaction carry it along instead of recomputing TTL flags
    # from encoded keys
    ttl_host: np.ndarray | None = None  # bool[P, N]

    @property
    def partitions(self) -> int:
        return self.keys_host.shape[0]

    @property
    def slots(self) -> list[torch.device]:
        return [sh.device for sh in self.shards]

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


def _merge_sorted_blocks(blocks: list[tuple]) -> tuple:
    """k-way merge of row-array tuples sorted by (key, revision).

    Each block is ``(keys_u8[n, W], *columns, arena, offsets)``: any number
    of row-aligned 1-D columns between the key matrix and the value arena,
    the revisions second among them. One stable argsort over ``key ||
    big-endian revision`` compared as void scalars (memcmp order). Shared by
    :func:`merge_sorted_arrays` and :func:`merge_sorted_stored`, so the raw
    and the stored merge cannot diverge.

    A row present twice (the same key and revision: a revision names one
    write) is kept once. A background rebuild from the store keeps the delta
    rows recorded since it started, and a write that committed before the
    build's snapshot but was recorded after that start is in both; kept
    twice, the first copy would read as superseded by the second, and the
    next compaction would delete the live row from the store."""
    ncols = len(blocks[0]) - 3
    keys_u8 = np.concatenate([b[0] for b in blocks])
    cols = [np.concatenate([b[1 + c] for b in blocks]) for c in range(ncols)]
    revs = cols[1]
    n, w = keys_u8.shape
    rev_be = revs[:, None].astype(">u8").view(np.uint8).reshape(n, 8)
    sort_rows = np.ascontiguousarray(np.concatenate([keys_u8, rev_be], axis=1))
    perm = np.argsort(sort_rows.view([("v", f"V{w + 8}")]).reshape(n),
                      kind="stable")
    ordered = sort_rows[perm]
    fresh = np.ones(n, dtype=bool)
    fresh[1:] = (ordered[1:] != ordered[:-1]).any(axis=1)
    if not fresh.all():
        perm = perm[fresh]
    arena = np.concatenate([b[-2] for b in blocks])
    bases = np.cumsum([0] + [len(b[-2]) for b in blocks[:-1]]).astype(np.int64)
    offsets = np.concatenate(
        [b[-1].astype(np.int64)[:-1] + base for b, base in zip(blocks, bases)]
        + [np.array([len(arena)], dtype=np.int64)]).astype(np.uint64)
    new_arena, new_offsets = keyops.gather_arena(arena, offsets, perm)
    return (keys_u8[perm], *(c[perm] for c in cols), new_arena, new_offsets)


def merge_sorted_arrays(a, b):
    """Merge two RAW row-array sextuples ``(keys, lens, revs, tomb, arena,
    offsets)`` into one sorted by (key, revision)."""
    return _merge_sorted_blocks([a, b])


def merge_sorted_stored(blocks: list[tuple]) -> tuple:
    """Merge k sorted STORED-domain row blocks into one.

    A stored block is a septuple ``(keys_u8[n, W], lens, revs, tomb, ttl,
    arena, offsets)`` whose key bytes are in the mirror's compare domain:
    raw packed bytes for a raw mirror, dictionary-encoded rows for an
    encoded one. Encoded order equals raw byte order and the encoding is
    injective, so one argsort merges encoded blocks as exactly as raw ones."""
    if len(blocks) == 1:
        return blocks[0]
    return _merge_sorted_blocks(blocks)


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


def slot_list(device) -> list[torch.device]:
    """The slots a mirror is placed on: a device is one slot; a ``Mesh`` or
    a list of devices gives its ``part`` slots."""
    if isinstance(device, (Mesh, list, tuple)):
        return Mesh.of(device).slots("part")
    return [torch.device(device)]


def _shard(device, lo: int, keys_t, revs, tomb8, ttl8, n_valid) -> MirrorShard:
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MirrorShard(device, lo, put(keys_t), put(revs), put(tomb8),
                       put(ttl8), put(np.asarray(n_valid, np.int32)))


def _upload(keys_h, revs_h, tomb_h, ttl_h, n_valid, device) -> tuple:
    """Host row-major columns → the device kernel layout, split over the
    slots of ``device`` (:func:`slot_list`): one :class:`MirrorShard` per
    slot, P/D contiguous partitions each."""
    slots = slot_list(device)
    if keys_h.shape[0] % len(slots):
        raise ValueError(f"{keys_h.shape[0]} partitions do not split over "
                         f"{len(slots)} slots")
    k = keys_h.shape[0] // len(slots)
    keys_t, revs, tomb8 = prepare_layout(keys_h, revs_h, tomb_h)
    ttl8 = np.asarray(ttl_h).astype(np.int8)
    return tuple(
        _shard(d, i * k, *(a[i * k:(i + 1) * k] for a in
                           (keys_t, revs, tomb8, ttl8, n_valid)))
        for i, d in enumerate(slots))


def _republish(old: Mirror, keys_h, revs_h, tomb_h, ttl_h, n_valid,
               dirty) -> tuple:
    """Device shards of a successor mirror (counterpart of
    ``_assemble_sharded``, ``kubebrain_tpu/storage/tpu/blocks.py:353``): a
    slot holding a ``dirty`` partition gets a copy-on-write clone of its
    tensors with only those partitions re-uploaded; a clean slot's shard is
    carried over as it is; a full upload when the capacity changed.
    Readers holding the old Mirror keep its tensors untouched."""
    slots = old.slots
    if tuple(old.keys_host.shape) != tuple(keys_h.shape):
        return _upload(keys_h, revs_h, tomb_h, ttl_h, n_valid, slots)
    out = []
    for sh in old.shards:
        mine = [q for q in sorted(dirty) if sh.lo <= q < sh.lo + sh.parts]
        if not mine:
            out.append(sh)
            continue
        cols = [sh.keys.clone(), sh.revs.clone(), sh.tomb.clone(),
                sh.ttl.clone()]
        for q in mine:
            host = (*prepare_layout(keys_h[q : q + 1], revs_h[q : q + 1],
                                    tomb_h[q : q + 1]),
                    np.asarray(ttl_h[q : q + 1]).astype(np.int8))
            for col, part in zip(cols, host):
                col[q - sh.lo : q - sh.lo + 1].copy_(torch.from_numpy(part))
        nv = np.asarray(n_valid[sh.lo : sh.lo + sh.parts], np.int32)
        out.append(MirrorShard(sh.device, sh.lo, *cols,
                               torch.from_numpy(nv).to(sh.device)))
    return tuple(out)


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

    ``device`` is one device or the slots of a mesh (:func:`slot_list`);
    ``n_parts`` partitions (default one per slot, a multiple of the slots)
    split at user-key boundaries.
    ``encode=True`` builds an order-preserving prefix dictionary from the
    snapshot keys (storage/cuda/encode.py) and stores ENCODED rows, so the
    device key column shrinks from ``key_width`` to ``encoding.width`` bytes
    per row while every kernel compare stays byte-order-exact."""
    n_parts = n_parts or len(slot_list(device))
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

    return Mirror(
        shards=_upload(keys_h, revs_h, tomb_h, ttl_h, n_valid, device),
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
    ttl = arrays.get("ttl_host")
    return Mirror(
        shards=_upload(keys_h, revs_h, tomb_h, np.zeros(tomb_h.shape, bool)
                       if ttl is None else ttl, n_valid, device),
        keys_host=keys_h,
        lens_host=np.asarray(arrays["lens_host"], dtype=np.int32),
        revs_host=revs_h, tomb_host=tomb_h, n_valid=n_valid,
        val_arena=[np.asarray(a, np.uint8) for a in arrays["val_arena"]],
        val_offsets=[np.asarray(o, np.uint64) for o in arrays["val_offsets"]],
        snapshot_ts=int(arrays["snapshot_ts"]), max_rev=int(arrays["max_rev"]),
        key_width=int(arrays["key_width"]), encoding=encoding,
        ttl_host=None if ttl is None else np.asarray(ttl, dtype=bool),
    )


def _host_columns(mirror: Mirror, cap: int):
    """Copy-on-write host columns of ``mirror`` at row capacity ``cap``
    (the valid rows of each partition; a larger ``cap`` pads with zeros)."""
    if cap == mirror.keys_host.shape[1]:
        return (mirror.keys_host.copy(), mirror.lens_host.copy(),
                mirror.revs_host.copy(), mirror.tomb_host.copy(),
                mirror.ttl_host.copy())
    p, _n, c = mirror.keys_host.shape
    cols = (np.zeros((p, cap, c), mirror.keys_host.dtype),
            np.zeros((p, cap), mirror.lens_host.dtype),
            np.zeros((p, cap), mirror.revs_host.dtype),
            np.zeros((p, cap), mirror.tomb_host.dtype),
            np.zeros((p, cap), mirror.ttl_host.dtype))
    src = (mirror.keys_host, mirror.lens_host, mirror.revs_host,
           mirror.tomb_host, mirror.ttl_host)
    for q in range(p):
        nv = int(mirror.n_valid[q])
        for dst, col in zip(cols, src):
            dst[q, :nv] = col[q, :nv]
    return cols


def _successor(mirror: Mirror, cols, n_valid, arenas, offs, dirty,
               snapshot_ts: int, max_rev: int) -> Mirror:
    keys_h, lens_h, revs_h, tomb_h, ttl_h = cols
    return Mirror(
        shards=_republish(mirror, keys_h, revs_h, tomb_h, ttl_h, n_valid,
                          dirty),
        keys_host=keys_h, lens_host=lens_h, revs_host=revs_h, tomb_host=tomb_h,
        n_valid=n_valid, val_arena=arenas, val_offsets=offs,
        snapshot_ts=snapshot_ts, max_rev=max_rev,
        key_width=mirror.key_width, encoding=mirror.encoding, ttl_host=ttl_h,
    )


def merge_partitions_stored(mirror: Mirror, delta: tuple,
                            snapshot_ts: int) -> Mirror | None:
    """Incremental merge of a sorted STORED-domain delta septuple (see
    :func:`merge_sorted_stored`) into the mirror (counterpart of
    ``kubebrain_tpu/storage/tpu/blocks.py:406``).

    The delta rows were encoded against the published dictionary when they
    were sealed, so each dirty partition merges by byte interleave alone: no
    decode, no re-encode. Only dirty partitions re-upload. A partition that
    outgrows the padded capacity grows every partition's host arrays to the
    next capacity by memcpy (a full upload follows), never a re-sort or a
    re-encode. Returns None only when there is nothing to route into (an
    empty mirror), the mirror has no host TTL column, or the delta's stored
    width differs from the mirror's: the caller rebuilds from the store."""
    d_keys, d_lens, d_revs, d_tomb, d_ttl, d_arena, d_offsets = delta
    if len(d_keys) == 0:
        return mirror
    if mirror.ttl_host is None:
        return None
    P, cap, C = mirror.keys_host.shape
    if d_keys.shape[1] != C * 4:
        return None
    nonempty = [p for p in range(P) if mirror.n_valid[p] > 0]
    if not nonempty:
        return None

    # route each delta row to the last non-empty partition whose first
    # stored row is <= it (stored order == raw order); rows below the first
    # partition's floor go to it. The delta is sorted, so each dirty
    # partition owns one contiguous slice.
    firsts = keyops.u8_void(np.ascontiguousarray(keyops.chunks_to_u8(
        np.stack([mirror.keys_host[p, 0] for p in nonempty]))))
    d_void = keyops.u8_void(np.ascontiguousarray(d_keys))
    pos = np.maximum(np.searchsorted(firsts, d_void, side="right") - 1, 0)
    row_part = np.asarray(nonempty, dtype=np.int64)[pos]
    dirty = np.unique(row_part).tolist()
    part_lo = np.searchsorted(row_part, np.asarray(dirty), side="left")
    part_hi = np.searchsorted(row_part, np.asarray(dirty), side="right")

    need = max(int(mirror.n_valid[p]) + int(hi - lo)
               for p, lo, hi in zip(dirty, part_lo, part_hi))
    if need > cap:
        cap = padded_capacity(need)
    cols = _host_columns(mirror, cap)
    keys_h, lens_h, revs_h, tomb_h, ttl_h = cols
    n_valid = mirror.n_valid.copy()
    arenas = list(mirror.val_arena)
    offs = list(mirror.val_offsets)
    d_off64 = d_offsets.astype(np.int64)
    for p, lo, hi in zip(dirty, part_lo, part_hi):
        lo, hi = int(lo), int(hi)
        nv = int(n_valid[p])
        part = (
            keyops.chunks_to_u8(mirror.keys_host[p, :nv]),
            mirror.lens_host[p, :nv], mirror.revs_host[p, :nv],
            mirror.tomb_host[p, :nv], mirror.ttl_host[p, :nv],
            mirror.val_arena[p][: int(mirror.val_offsets[p][nv])],
            mirror.val_offsets[p][: nv + 1],
        )
        dslice = (
            d_keys[lo:hi], d_lens[lo:hi], d_revs[lo:hi], d_tomb[lo:hi],
            d_ttl[lo:hi], d_arena[d_off64[lo] : d_off64[hi]],
            (d_off64[lo : hi + 1] - d_off64[lo]).astype(np.uint64),
        )
        mk, ml, mr, mt, mttl, ma, mo = merge_sorted_stored([part, dslice])
        mn = len(mk)
        keys_h[p, :mn] = keyops.bytes_to_chunks(np.ascontiguousarray(mk))
        lens_h[p, :mn] = ml
        revs_h[p, :mn] = mr
        tomb_h[p, :mn] = mt
        ttl_h[p, :mn] = mttl
        n_valid[p] = mn
        arenas[p] = ma
        offs[p] = mo
    return _successor(mirror, cols, n_valid, arenas, offs, dirty, snapshot_ts,
                      max(mirror.max_rev, int(d_revs.max())))


def compact_partitions_stored(mirror: Mirror, keep_idx: dict[int, np.ndarray],
                              snapshot_ts: int) -> Mirror | None:
    """Shrink the mirror to the compaction survivors without leaving the
    stored domain (counterpart of ``kubebrain_tpu/storage/tpu/blocks.py:556``).

    ``keep_idx`` maps each DIRTY partition (one with a victim) to its
    ascending surviving row indices. Survivors are gathered as stored rows
    (key bytes, host TTL column, value arena), so the steady compaction path
    decodes, re-encodes and re-dictionaries nothing; partition borders and
    the published KeyEncoding carry over, and only dirty partitions
    re-upload. Returns None for a mirror without a host TTL column (the
    caller rebuilds). Shrinking never overflows the padded capacity."""
    if not keep_idx:
        return mirror
    if mirror.ttl_host is None:
        return None
    cols = _host_columns(mirror, mirror.keys_host.shape[1])
    n_valid = mirror.n_valid.copy()
    arenas = list(mirror.val_arena)
    offs = list(mirror.val_offsets)
    src = (mirror.keys_host, mirror.lens_host, mirror.revs_host,
           mirror.tomb_host, mirror.ttl_host)
    for p, keep in keep_idx.items():
        nv = int(n_valid[p])
        keep = np.asarray(keep, dtype=np.int64)
        mn = len(keep)
        for dst, col in zip(cols, src):
            dst[p, :mn] = col[p][keep]
            # zero the vacated tail: rows past n_valid are masked by the
            # kernels but must not reach a later capacity-grow memcpy
            dst[p, mn:nv] = 0
        n_valid[p] = mn
        arenas[p], offs[p] = keyops.gather_arena(
            mirror.val_arena[p], mirror.val_offsets[p][: nv + 1], keep)
    return _successor(mirror, cols, n_valid, arenas, offs, set(keep_idx),
                      snapshot_ts, mirror.max_rev)
