"""Persistent device-resident watcher-spec table.

Counterpart of ``kubebrain_tpu/fanout/table.py``. The hub's watcher
population, held as four columns in the layout the fan-out kernel K4
compares event keys against (``ops/fanout.py``):

    start int32[W, C]   end int32[W, C]   unbounded bool[W]   min_rev int64[W]

(key chunks sign-flipped, revisions one int64 column), plus a host map
slot → watcher id. The columns are split over the slots of a ``wat`` mesh
(``parallel/mesh.py``; one without a mesh): each mesh slot holds a
contiguous run of W/D table slots, with a rank index of its own
(:class:`TableShard`).

Lifecycle:

- ``sync(specs, version)`` reconciles the table with a hub snapshot by
  DIFF, not rebuild: only rows whose watcher changed are re-packed and
  marked dirty, so steady-state watcher churn costs O(changed rows), not
  O(W) packing. The O(1) fast path (version unchanged) skips the diff
  entirely. A hub restart reuses versions from 0 — the fast-path key is
  widened with the population's count and first and last watcher id, and
  the diff is keyed on watcher ids + filters, so a version REGRESSION (or an
  id collision with different filters) rewrites exactly the rows that
  differ and can never match against a dead population.
- ``shard_views()`` publishes the columns: the whole table on first use or
  growth, otherwise only the dirty rows (``index_copy_`` into the mesh
  slot that holds them). The same step brings each shard's rank index
  (``ops.fanout.RankIndex``: the distinct bound rows sorted, each table
  slot's start and end rank) up to the columns it is returned with, so it
  can never be staler than they are; a stale index would misdeliver silently. A full publication
  rebuilds it (C stable sorts of the 2W bound rows). A dirty-row
  publication updates it for the slots whose bound rows differ from the
  published ones, by looking their 2d rows up in a host copy of the
  index's rows and inserting those not in it yet
  (``ops.fanout.rank_index_update``: no device work to wait for);
  a change of ``min_rev`` alone, or a watcher re-established on the same
  range in the same slot, leaves it as it is. Rows no slot holds any more
  stay in the index, harmlessly, until it holds ``INDEX_SLACK`` times its
  shard's capacity; then it is rebuilt.
- Capacity is a bucket: pow2 up to 1024, 1024-steps beyond, rounded up to
  a multiple of the slot count, so the table always splits evenly (JAX
  ``fanout/table.py:22``): there is no unsharded fallback.
- The packed width is sized to the POPULATION, not to the 128-byte
  protocol maximum: registry keys run ~50 bytes, so packing at a pow2
  bucket over the longest live bound (plus the canonicalization margin)
  halves the kernel's chunk-compare work for typical populations. Width
  only grows, in pow2 steps, and a growth is a full republish like a
  capacity growth. Passing an explicit ``width`` pins it (``pack_keys``
  then rejects longer keys loudly).

Free slots hold a never-match sentinel: a bounded EMPTY range (start and
end the all-zero key, flipped INT_MIN in every chunk; unbounded False)
fails the ``key < end`` test for every possible key, so padding and freed
slots are inert regardless of the revision filter.

``stats()`` reports the mesh slot count as ``devices`` and ``sharded``
True when the table is split over more than one.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import _host_pull
from ..ops import fanout as fanout_ops
from ..ops import keys as keyops
from ..ops.fanout import pow2_at_least
from ..ops.scan import flip_sign
from ..parallel.mesh import placement

#: smallest table capacity
MIN_CAPACITY = 64

#: smallest auto-sized packed width in bytes (8 uint32 chunks)
MIN_WIDTH = 32

#: the rank index is rebuilt once it holds this many rows per slot of
#: capacity (at most 2 are live)
INDEX_SLACK = 3

#: a sentinel row's key chunks: the all-zero key, sign-flipped
_SENTINEL = np.int32(-0x80000000)


class TableShard:
    """One slot's published columns: table slots ``[lo, hi)`` on
    ``device``, with their rank index and the host copy of its rows
    (``row_keys`` order)."""

    __slots__ = ("device", "lo", "hi", "cols", "index", "index_keys")

    def __init__(self, device: torch.device, lo: int, hi: int):
        self.device, self.lo, self.hi = device, lo, hi
        self.cols: tuple | None = None
        self.index: fanout_ops.RankIndex | None = None
        self.index_keys: np.ndarray | None = None


class WatcherTable:
    def __init__(self, width: int | None = None, device=None, mesh=None):
        """``mesh``: a ``wat`` mesh (or a list of slots) to split the
        columns over; ``device`` defaults to its first slot. Without one
        the table lives on ``device`` alone."""
        self.device, self._slots = placement(device, mesh, "wat")
        self._auto_width = width is None
        self._width = width if width is not None else MIN_WIDTH
        self._chunks = self._width // 4
        self._lock = threading.Lock()
        self._specs: dict[int, tuple[bytes, bytes, int]] = {}
        self._slot_of: dict[int, int] = {}
        self._free: list[int] = []
        self._version: int | None = None  # hub watcher-set version last synced
        # widened O(1) fast-path key: (version, count, first wid, last wid)
        self._sync_key: tuple | None = None
        self._epoch = 0          # bumps on (re)allocation → full republish
        self._shards: list[TableShard] = []
        self._dev_epoch = -1
        self._index_builds = 0
        self._index_updates = 0
        self._index_s = 0.0      # host seconds in index builds and updates
        self._dirty: set[int] = set()
        self._pub_bounds: tuple | None = None  # host copy of published rows
        self._cap = 0
        with self._lock:
            self._alloc(self._capacity_for(1))

    # ---------------------------------------------------------------- layout
    def _capacity_for(self, n: int) -> int:
        """Pow2 buckets up to 1024, then 1024-step buckets (at 10k watchers
        a pure pow2 bucket pads to 16384 — 64% of the kernel's rows would
        be dead sentinels), rounded up to a multiple of the slot count."""
        n = max(n, 1)
        if n <= 1024:
            cap = pow2_at_least(n, MIN_CAPACITY)
        else:
            cap = ((n + 1023) // 1024) * 1024
        d = len(self._slots)
        return -(-cap // d) * d

    def _grow_width_locked(self, n_bytes: int) -> None:
        """Grow the packed width so an ``n_bytes`` key (or bound) fits.
        Auto-width mode only — an explicit width stays pinned and overlong
        keys fail loudly in pack_keys. Growth re-packs every live row at
        the new chunk count and bumps the epoch (full republish)."""
        if not self._auto_width:
            return
        width = pow2_at_least(max(n_bytes, MIN_WIDTH))
        if width <= self._width:
            return
        self._width = width
        self._chunks = width // 4
        cap = self._cap
        self._cap = 0          # fresh sentinel columns at the new chunk count
        self._free = []
        self._alloc(cap)
        used = set(self._slot_of.values())
        self._free = [s for s in range(cap - 1, -1, -1) if s not in used]
        for wid, slot in self._slot_of.items():
            self._write_row_locked(slot, wid, self._specs[wid])

    def ensure_width(self, n_bytes: int) -> None:
        """Public width guard for the EVENT side: the matcher calls this
        with the block's longest key before packing at ``self.width``."""
        with self._lock:
            self._grow_width_locked(n_bytes)

    def _alloc(self, cap: int) -> None:
        """(Re)allocate the host shadow columns at ``cap`` slots, preserving
        live rows; every new slot is a never-match sentinel."""
        starts = np.full((cap, self._chunks), _SENTINEL, dtype=np.int32)
        ends = np.full((cap, self._chunks), _SENTINEL, dtype=np.int32)
        unb = np.zeros(cap, dtype=bool)
        min_rev = np.zeros(cap, dtype=np.int64)
        wids = np.full(cap, -1, dtype=np.int64)
        if self._cap:
            starts[: self._cap] = self._starts
            ends[: self._cap] = self._ends
            unb[: self._cap] = self._unb
            min_rev[: self._cap] = self._min_rev
            wids[: self._cap] = self._wids
        self._free.extend(range(cap - 1, self._cap - 1, -1))
        self._starts, self._ends, self._unb = starts, ends, unb
        self._min_rev, self._wids = min_rev, wids
        self._cap = cap
        self._epoch += 1
        self._dirty.clear()  # full republish supersedes any pending rows

    def _rows_for(self, start: bytes, end: bytes, min_rev: int):
        """Packed rows for one watcher spec. NUL-bearing bounds (single-key
        watches use end = key + b"\\0") are canonicalized the same way the
        scan path does: zero-padded, ``key + b"\\0"`` would compare equal
        to ``key``."""
        srow = keyops.pack_one(keyops.canonicalize_bound(start), self._width)
        erow = keyops.pack_one(keyops.canonicalize_bound(end), self._width)
        rev = fanout_ops.revisions([min_rev])[0]
        return (flip_sign(srow), flip_sign(erow),
                not end, rev)

    def _write_row_locked(self, slot: int, wid: int,
                          spec: tuple[bytes, bytes, int] | None) -> None:
        if spec is None:  # sentinel: bounded empty range can never match
            s = e = _SENTINEL
            u, r, wid = False, 0, -1
        else:
            s, e, u, r = self._rows_for(*spec)
        self._starts[slot] = s
        self._ends[slot] = e
        self._unb[slot] = u
        self._min_rev[slot] = r
        self._wids[slot] = wid
        self._dirty.add(slot)

    # ----------------------------------------------------------------- sync
    def sync(self, specs: list[tuple[int, bytes, bytes, int]],
             version: int | None = None) -> None:
        """Reconcile with a hub snapshot ``[(wid, start, end, min_rev)]``.

        O(1) when ``version`` matches the last sync; otherwise an O(W) dict
        diff that re-packs only changed rows. Correct under version
        regression / wid collision by construction (rows are compared by
        content, not trusted by version)."""
        key = (version, len(specs),
               specs[0][0] if specs else None,
               specs[-1][0] if specs else None)
        with self._lock:
            if version is not None and key == self._sync_key:
                return
            if specs:
                # +2: canonicalize_bound may extend a NUL-bearing bound by
                # one byte past its base
                self._grow_width_locked(
                    max(max(len(s), len(e)) for _, s, e, _ in specs) + 2)
            want = {wid: (s, e, r) for wid, s, e, r in specs}
            for wid in [w for w in self._slot_of if w not in want]:
                slot = self._slot_of.pop(wid)
                del self._specs[wid]
                self._write_row_locked(slot, wid, None)
                self._free.append(slot)
            if len(want) > self._cap:
                # live rows survive the realloc; the epoch bump republishes
                # them without re-packing
                self._alloc(self._capacity_for(len(want)))
            for wid, spec in want.items():
                have = self._specs.get(wid)
                if have == spec:
                    continue
                slot = self._slot_of.get(wid)
                if slot is None:
                    slot = self._free.pop()
                    self._slot_of[wid] = slot
                self._specs[wid] = spec
                self._write_row_locked(slot, wid, spec)
            self._version = version
            self._sync_key = key

    # ----------------------------------------------------------- publication
    def _publish_locked(self) -> None:
        """Publish dirty rows (or the whole table on first use / growth)
        into the slots that hold them and bring each slot's rank index up
        to its published columns."""
        hosts = (self._starts, self._ends, self._unb, self._min_rev)
        if not self._shards or self._dev_epoch != self._epoch:
            # a copy on every device, the CPU included: later syncs write
            # the host shadow, never a published column
            k = self._cap // len(self._slots)
            self._shards = [TableShard(d, i * k, (i + 1) * k)
                            for i, d in enumerate(self._slots)]
            for sh in self._shards:
                sh.cols = tuple(torch.from_numpy(a[sh.lo:sh.hi]).to(
                    sh.device, copy=True) for a in hosts)
            self._pub_bounds = (self._starts.copy(), self._ends.copy())
            self._dev_epoch = self._epoch
        elif self._dirty:
            idx = np.fromiter(sorted(self._dirty), dtype=np.int64,
                              count=len(self._dirty))
            starts, ends = self._starts[idx], self._ends[idx]
            pub_s, pub_e = self._pub_bounds
            moved = ((starts != pub_s[idx]).any(axis=1)
                     | (ends != pub_e[idx]).any(axis=1))
            pub_s[idx], pub_e[idx] = starts, ends
            for sh in self._shards:
                mine = (idx >= sh.lo) & (idx < sh.hi)
                if not mine.any():
                    continue
                rows = idx[mine]
                local = torch.from_numpy(rows - sh.lo).to(sh.device)
                for dev, host in zip(sh.cols, hosts):
                    dev.index_copy_(0, local,
                                    torch.from_numpy(host[rows]).to(sh.device))
                if (moved & mine).any():
                    self._update_index_locked(
                        sh, idx[moved & mine] - sh.lo, starts[moved & mine],
                        ends[moved & mine])
        self._dirty.clear()
        for sh in self._shards:
            if sh.index is None:
                t = time.perf_counter()
                sh.index = fanout_ops.rank_index_plain(sh.cols[0], sh.cols[1])
                fanout_ops.check_index(sh.index, sh.hi - sh.lo, self._chunks,
                                       sh.cols[0].device)
                sh.index_keys = fanout_ops.row_keys(_host_pull(sh.index.rows))
                self._index_builds += 1
                self._index_s += time.perf_counter() - t

    def _update_index_locked(self, sh: TableShard, slots, starts,
                             ends) -> None:
        """``sh``'s rank index after its local ``slots`` took new bound
        rows, or None (to be rebuilt) once the rows no slot holds have
        piled up."""
        t = time.perf_counter()
        if (sh.index.rows.shape[0] + 2 * len(slots)
                > INDEX_SLACK * (sh.hi - sh.lo)):
            sh.index = None
        else:
            sh.index, sh.index_keys = fanout_ops.rank_index_update(
                sh.index, sh.index_keys, slots, starts, ends)
            self._index_updates += 1
        self._index_s += time.perf_counter() - t

    def shard_views(self):
        """Publish and return ``(shards, wids, version)``: per slot ``(lo,
        starts, ends, unbounded, min_rev, index)``, its columns on its
        device and their rank index, plus the slot→wid host map the demux
        decodes with. The wids array is a snapshot copy: a concurrent sync
        can't mutate it under a caller mid-demux."""
        with self._lock:
            self._publish_locked()
            return ([(sh.lo, *sh.cols, sh.index) for sh in self._shards],
                    self._wids.copy(), self._version)

    # ------------------------------------------------------------- inspection
    @property
    def width(self) -> int:
        with self._lock:
            return self._width

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._cap,
                "width": self._width,
                "watchers": len(self._specs),
                "devices": len(self._slots),
                "sharded": len(self._slots) > 1,
                "epoch": self._epoch,
                "dirty": len(self._dirty),
                "version": self._version,
                "index_builds": self._index_builds,
                "index_updates": self._index_updates,
                "index_rows": sum(sh.index.rows.shape[0] for sh in self._shards
                                  if sh.index is not None),
                "index_s": self._index_s,
            }
