"""Persistent device-resident watcher-spec table.

Counterpart of ``kubebrain_tpu/fanout/table.py``. The hub's watcher
population, held as four columns on the table's device in the layout the
fan-out kernel K4 compares event keys against (``ops/fanout.py``):

    start int32[W, C]   end int32[W, C]   unbounded bool[W]   min_rev int64[W]

(key chunks sign-flipped, revisions one int64 column), plus a host map
slot → watcher id.

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
- ``device_view()`` publishes the columns: the whole table on first use or
  growth, otherwise only the dirty rows (``index_copy_``). The same step
  brings the table's rank index (``ops.fanout.RankIndex``: the distinct
  bound rows sorted, each slot's start and end rank) up to the columns it
  is returned with (``ranked_view()``), so it can never be staler than
  they are; a stale index would misdeliver silently. A full publication
  rebuilds it (C stable sorts of the 2W bound rows). A dirty-row
  publication updates it for the slots whose bound rows differ from the
  published ones, by looking their 2d rows up in a host copy of the
  index's rows and inserting those not in it yet
  (``ops.fanout.rank_index_update``: no device work to wait for);
  a change of ``min_rev`` alone, or a watcher re-established on the same
  range in the same slot, leaves it as it is. Rows no slot holds any more
  stay in the index, harmlessly, until it holds ``INDEX_SLACK`` times the
  table's capacity; then it is rebuilt.
- Capacity is a bucket: pow2 up to 1024, 1024-steps beyond.
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

One device: ``stats()`` reports 1 device and ``sharded`` False until the
table can be split over several cards.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..device import _host_pull
from ..ops import fanout as fanout_ops
from ..ops import keys as keyops
from ..ops.fanout import pow2_at_least
from ..ops.scan import flip_sign

#: smallest table capacity
MIN_CAPACITY = 64

#: smallest auto-sized packed width in bytes (8 uint32 chunks)
MIN_WIDTH = 32

#: the rank index is rebuilt once it holds this many rows per slot of
#: capacity (at most 2 are live)
INDEX_SLACK = 3

#: a sentinel row's key chunks: the all-zero key, sign-flipped
_SENTINEL = np.int32(-0x80000000)


class WatcherTable:
    def __init__(self, width: int | None = None, device=None):
        self.device = resolve_device(device)
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
        self._dev: tuple | None = None
        self._dev_epoch = -1
        self._index: fanout_ops.RankIndex | None = None  # of self._dev
        self._index_keys: np.ndarray | None = None  # row_keys of its rows
        self._index_builds = 0
        self._index_updates = 0
        self._index_s = 0.0      # host seconds in index builds and updates
        self._dirty: set[int] = set()
        self._pub_bounds: tuple | None = None  # host copy of published rows
        self._cap = 0
        with self._lock:
            self._alloc(self._capacity_for(1))

    # ---------------------------------------------------------------- layout
    @staticmethod
    def _capacity_for(n: int) -> int:
        """Pow2 buckets up to 1024, then 1024-step buckets: at 10k watchers
        a pure pow2 bucket pads to 16384 — 64% of the kernel's rows would
        be dead sentinels."""
        n = max(n, 1)
        if n <= 1024:
            return pow2_at_least(n, MIN_CAPACITY)
        return ((n + 1023) // 1024) * 1024

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
        """Publish dirty rows (or the whole table on first use / growth) and
        bring the rank index up to the published columns."""
        hosts = (self._starts, self._ends, self._unb, self._min_rev)
        if self._dev is None or self._dev_epoch != self._epoch:
            # a copy on every device, the CPU included: later syncs write
            # the host shadow, never a published column
            self._dev = tuple(torch.from_numpy(a).to(self.device, copy=True)
                              for a in hosts)
            self._pub_bounds = (self._starts.copy(), self._ends.copy())
            self._dev_epoch = self._epoch
            self._index = None
        elif self._dirty:
            idx = np.fromiter(sorted(self._dirty), dtype=np.int64,
                              count=len(self._dirty))
            idx_dev = torch.from_numpy(idx).to(self.device)
            for dev, host in zip(self._dev, hosts):
                dev.index_copy_(0, idx_dev,
                                torch.from_numpy(host[idx]).to(self.device))
            starts, ends = self._starts[idx], self._ends[idx]
            pub_s, pub_e = self._pub_bounds
            moved = ((starts != pub_s[idx]).any(axis=1)
                     | (ends != pub_e[idx]).any(axis=1))
            pub_s[idx], pub_e[idx] = starts, ends
            if moved.any():
                self._update_index_locked(idx[moved], starts[moved],
                                          ends[moved])
        self._dirty.clear()
        if self._index is None:
            t = time.perf_counter()
            self._index = fanout_ops.rank_index_plain(self._dev[0],
                                                      self._dev[1])
            fanout_ops.check_index(self._index, self._cap, self._chunks,
                                   self._dev[0].device)
            self._index_keys = fanout_ops.row_keys(
                _host_pull(self._index.rows))
            self._index_builds += 1
            self._index_s += time.perf_counter() - t

    def _update_index_locked(self, slots, starts, ends) -> None:
        """The rank index after ``slots`` took new bound rows, or None (to
        be rebuilt) once the rows no slot holds have piled up."""
        t = time.perf_counter()
        if (self._index.rows.shape[0] + 2 * len(slots)
                > INDEX_SLACK * self._cap):
            self._index = None
        else:
            self._index, self._index_keys = fanout_ops.rank_index_update(
                self._index, self._index_keys, slots, starts, ends)
            self._index_updates += 1
        self._index_s += time.perf_counter() - t

    def device_view(self):
        """Publish and return ``(starts, ends, unbounded, min_rev, wids,
        version)`` — the device columns plus the slot→wid host map the
        demux decodes with. The wids array is a snapshot copy: a concurrent
        sync can't mutate it under a caller mid-demux."""
        with self._lock:
            self._publish_locked()
            return (*self._dev, self._wids.copy(), self._version)

    def ranked_view(self):
        """:meth:`device_view` with the rank index of the same columns:
        ``(starts, ends, unbounded, min_rev, index, wids, version)``."""
        with self._lock:
            self._publish_locked()
            return (*self._dev, self._index, self._wids.copy(), self._version)

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
                "devices": 1,
                "sharded": False,
                "epoch": self._epoch,
                "dirty": len(self._dirty),
                "version": self._version,
                "index_builds": self._index_builds,
                "index_updates": self._index_updates,
                "index_rows": (0 if self._index is None
                               else self._index.rows.shape[0]),
                "index_s": self._index_s,
            }
