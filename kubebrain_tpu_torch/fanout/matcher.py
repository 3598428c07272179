"""Hub-facing device matcher for block-batched watch fan-out.

Counterpart of ``kubebrain_tpu/fanout/matcher.py``. :class:`DeviceFanout`
is what the hub is given as its ``fanout_matcher``. It exposes two
protocols:

- ``deliver(batch, specs, version)`` — the block path: one K4 call for the
  WHOLE drain block against the persistent :class:`WatcherTable` (one per
  piece of a block too long for the int32 flat index), then one vectorized
  demux of the compacted (watcher, event) pairs into
  per-subscriber event lists. The hub prefers this (``prefers_blocks``).
- ``__call__(events, specs, version)`` — the mask protocol (bool[E, W] in
  spec order), kept so the hub's per-batch route and the differential
  tests run the same machinery.

Dispatch sizing: the compacted-index capacity is a persistent pow2 bucket.
When the total shows the block overflowed it, the matcher doubles the
bucket and re-dispatches — so the steady state is ONE call per drain.

:func:`match_oracle` is the brute-force host oracle every path is held
byte-identical to (raw-bytes etcd range semantics — no packing, no
canonicalization: the packed compare must agree with it by construction).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import _host_pull
from ..ops import fanout as fanout_ops
from ..ops import keys as keyops
from ..ops.fanout import pow2_at_least
from ..ops.scan import flip_sign
from ..trace import TRACER
from .dispatch import fanout_dispatch, max_block_events
from .table import WatcherTable

#: smallest compacted-index transfer (pow2; grows on overflow)
MIN_IDX_SIZE = 128

#: smallest E bucket (drain depths 1..8 share one shape)
MIN_EVENT_BUCKET = 8


def match_oracle(events, specs) -> np.ndarray:
    """bool[E, W] delivery mask, brute force on raw bytes in spec order.

    Plain etcd watch semantics — ``start <= key`` and (unbounded or
    ``key < end``) and ``rev >= min_rev`` — with Python bytes comparison,
    so NUL-bearing bounds (single-key watch end = key + b"\\0") are
    exercised unrewritten. Every device/index path must match this
    byte-for-byte.
    """
    out = np.zeros((len(events), len(specs)), dtype=bool)
    for j, (_wid, start, end, min_rev) in enumerate(specs):
        for i, ev in enumerate(events):
            out[i, j] = (
                ev.key >= start
                and (not end or ev.key < end)
                and ev.revision >= min_rev
            )
    return out


class DeviceFanout:
    """Persistent-table device matcher with block delivery and overflow-
    regrown compacted transfers. The hub calls it from its single drainer
    thread; the table's sync is internally locked.

    ``device=None`` means ``cuda`` and raises without a card; the tests
    pass ``device="cpu"``, where K4's wrapper computes the plain version.
    """

    #: hub protocol marker: hand this matcher whole drain blocks
    prefers_blocks = True

    def __init__(self, width: int | None = None, metrics=None, device=None):
        # width None = auto: the table buckets the packed width to the
        # population's longest key; an int pins it
        self._table = WatcherTable(width=width, device=device)
        self.device = self._table.device
        self._idx_size = MIN_IDX_SIZE
        self.stats = {"dispatches": 0, "redispatches": 0, "pairs": 0,
                      "blocks": 0}
        if metrics is not None:
            self.set_metrics(metrics)

    def set_metrics(self, metrics) -> None:
        """Arm the ``kb.fanout.sharded`` gauge (1 = the watcher table is
        split over several devices); one device until multi-GPU support."""
        if metrics is not None:
            metrics.emit_gauge("kb.fanout.sharded", 0.0)
            metrics.register_gauge_fn("kb.fanout.sharded", lambda: 0.0)

    @property
    def table(self) -> WatcherTable:
        return self._table

    # ------------------------------------------------------------- matching
    def _pack_events(self, batch):
        e = len(batch)
        epad = pow2_at_least(e, MIN_EVENT_BUCKET)
        keys = [ev.key for ev in batch] + [b""] * (epad - e)
        revs = [ev.revision for ev in batch] + [0] * (epad - e)
        # event keys must fit the table's packed width (and must be packed
        # AT that width — the kernel compares chunk for chunk)
        self._table.ensure_width(max(len(k) for k in keys) + 2)
        ek, _ = keyops.pack_keys(keys, self._table.width)
        dev = self.device
        return (torch.from_numpy(flip_sign(ek)).to(dev),
                torch.from_numpy(fanout_ops.revisions(revs)).to(dev), epad)

    def _match(self, batch, specs, version=None):
        """One block → (slots int64[M], eidx int64[M], wids int64[cap]):
        compacted matched pairs in ascending (slot, event) order plus the
        slot→wid map snapshot. Transfer is O(M) and the 4-byte total.

        A block longer than the int32 flat index allows over the table's
        capacity (:func:`max_block_events`: a backlog of over 16,384 events
        at 100k watchers) is dispatched in pieces and their pairs merged by
        slot, stably, so each slot's events stay in block order."""
        self._table.sync(specs, version)
        empty = np.zeros(0, np.int64)
        if not batch or not specs:
            return empty, empty, empty
        step = max_block_events(self._table.stats()["capacity"])
        parts = [self._match_piece(batch[i:i + step], i)
                 for i in range(0, len(batch), step)]
        wids = parts[0][2]
        if len(parts) == 1:
            return parts[0]
        slots = np.concatenate([p[0] for p in parts])
        eidx = np.concatenate([p[1] for p in parts])
        order = np.argsort(slots, kind="stable")
        return slots[order], eidx[order], wids

    def _match_piece(self, piece, first: int):
        """One K4 dispatch of events ``piece`` (``batch[first:]``), the
        bucket regrown and re-dispatched while the total overflows it."""
        # packing may grow the table's width (a new epoch): the view, and
        # the rank index with it, is taken after it, at the events' width
        ek, er, epad = self._pack_events(piece)
        ws, we, wu, wr, index, wids, _ver = self._table.ranked_view()
        while True:
            self.stats["dispatches"] += 1
            with TRACER.stage("fanout_dispatch"):
                _counts, idx, total = fanout_dispatch(
                    ek, er, len(piece), ws, we, wu, wr, size=self._idx_size,
                    index=index, with_total=True)
            with TRACER.stage("fanout_copy"):
                total = int(_host_pull(total)[0])
                if total > self._idx_size:
                    # truncated: double the bucket and re-launch (rare — the
                    # bucket is persistent, so the steady state is one call
                    # per drain)
                    self._idx_size = pow2_at_least(total, self._idx_size * 2)
                    self.stats["redispatches"] += 1
                    continue
                flat = _host_pull(idx[:total]).astype(np.int64)
                break
        self.stats["pairs"] += total
        return flat // epad, flat % epad + first, wids

    # ------------------------------------------------------------ protocols
    def deliver(self, batch, specs, version=None) -> dict[int, list]:
        """Block protocol: {wid: [events, batch order]} for one drain block
        — sync, one dispatch (per piece, :meth:`_match`), one vectorized
        demux (matched pairs arrive slot-major and ascending, so the
        per-subscriber split is diff + split, no sort)."""
        self.stats["blocks"] += 1
        slots, eidx, wids = self._match(batch, specs, version)
        if not len(slots):
            return {}
        cuts = np.flatnonzero(np.diff(slots)) + 1
        groups = np.split(eidx, cuts)
        heads = slots[np.concatenate(([0], cuts))]
        out: dict[int, list] = {}
        for slot, evs in zip(heads, groups):
            wid = int(wids[slot])
            if wid < 0:
                continue  # sentinel rows never match; belt and braces
            out[wid] = [batch[int(i)] for i in evs]
        return out

    def __call__(self, events, watcher_specs, version=None) -> np.ndarray:
        """Mask protocol: bool[E, W] in ``watcher_specs`` order."""
        slots, eidx, wids = self._match(events, watcher_specs, version)
        mask = np.zeros((len(events), len(watcher_specs)), dtype=bool)
        if len(slots):
            col = {wid: j for j, (wid, *_r) in enumerate(watcher_specs)}
            cols = np.array([col[int(wids[s])] for s in slots],
                            dtype=np.int64)
            mask[eidx, cols] = True
        return mask
