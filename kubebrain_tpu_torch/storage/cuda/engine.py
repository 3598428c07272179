"""The ``cuda`` storage engine: host-authoritative store + GPU scan mirror.

Counterpart of the read half of ``kubebrain_tpu/storage/tpu/engine.py``:

- **writes / point reads / CAS**: delegated to a host engine (memkv);
- **range scans / counts**: the device mirror (``blocks.Mirror``) and the
  CUDA visibility kernels K1/K2 (``ops/scan_kernels.py``), then a
  per-partition mask→index compaction in PyTorch ops (J1) so the host pulls
  O(visible rows), never the mask;
- **freshness**: committed version rows are appended to a host-side delta
  index by the batch decorator; queries overlay it (every delta revision
  exceeds every published revision, so overlay-wins resolution is exact).
  A delta past ``merge_threshold`` or an uncertain commit sets
  ``_force_rebuild``, and the next read rebuilds the mirror from the store
  — exact, because the store is the only source of truth.
"""

from __future__ import annotations

import bisect
import os
import threading

import numpy as np
import torch

from ... import coder
from ...backend.common import TOMBSTONE, KeyValue
from ...backend.scanner import CompactHistory, Scanner
from ...device import _host_pull, _pow2_bucket, resolve_device
from ...ops import keys as keyops
from ...ops import scan_kernels
from ...ops.scan import flip_sign
from ...trace import TRACER
from .. import BatchWrite, KvStorage, Partition, register_engine
from ..errors import UncertainResultError
from .blocks import Mirror, build_mirror


class _DeltaIndex:
    """Commit-order delta rows plus a sorted key index, so read overlays
    cost O(log d + matches) instead of a full scan of the delta per query.
    Writers append; per-key revision lists only grow."""

    __slots__ = ("_rows", "_keys", "_by_key")

    def __init__(self):
        self._rows: list[tuple[bytes, int, bytes]] = []
        self._keys: list[bytes] = []  # sorted, unique
        self._by_key: dict[bytes, list[tuple[int, bytes]]] = {}

    def extend(self, rows) -> None:
        for ukey, rev, value in rows:
            self._rows.append((ukey, rev, value))
            lst = self._by_key.get(ukey)
            if lst is None:
                self._by_key[ukey] = [(rev, value)]
                bisect.insort(self._keys, ukey)
            else:
                lst.append((rev, value))

    def __len__(self) -> int:
        return len(self._rows)

    def rows(self) -> list[tuple[bytes, int, bytes]]:
        return self._rows

    def overlay(
        self, start: bytes, end: bytes, read_rev: int
    ) -> dict[bytes, tuple[int, bytes] | None]:
        """Per user key in [start, end): latest delta version <= read_rev.
        None value => tombstoned. Delta revisions all exceed published
        revisions, so any entry here overrides the device result."""
        lo = bisect.bisect_left(self._keys, start)
        hi = bisect.bisect_left(self._keys, end) if end else len(self._keys)
        out: dict[bytes, tuple[int, bytes] | None] = {}
        for ukey in self._keys[lo:hi]:
            for rev, value in reversed(self._by_key[ukey]):
                if rev <= read_rev:
                    out[ukey] = None if value == TOMBSTONE else (rev, value)
                    break
        return out


def _part_indices_of_mask(mask: torch.Tensor, size: int) -> torch.Tensor:
    """J1: per-row compaction of a mask ``[..., N]`` → the first ``size``
    set row indices ``[..., size]`` int32 (fill = N), on the mask's device
    (counterpart of ``_part_indices_of_mask`` / ``_sel``,
    ``storage/tpu/engine.py:253-292``). A running count gives each set row
    its slot; rows past ``size`` and unset rows land in a discarded slot."""
    n = mask.shape[-1]
    pos = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    slot = torch.where(mask & (pos < size), pos, size).to(torch.int64)
    out = torch.full((*mask.shape[:-1], size + 1), n, dtype=torch.int32,
                     device=mask.device)
    rows = torch.arange(n, dtype=torch.int32, device=mask.device).expand_as(mask)
    out.scatter_(-1, slot, rows)
    return out[..., :size]


def bound_rows(encoding, key_width: int, start: bytes, end: bytes):
    """(start row, end row, unbounded) as packed uint32 chunk rows in a
    mirror's compare domain — raw chunks for a raw mirror (``encoding`` is
    None), dictionary-encoded bounds for an encoded one. NUL-bearing bounds
    are canonicalized first; an empty end means unbounded. The one packing
    point of every scan query."""
    if encoding is not None:
        enc_s = encoding.encode_start_bound(keyops.canonicalize_bound(start))
        enc_e = (encoding.encode_end_bound(keyops.canonicalize_bound(end))
                 if end else np.zeros(encoding.width, np.uint8))
        return (keyops.bytes_to_chunks(enc_s[None])[0],
                keyops.bytes_to_chunks(enc_e[None])[0], not end)
    s_row = keyops.pack_one(keyops.canonicalize_bound(start), key_width)
    e_row = keyops.pack_one(
        keyops.canonicalize_bound(end) if end else b"", key_width)
    return s_row, e_row, not end


def query_tensors(encoding, key_width: int, specs, device):
    """The kernels' query arguments for ``(start, end, read_rev)`` specs:
    flipped bound rows int32[Q, C] (start, end), unbounded flags int32[Q]
    and read revisions int64[Q], on ``device``."""
    rows = [bound_rows(encoding, key_width, s, e) for s, e, _r in specs]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(flip_sign(np.stack([r[0] for r in rows]))),
            put(flip_sign(np.stack([r[1] for r in rows]))),
            put(np.array([r[2] for r in rows], dtype=np.int32)),
            put(np.array([r for _s, _e, r in specs], dtype=np.int64)))


def _resolve_key_encoding(encode_keys: bool | None) -> bool:
    """Order-preserving key encoding (storage/cuda/encode.py): default on;
    KB_ENCODE_KEYS=0 opts back into the raw layout."""
    if encode_keys is not None:
        return encode_keys
    return os.environ.get("KB_ENCODE_KEYS", "1").lower() not in ("0", "false", "no")


class TorchScanner(Scanner):
    """Scanner contract over the device mirror; host fallback for small
    limit queries (one engine iter beats a kernel launch for a 500-row page).
    """

    def __init__(
        self,
        store: KvStorage,
        get_compact_revision,
        retry_min_revision=lambda: 0,
        compact_history: CompactHistory | None = None,
        max_workers: int = 8,
        device=None,
        key_width: int = keyops.KEY_WIDTH,
        merge_threshold: int = 4096,
        host_limit_threshold: int = 1024,
        partitions: int = 0,
        encode_keys: bool | None = None,
    ):
        super().__init__(store, get_compact_revision, retry_min_revision,
                         compact_history, max_workers)
        self._device = resolve_device(device)
        self._partitions = int(partitions) or 1
        self._kw = key_width
        self._merge_threshold = merge_threshold
        self._host_limit_threshold = host_limit_threshold
        self._encode = _resolve_key_encoding(encode_keys)
        self._probe_cache: tuple[Mirror, list] | None = None
        self._mlock = threading.RLock()
        self._mirror: Mirror | None = None
        self._delta = _DeltaIndex()
        self._force_rebuild = True
        #: mirror rebuilds from the store (first publish included)
        self.full_rebuild_total = 0

    # ------------------------------------------------------------ write feed
    def record_version_rows(self, rows: list[tuple[bytes, int, bytes]]) -> None:
        with self._mlock:
            self._delta.extend(rows)
            if (self._mirror is not None
                    and len(self._delta) >= self._merge_threshold):
                self._force_rebuild = True

    def mark_uncertain(self) -> None:
        """A commit with unknowable outcome may or may not have produced
        rows; only the store knows, so the next read rebuilds from it."""
        with self._mlock:
            self._force_rebuild = True

    # -------------------------------------------------------------- publish
    def _ensure_published(self) -> None:
        with self._mlock:
            if self._force_rebuild or self._mirror is None:
                self._rebuild_from_store()

    def _rebuild_from_store(self) -> None:
        """Synchronous rebuild from the authoritative store; the caller
        holds ``_mlock``, so delta recording waits and no row is lost: a
        write the snapshot missed lands in the fresh delta."""
        snapshot = self._store.get_timestamp_oracle()
        lo, hi = coder.internal_range(b"", b"")
        rows: list[tuple[bytes, int, bytes]] = []
        for ikey, value in self._store.iter(lo, hi, snapshot_ts=snapshot):
            ukey, rev = coder.decode(ikey)
            if rev != 0:
                rows.append((ukey, rev, value))
        self._mirror = build_mirror(rows, self._device, self._kw, snapshot,
                                    n_parts=self._partitions,
                                    encode=self._encode)
        self._delta = _DeltaIndex()
        self._force_rebuild = False
        self._probe_cache = None
        self.full_rebuild_total += 1

    def publish(self) -> None:
        """Force the mirror fully up to date (startup hook)."""
        with self._mlock:
            if self._delta:
                self._force_rebuild = True
        self._ensure_published()

    # -------------------------------------------------------------- queries
    def _dev_mask(self, mirror: Mirror, start: bytes, end: bytes, read_rev: int):
        """Visibility (mask [P, N] device tensor, counts [P]) through K1 —
        with :meth:`_dev_mask_batch` the only place a scan kernel is
        launched, so count/range/stream cannot diverge."""
        starts, ends, unb, rrev = query_tensors(
            mirror.encoding, self._kw, [(start, end, read_rev)], self._device)
        return scan_kernels.visibility_mask_batch(
            mirror.keys_dev, mirror.revs_dev, mirror.tomb_dev,
            mirror.n_valid_dev, starts[0], ends[0], unb, rrev)

    def _dev_mask_batch(self, mirror: Mirror, specs):
        """Batched visibility for Q distinct ``(start, end, read_rev)``
        queries in ONE launch of K2. Q is padded to the next power of two
        with copies of query 0; ``(mask [Qpad, P, N], counts [Qpad, P])``
        cover the padded axis and callers slice ``[:len(specs)]``."""
        qpad = 1
        while qpad < len(specs):
            qpad *= 2
        padded = list(specs) + [specs[0]] * (qpad - len(specs))
        starts, ends, unb, rrevs = query_tensors(
            mirror.encoding, self._kw, padded, self._device)
        return scan_kernels.visibility_mask_batch_q(
            mirror.keys_dev, mirror.revs_dev, mirror.tomb_dev,
            mirror.n_valid_dev, starts, ends, unb, rrevs)

    def _dev_visible_indices(self, mask, counts, n_rows: int):
        """(total, flat p·N + row indices int64) from a device mask [P, N]:
        per-partition counts first (a tiny transfer), then the compacted
        index block [P, pow2(max count)] — O(visible rows) on the wire."""
        counts_h = _host_pull(counts)  # [P]; waits for the kernel
        total = int(counts_h.sum())
        if total == 0:
            return 0, np.empty(0, dtype=np.int64)
        size = _pow2_bucket(int(counts_h.max()), n_rows)
        out = _host_pull(_part_indices_of_mask(mask, size))
        pieces = [
            out[p, :c].astype(np.int64) + p * n_rows
            for p, c in enumerate(counts_h) if c
        ]
        return total, np.concatenate(pieces)

    def _materialize_visible(self, mirror: Mirror, idx: np.ndarray, overlay):
        """Visible rows (flat p·N + row indices) → sorted KeyValue list with
        the delta overlay merged — the ONE host materialization the single
        and query-batched range paths share."""
        n_rows = mirror.keys_host.shape[1]
        kvs: list[KeyValue] = []
        parts, rows = np.divmod(idx, n_rows)
        for p in np.unique(parts):
            p_rows = rows[parts == p]
            keys, values, revs = mirror.materialize(int(p), p_rows)
            for uk, val, rv in zip(keys, values, revs):
                if uk in overlay:
                    continue  # delta supersedes
                kvs.append(KeyValue(uk, val, int(rv)))
        for uk, entry in overlay.items():
            if entry is not None:
                kvs.append(KeyValue(uk, entry[1], entry[0]))
        kvs.sort(key=lambda kv: kv.key)
        return kvs

    def _published_view(self, start: bytes, end: bytes, read_rev: int):
        """(mirror, overlay) of one query, the mirror brought up to date."""
        self._snapshot_checked(read_rev)
        self._ensure_published()
        with self._mlock:
            return self._mirror, self._delta.overlay(start, end, read_rev)

    def range_(self, start: bytes, end: bytes, read_revision: int, limit: int = 0):
        if limit and limit <= self._host_limit_threshold:
            return super().range_(start, end, read_revision, limit)
        mirror, overlay = self._published_view(start, end, read_revision)
        with TRACER.stage("device_dispatch", device=True):
            mask, counts = self._dev_mask(mirror, start, end, read_revision)
        with TRACER.stage("device_compute", device=True):
            _total, idx = self._dev_visible_indices(
                mask, counts, mirror.keys_host.shape[1])
        with TRACER.stage("host_copy"):
            kvs = self._materialize_visible(mirror, idx, overlay)
        if limit:
            return kvs[:limit], len(kvs) > limit
        return kvs, False

    def scan_batch(self, queries):
        """B distinct Range/Count queries against ONE mirror snapshot = ONE
        launch of K2. ``queries`` holds ``("range", start, end, read_rev,
        limit)`` / ``("count", start, end, read_rev)`` tuples. Returns a list
        aligned with ``queries``: ``(kvs, more)`` for range, ``int`` for
        count, or an Exception instance (per-query demux). Results are
        byte-identical to sequential ``range_``/``count`` calls: bound
        packing, index extraction and host materialization reuse the
        single-query code."""
        out: list = [None] * len(queries)
        device: list[tuple[int, tuple]] = []
        for i, spec in enumerate(queries):
            kind, start, end, read_rev = spec[0], spec[1], spec[2], spec[3]
            try:
                if (kind == "range" and spec[4]
                        and spec[4] <= self._host_limit_threshold):
                    out[i] = Scanner.range_(self, start, end, read_rev, spec[4])
                    continue
                self._snapshot_checked(read_rev)
            except Exception as e:  # demuxed to this query's waiter
                out[i] = e
                continue
            device.append((i, spec))
        if not device:
            return out
        if len(device) == 1:
            i, spec = device[0]
            try:
                if spec[0] == "count":
                    out[i] = self.count(spec[1], spec[2], spec[3])
                else:
                    out[i] = self.range_(spec[1], spec[2], spec[3], spec[4])
            except Exception as e:
                out[i] = e
            return out
        self._ensure_published()
        with self._mlock:
            mirror = self._mirror
            overlays = [self._delta.overlay(s[1], s[2], s[3]) for _, s in device]
        with TRACER.stage("device_dispatch", device=True):
            mask, counts = self._dev_mask_batch(
                mirror, [(s[1], s[2], s[3]) for _, s in device])
            sel = np.zeros(int(mask.shape[0]), dtype=bool)
            for k, (_, s) in enumerate(device):
                sel[k] = s[0] == "range"  # counts (and pow2 pad) stay off-wire
        n_rows = mirror.keys_host.shape[1]
        assert int(mask.shape[2]) == n_rows, (mask.shape, n_rows)
        n_parts = int(mask.shape[1])
        stride = n_parts * n_rows
        idx = np.empty(0, dtype=np.int64)
        with TRACER.stage("device_compute", device=True):
            counts_h = _host_pull(counts)  # waits for the kernel; [Qpad, P]
            want = int(counts_h[sel].max()) if sel.any() else 0
            if want:
                size = _pow2_bucket(want, n_rows)
                sel_dev = torch.from_numpy(sel).to(mask.device)
                idx_parts = _host_pull(_part_indices_of_mask(
                    mask & sel_dev.view(-1, 1, 1), size))
                pieces = []
                for k in np.nonzero(sel)[0]:
                    base = int(k) * stride
                    for p in range(n_parts):
                        c = int(counts_h[k, p])
                        if c:
                            pieces.append(idx_parts[k, p, :c].astype(np.int64)
                                          + base + p * n_rows)
                if pieces:
                    idx = np.concatenate(pieces)
        with TRACER.stage("host_copy"):
            for k, (qi, spec) in enumerate(device):
                if spec[0] == "count":
                    out[qi] = self._overlay_corrected_count(
                        mirror, int(counts_h[k].sum()), overlays[k], spec[3])
                    continue
                lo = np.searchsorted(idx, k * stride)
                hi = np.searchsorted(idx, (k + 1) * stride)
                kvs = self._materialize_visible(
                    mirror, idx[lo:hi] - k * stride, overlays[k])
                limit = spec[4]
                out[qi] = (kvs[:limit], len(kvs) > limit) if limit else (kvs, False)
        return out

    def range_stream(self, start: bytes, end: bytes, read_revision: int,
                     batch_size: int = 300):
        """Device-indexed streaming list: bounded batches materialized on
        demand from the index list, with the delta overlay merged in key
        order — unbounded ranges never materialize in full on the host."""
        mirror, overlay = self._published_view(start, end, read_revision)
        mask, counts = self._dev_mask(mirror, start, end, read_revision)
        n_rows = mirror.keys_host.shape[1]
        _total, idx = self._dev_visible_indices(mask, counts, n_rows)
        extra = sorted(
            (k, v) for k, v in overlay.items() if v is not None
        )  # (key, (rev, value)) insertions, key-ascending

        def generate():
            ei = 0
            batch: list[KeyValue] = []

            def push(kv):
                nonlocal batch
                batch.append(kv)
                if len(batch) >= batch_size:
                    out, batch = batch, []
                    return out
                return None

            pos = 0
            while pos < len(idx):
                chunk = idx[pos : pos + 4096]
                pos += 4096
                parts, rows = np.divmod(chunk, n_rows)
                for p in np.unique(parts):
                    keys, values, revs = mirror.materialize(int(p), rows[parts == p])
                    for uk, val, rv in zip(keys, values, revs):
                        while ei < len(extra) and extra[ei][0] < uk:
                            full = push(KeyValue(extra[ei][0], extra[ei][1][1],
                                                 extra[ei][1][0]))
                            if full:
                                yield full
                            ei += 1
                        if uk in overlay:
                            continue  # superseded or tombstoned by the delta
                        full = push(KeyValue(uk, val, int(rv)))
                        if full:
                            yield full
            while ei < len(extra):
                full = push(KeyValue(extra[ei][0], extra[ei][1][1], extra[ei][1][0]))
                if full:
                    yield full
                ei += 1
            if batch:
                yield batch

        return generate()

    def count(self, start: bytes, end: bytes, read_revision: int) -> int:
        mirror, overlay = self._published_view(start, end, read_revision)
        with TRACER.stage("device_dispatch", device=True):
            _, counts = self._dev_mask(mirror, start, end, read_revision)
        with TRACER.stage("device_compute", device=True):
            total = int(_host_pull(counts).sum())
        return self._overlay_corrected_count(mirror, total, overlay, read_revision)

    def _overlay_corrected_count(self, mirror: Mirror, total: int, overlay,
                                 read_rev: int) -> int:
        """Count = device total + delta-overlay correction, with the mirror
        visibility probes of the overlay keys as one vectorized pass."""
        if not overlay:
            return total
        keys = list(overlay.keys())
        had = self._host_visible_batch(mirror, keys, read_rev)
        for uk, h in zip(keys, had):
            entry = overlay[uk]
            if entry is None and h:
                total -= 1
            elif entry is not None and not h:
                total += 1
        return total

    def _probe_views(self, mirror: Mirror) -> list:
        """Per-partition void views of the STORED key bytes (valid rows
        only), identity-cached per mirror: void rows compare as raw bytes,
        so one np.searchsorted resolves every probe of a partition."""
        with self._mlock:
            cached = self._probe_cache
            if cached is not None and cached[0] is mirror:
                return cached[1]
        w = mirror.keys_host.shape[2] * 4
        views = []
        for p in range(mirror.partitions):
            nv = int(mirror.n_valid[p])
            if nv == 0:
                views.append(np.empty(0, dtype=f"V{w}"))
                continue
            views.append(keyops.u8_void(
                keyops.chunks_to_u8(mirror.keys_host[p, :nv])))
        with self._mlock:
            cur = self._probe_cache
            if cur is not None and cur[0] is mirror:
                return cur[1]
            self._probe_cache = (mirror, views)
        return views

    def _host_visible_batch(self, mirror: Mirror, ukeys: list, read_rev: int) -> list:
        """Is each key visible in the published mirror at ``read_rev``?
        Probes grouped by partition, one searchsorted pass per partition
        against the cached byte view (in the mirror's compare domain; a key
        the dictionary cannot express is absent by construction), then a
        per-key revision pick."""
        if not ukeys:
            return []
        views = self._probe_views(mirror)
        by_part: dict[int, list[int]] = {}
        for j, uk in enumerate(ukeys):
            by_part.setdefault(self._partition_of(mirror, uk), []).append(j)
        out = [False] * len(ukeys)
        encoding = mirror.encoding
        for p, idxs in by_part.items():
            view = views[p]
            if view.shape[0] == 0:
                continue
            if encoding is not None:
                enc_probes = [(j, encoding.encode_probe(ukeys[j])) for j in idxs]
                idxs = [j for j, pb in enc_probes if pb is not None]
                if not idxs:
                    continue  # none of these keys is expressible → absent
                probes_u8 = np.stack([
                    np.frombuffer(pb, np.uint8)
                    for _j, pb in enc_probes if pb is not None])
            else:
                probes_u8 = keyops.chunks_to_u8(np.stack([
                    keyops.pack_one(ukeys[j], self._kw) for j in idxs
                ]))
            probes = keyops.u8_void(probes_u8)
            lo = np.searchsorted(view, probes, side="left")
            hi = np.searchsorted(view, probes, side="right")
            revs = mirror.revs_host[p]
            tombs = mirror.tomb_host[p]
            for j, l, h in zip(idxs, lo, hi):
                if l == h:
                    continue  # key absent from the mirror
                # rows of one key are revision-ascending: last rev <= read_rev
                pos = int(l) + int(np.searchsorted(
                    revs[l:h], np.uint64(read_rev), side="right")) - 1
                if pos >= l:
                    out[j] = not bool(tombs[pos])
        return out

    @staticmethod
    def _partition_of(mirror: Mirror, ukey: bytes) -> int:
        p = 0
        for i, fk in enumerate(mirror.partition_first_keys()):
            if fk and fk <= ukey:
                p = i
        return p


class CudaKvStorage(KvStorage):
    """Decorator pairing a host engine with a TorchScanner delta feed.

    Every committed Put to an object key (revision >= 1) is a version row
    for the mirror; uncertain commits force a rebuild from the store."""

    def __init__(self, inner: KvStorage, device=None,
                 key_width: int = keyops.KEY_WIDTH, partitions: int = 0,
                 **scanner_kw):
        self._inner = inner
        self._device = resolve_device(device)
        self._kw = key_width
        self._partitions = partitions
        self._scanner_kw = scanner_kw
        self._scanner: TorchScanner | None = None
        # expose the single-call fast paths only when the host engine has
        # them (instance attributes so hasattr() reflects capability)
        if hasattr(inner, "mvcc_write"):
            self.mvcc_write = self._mvcc_write_tracked
        if hasattr(inner, "mvcc_delete"):
            self.mvcc_delete = self._mvcc_delete_tracked
        if hasattr(inner, "write_batch"):
            self.write_batch = self._write_batch_tracked

    # ---- scanner wiring (Backend calls make_scanner)
    def make_scanner(self, **kw) -> TorchScanner:
        kw.update(self._scanner_kw)
        self._scanner = TorchScanner(self, device=self._device,
                                     key_width=self._kw,
                                     partitions=self._partitions, **kw)
        return self._scanner

    # ---- engine delegation
    def get_timestamp_oracle(self) -> int:
        return self._inner.get_timestamp_oracle()

    def get_partitions(self, start: bytes, end: bytes) -> list[Partition]:
        """Mirror-partition-aligned shard map, so host-fallback scans split
        the way the device does."""
        mirror = self._scanner._mirror if self._scanner else None
        if mirror is None:
            return self._inner.get_partitions(start, end)
        firsts = [fk for fk in mirror.partition_first_keys() if fk]
        borders = [coder.encode_revision_key(fk) for fk in firsts]
        out, left = [], start
        for b in borders:
            if left < b and (not end or b < end):
                out.append(Partition(left, b))
                left = b
        out.append(Partition(left, end))
        return out

    def get(self, key: bytes, snapshot_ts: int | None = None) -> bytes:
        return self._inner.get(key, snapshot_ts)

    def iter(self, start: bytes, end: bytes, snapshot_ts: int | None = None, limit: int = 0):
        return self._inner.iter(start, end, snapshot_ts, limit)

    def begin_batch_write(self) -> BatchWrite:
        return _TrackedBatch(self._inner.begin_batch_write(), self)

    def support_ttl(self) -> bool:
        return self._inner.support_ttl()

    def exclusive_client(self) -> KvStorage:
        return self

    def untracked(self) -> KvStorage:
        """Raw inner engine, whose writes bypass the mirror's delta feed."""
        return self._inner.exclusive_client()

    def close(self) -> None:
        self._inner.close()

    def _mvcc_write_tracked(self, rev_key, rev_val, expected, obj_key, obj_val,
                            last_key, last_val, ttl_seconds=0):
        self._inner.mvcc_write(
            rev_key, rev_val, expected, obj_key, obj_val, last_key, last_val, ttl_seconds
        )
        if coder.is_internal_key(obj_key):
            ukey, rev = coder.decode(obj_key)
            if rev != 0:
                self._on_committed([(ukey, rev, obj_val)])

    def _write_batch_tracked(self, ops: list) -> list:
        """Grouped commit through the inner engine, with the whole group's
        committed version rows recorded into the delta in ONE call, in
        revision order. Per-op uncertainty forces a rebuild exactly like a
        lone uncertain commit."""
        try:
            results = self._inner.write_batch(ops)
        except UncertainResultError:
            self._on_uncertain()
            raise
        rows: list[tuple[bytes, int, bytes]] = []
        uncertain = False
        for op, res in zip(ops, results):
            status = res[0]
            if status == "uncertain":
                uncertain = True
                continue
            if status != "ok":
                continue
            if op[0] == "delete":
                # ("delete", rev_key, expected_rev, new_rev, new_record,
                #  tombstone, ...)
                rev_key, new_rev, tombstone = op[1], op[3], op[5]
                if coder.is_internal_key(rev_key):
                    rows.append((coder.decode(rev_key)[0], new_rev, tombstone))
            else:
                # ("create", rev_key, new_rev, rev_val, obj_key, obj_val, ...)
                # ("update", rev_key, rev_val, expected, obj_key, obj_val, ...)
                # — both shapes carry (obj_key, obj_val) at slots 4/5
                obj_key, obj_val = op[4], op[5]
                if coder.is_internal_key(obj_key):
                    ukey, rev = coder.decode(obj_key)
                    if rev != 0:
                        rows.append((ukey, rev, obj_val))
        if uncertain:
            self._on_uncertain()
        elif rows:
            self._on_committed(rows)
        return results

    def _mvcc_delete_tracked(self, rev_key, expected_rev, new_rev, new_record,
                             tombstone, last_key, last_val):
        result = self._inner.mvcc_delete(
            rev_key, expected_rev, new_rev, new_record, tombstone, last_key, last_val
        )
        if result[0] == "ok" and coder.is_internal_key(rev_key):
            ukey, _ = coder.decode(rev_key)
            self._on_committed([(ukey, new_rev, tombstone)])
        return result

    def _on_committed(self, rows: list[tuple[bytes, int, bytes]]) -> None:
        if self._scanner is not None and rows:
            self._scanner.record_version_rows(rows)

    def _on_uncertain(self) -> None:
        if self._scanner is not None:
            self._scanner.mark_uncertain()


class _TrackedBatch(BatchWrite):
    def __init__(self, inner: BatchWrite, owner: CudaKvStorage):
        self._inner = inner
        self._owner = owner
        self._rows: list[tuple[bytes, int, bytes]] = []
        self._deletes_object_rows = False

    def _track(self, key: bytes, value: bytes) -> None:
        if coder.is_internal_key(key):
            ukey, rev = coder.decode(key)
            if rev != 0:
                self._rows.append((ukey, rev, value))

    def put_if_not_exist(self, key, value, ttl_seconds=0):
        self._track(key, value)
        self._inner.put_if_not_exist(key, value, ttl_seconds)

    def cas(self, key, new_value, old_value, ttl_seconds=0):
        self._track(key, new_value)
        self._inner.cas(key, new_value, old_value, ttl_seconds)

    def put(self, key, value, ttl_seconds=0):
        self._track(key, value)
        self._inner.put(key, value, ttl_seconds)

    def delete(self, key):
        if coder.is_internal_key(key) and coder.decode(key)[1] != 0:
            self._deletes_object_rows = True
        self._inner.delete(key)

    def del_current(self, key, expected_value):
        if coder.is_internal_key(key) and coder.decode(key)[1] != 0:
            self._deletes_object_rows = True
        self._inner.del_current(key, expected_value)

    def commit(self):
        try:
            self._inner.commit()
        except UncertainResultError:
            self._owner._on_uncertain()
            raise
        # external deletes of version rows invalidate the mirror; anything
        # else feeds the delta
        if self._deletes_object_rows:
            self._owner._on_uncertain()
        else:
            self._owner._on_committed(self._rows)
        self._rows = []


def _cuda_factory(inner: str = "memkv", device=None,
                  key_width: int = keyops.KEY_WIDTH, partitions: int = 0,
                  encode_keys: bool | None = None, merge_threshold: int = 0,
                  **inner_kw) -> CudaKvStorage:
    from .. import new_storage

    dev = resolve_device(device)  # no card and no explicit CPU: raise here
    scanner_kw = {}
    if encode_keys is not None:
        scanner_kw["encode_keys"] = encode_keys
    if merge_threshold:
        scanner_kw["merge_threshold"] = merge_threshold
    return CudaKvStorage(new_storage(inner, **inner_kw), device=dev,
                         key_width=key_width, partitions=partitions,
                         **scanner_kw)


register_engine("cuda", _cuda_factory)
