"""The ``cuda`` storage engine: host-authoritative store + GPU scan mirror.

Counterpart of ``kubebrain_tpu/storage/tpu/engine.py``:

- **writes / point reads / CAS**: delegated to a host engine (memkv,
  native or remote); the mirror is built from the engine's C++ bulk export
  where it has one (``export_mvcc``), else row by row;
- **range scans / counts**: the device mirror (``blocks.Mirror``) and the
  CUDA visibility kernels K1/K2 (``ops/scan_kernels.py``), then a
  per-partition mask→index compaction in PyTorch ops (J1) so the host pulls
  O(visible rows), never the mask;
- **mesh**: the mirror's partitions split over the ``part`` slots of a
  mesh (``parallel/mesh.py``; default every visible card on ``cuda``, one
  slot on the CPU). K1/K2/K3 launch once per slot on that slot's shard, J1
  and J3 stay slot-local, and the counts are summed on the host (the JAX
  engine's ``psum``, ``_maybe_shard_map``,
  ``kubebrain_tpu/storage/tpu/engine.py:191-218``);
- **freshness**: committed version rows are appended to a host-side delta
  index by the batch decorator, which seals them into sorted stored-domain
  blocks; queries overlay it (every delta revision exceeds every published
  revision, so overlay-wins resolution is exact). A delta past
  ``merge_threshold`` is merged into the dirty partitions in the stored
  domain, off the engine lock, by a write-kicked background merge (or by
  the read that crosses the threshold); a rebuild from the store is the
  fallback for an overflowed dictionary, a width drift or an empty mirror;
- **uncertain commits** quarantine the mirror: reads go to the host
  ``Scanner`` over the store while a single-flight background rebuild runs;
- **compaction**: the CUDA victim-mask kernel K3 (``ops/compact_kernels.py``)
  marks, the host deletes the victims from the store (decoding victim rows
  only), and the survivors are gathered in the stored domain with any
  pending delta merged in (``blocks.compact_partitions_stored``).
"""

from __future__ import annotations

import bisect
import functools
import logging
import os
import random
import threading
import time

import numpy as np
import torch

from ... import coder
from ...backend.common import TOMBSTONE, KeyValue
from ...backend import scanner as scanner_mod
from ...backend.scanner import CompactHistory, CompactStats, Scanner
from ...device import _host_pull, _pow2_bucket, resolve_device
from ...ops import compact_kernels, launch_owner, scan_kernels
from ...ops import keys as keyops
from ...ops.scan import flip_sign
from ...parallel import mesh as mesh_mod
from ...parallel.mesh import Mesh, make_mesh
from ...trace import TRACER
from .. import BatchWrite, CASFailedError, KvStorage, Partition, register_engine
from ..errors import StorageError, UncertainResultError
from .blocks import (
    Mirror,
    build_mirror,
    build_mirror_from_arrays,
    compact_partitions_stored,
    compute_ttl_flags,
    merge_partitions_stored,
    merge_sorted_arrays,
    merge_sorted_stored,
    rows_to_arrays,
)
from .encode import EncodeOverflow


class _DeltaIndex:
    """Commit-order delta rows plus a sorted key index, so read overlays
    cost O(log d + matches) instead of a full scan of the delta per query.
    Writers append; per-key revision lists only grow.

    The index also accumulates the rows into sealed, sorted STORED-domain
    blocks (``seal_rows`` rows each, encoded against the published
    dictionary when the mirror is encoded), so the incremental merge
    (:func:`blocks.merge_partitions_stored`) interleaves ready-made sorted
    runs instead of sorting and encoding the whole delta at merge time. A
    key the dictionary cannot express marks the index ``overflowed``; the
    merge then rebuilds from the store."""

    __slots__ = ("_rows", "_keys", "_by_key", "_width", "_encoding",
                 "_seal_rows", "_blocks", "_sealed_upto", "_overflow")

    def __init__(self, width: int = keyops.KEY_WIDTH, encoding=None,
                 seal_rows: int = 512):
        self._rows: list[tuple[bytes, int, bytes]] = []
        self._keys: list[bytes] = []  # sorted, unique
        self._by_key: dict[bytes, list[tuple[int, bytes]]] = {}
        self._width = width
        self._encoding = encoding
        self._seal_rows = max(1, seal_rows)
        self._blocks: list[tuple] = []  # sealed stored-domain septuples
        self._sealed_upto = 0
        self._overflow = False

    def extend(self, rows) -> None:
        for ukey, rev, value in rows:
            self._rows.append((ukey, rev, value))
            lst = self._by_key.get(ukey)
            if lst is None:
                self._by_key[ukey] = [(rev, value)]
                bisect.insort(self._keys, ukey)
            else:
                lst.append((rev, value))
        while len(self._rows) - self._sealed_upto >= self._seal_rows:
            hi = self._sealed_upto + self._seal_rows
            self._seal(self._rows[self._sealed_upto:hi])
            self._sealed_upto = hi

    def _seal(self, rows: list[tuple[bytes, int, bytes]]) -> None:
        """Sort one run and move it into the mirror's stored domain."""
        k, lens, r, t, arena, off = merge_sorted_arrays(
            rows_to_arrays([], self._width), rows_to_arrays(rows, self._width))
        ttl = compute_ttl_flags(k, lens)
        if self._encoding is not None and not self._overflow:
            try:
                k, lens = self._encoding.encode_keys(k, lens)
            except EncodeOverflow:
                self._overflow = True  # the merge rebuilds from the store
        self._blocks.append((k, np.asarray(lens, np.int32), r, t, ttl,
                             arena, off))

    def snapshot_blocks(self) -> tuple[list[tuple], list, bool]:
        """Seal the open tail and return ``(sealed blocks, raw-row prefix,
        overflowed)``, the merge's input. Rows appended after this call
        stay in the index; :meth:`tail_rows` returns them."""
        if self._sealed_upto < len(self._rows):
            self._seal(self._rows[self._sealed_upto:])
            self._sealed_upto = len(self._rows)
        return list(self._blocks), self._rows[: self._sealed_upto], self._overflow

    def tail_rows(self, n: int) -> list[tuple[bytes, int, bytes]]:
        """Rows appended after a ``snapshot_blocks`` that covered ``n``."""
        return self._rows[n:]

    def force_overflow(self) -> None:
        """Mark the index overflowed (chaos hook: a forced EncodeOverflow):
        the next merge rebuilds from the store, exactly as if a sealed key
        had been inexpressible."""
        self._overflow = True

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


def _part_survivor_indices(mask: torch.Tensor, n_valid: torch.Tensor,
                           size: int) -> torch.Tensor:
    """J3: per-partition SURVIVOR row indices [P, size] (fill = N) of a
    victim mask [P, N] (counterpart of ``_part_survivor_indices``,
    ``storage/tpu/engine.py:354``). The victim side needs no such helper:
    the kernel already gates validity, so ``_part_indices_of_mask`` serves
    it directly."""
    rows = torch.arange(mask.shape[-1], device=mask.device)
    valid = rows.unsqueeze(0) < n_valid.to(torch.int64).unsqueeze(1)
    return _part_indices_of_mask(valid & ~mask, size)


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


def placement(device=None, mesh=None) -> tuple[torch.device, list]:
    """(device, part slots) of a mirror (``parallel.mesh.placement``).
    Without a mesh: every visible card for ``cuda`` with no index (the JAX
    engine's every-device default, ``storage/tpu/engine.py:463``), else
    one slot on ``device``."""
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            mesh = make_mesh(device=dev)
    return mesh_mod.placement(device, mesh, "part")


def partition_count(partitions: int, slots: list) -> int:
    """--scan-partitions: the mirror's partition count, decoupled from the
    slot count (0 = one per slot), and a multiple of it, so that each slot
    holds P/D contiguous partitions (``storage/tpu/engine.py:464-471``)."""
    if partitions and partitions % len(slots):
        raise ValueError(
            f"partitions={partitions} must be a multiple of the mesh "
            f"part-axis size {len(slots)}")
    return int(partitions) or len(slots)


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

    #: the name this scanner's kernel launches are also counted under
    #: (``ops/launch_owner.py``); None counts them under nobody
    launch_owner: str | None = None

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
        mesh=None,
    ):
        super().__init__(store, get_compact_revision, retry_min_revision,
                         compact_history, max_workers)
        self._device, self._slots = placement(device, mesh)
        self._partitions = partition_count(partitions, self._slots)
        self._kw = key_width
        self._merge_threshold = merge_threshold
        self._host_limit_threshold = host_limit_threshold
        self._encode = _resolve_key_encoding(encode_keys)
        self._probe_cache: tuple[Mirror, list] | None = None
        self._mlock = threading.RLock()
        # mergers (delta merge, compaction, offline rebuild) serialize on
        # their own lock and do the heavy work off _mlock, so readers keep
        # serving mirror + overlay. Lock order: _merge_lock before _mlock.
        self._merge_lock = threading.Lock()
        self._merge_kick = threading.Lock()    # single-flight background merge
        self._rebuild_kick = threading.Lock()  # single-flight background rebuild
        self._mirror: Mirror | None = None
        self._delta = _DeltaIndex(self._kw)
        self._force_rebuild = True
        #: synchronous mirror builds from the store: the first publish, a
        #: merge that could not stay incremental, a merge escalation and the
        #: compaction's full-rebuild rung
        self.full_rebuild_total = 0
        #: mirror builds from the store by path (``_build_mirror_from_store``)
        self.mirror_builds = {"export": 0, "rows": 0}
        self.merge_count = 0
        self.merge_rows_total = 0
        # background-merge failures: counted, last error kept. Written from
        # background workers and the read path, hence the lock.
        self._merr_lock = threading.Lock()
        self.merge_bg_errors = 0
        self._merge_bg_last_error: Exception | None = None
        self.merge_retries_total = 0
        self.merge_escalations_total = 0
        self._merge_max_retries = 4
        self.compact_count = 0
        self.compact_victims_total = 0
        self.compact_survivor_rows_total = 0
        self.compact_retries_total = 0
        self.compact_escalations_total = 0
        self.compact_errors = 0
        self._compact_last_error: Exception | None = None
        # True while a compaction holds _merge_lock for its whole pass:
        # read-path threshold merges skip instead of parking on the lock
        # (mirror + overlay stays exact). Guarded by _mlock.
        self._compact_active = False
        # mirror state machine: serving | quarantined | rebuilding. While not
        # serving, reads go to the host Scanner over the authoritative store.
        self._mirror_state = "serving"
        self._poison_epoch = 0
        self._degraded_since = 0.0
        self.degraded_seconds_total = 0.0
        self.rebuild_bg_count = 0
        self._metrics = None
        self._gauge_regs: list[tuple[str, dict]] = []
        self._fault_plane = None  # optional chaos-mode injection hooks

    # -------------------------------------------------------------- metrics
    def register_metrics(self, metrics) -> None:
        """Callback gauges (counterpart of ``storage/tpu/engine.py:554``):
        ``kb.mirror.state{state=}``, one 0/1 series per state of the mirror
        state machine, and per distinct device of the mesh the bytes of the
        slots it holds, ``kb.mirror.bytes{device=}``, beside
        ``kb.mirror.raw.bytes{device=}``, what the same rows would take with
        raw keys. All are unregistered
        at :meth:`close`. The same sink takes the engine's counters and
        histograms (``kb.degraded.seconds``, ``kb.mirror.merge.*``,
        ``kb.compact.*``), emitted where the JAX engine emits them."""
        if metrics is None:
            return
        self._metrics = metrics
        for state in ("serving", "quarantined", "rebuilding"):
            metrics.register_gauge_fn(
                "kb.mirror.state", functools.partial(self._state_gauge, state),
                state=state)
            self._gauge_regs.append(("kb.mirror.state", {"state": state}))
        for device in dict.fromkeys(str(d) for d in self._slots):
            for name, raw in (("kb.mirror.bytes", False),
                              ("kb.mirror.raw.bytes", True)):
                metrics.register_gauge_fn(
                    name, functools.partial(self._mirror_device_bytes,
                                            device, raw),
                    device=device)
                self._gauge_regs.append((name, {"device": device}))

    def close(self) -> None:
        # the callback gauges close over the live mirror: drop them, so a
        # closed scanner's mirror is not kept reachable and scraped
        if self._metrics is not None:
            for name, tags in self._gauge_regs:
                self._metrics.unregister_gauge_fn(name, **tags)
            self._gauge_regs = []
        super().close()

    def _state_gauge(self, state: str) -> float:
        return 1.0 if self._mirror_state == state else 0.0

    def _mirror_device_bytes(self, device: str,
                             raw_equivalent: bool = False) -> float:
        """Bytes of the published mirror's device columns on ``device``,
        summed over the slots it holds (shapes only, no copy).
        ``raw_equivalent`` rescales the key column to the raw packed width:
        the bytes an un-encoded mirror of the same rows would hold."""
        mirror = self._mirror
        if mirror is None:
            return 0.0
        total = 0
        for sh in mirror.shards:
            if str(sh.device) != device:
                continue
            for t in (sh.keys, sh.revs, sh.tomb, sh.ttl, sh.n_valid):
                nbytes = t.numel() * t.element_size()
                if (raw_equivalent and t is sh.keys
                        and mirror.encoding is not None):
                    nbytes = (nbytes // mirror.encoding.chunks
                              * (mirror.raw_key_width // 4))
                total += nbytes
        return float(total)

    def encoding_stats(self) -> dict:
        """Footprint of the PUBLISHED mirror and the compaction accounting
        (the keys and definitions of ``storage/tpu/engine.py:624``). A row
        holds its key chunks, one int64 revision (the JAX package's hi/lo
        pair, also 8 bytes) and the tombstone and TTL flags."""
        mirror = self._mirror
        if mirror is None:
            return {}
        rows = mirror.rows
        stored_w = mirror.keys_host.shape[2] * 4
        per_row = stored_w + 8 + 2
        cap = mirror.keys_host.shape[0] * mirror.keys_host.shape[1]
        enc = mirror.encoding
        return {
            "rows": rows,
            "mirror_bytes_per_row": float(per_row),
            "mirror_bytes_per_row_padded": round(per_row * cap / rows, 2)
            if rows else 0.0,
            "key_bytes_per_row": stored_w,
            "raw_key_bytes_per_row": mirror.raw_key_width,
            "key_compression_ratio": round(mirror.raw_key_width / stored_w, 3),
            "encoded": enc is not None,
            "dict_entries": len(enc.boundaries) if enc is not None else 0,
            "suffix_width": enc.suffix_width if enc is not None else 0,
            "compact_count": self.compact_count,
            "compact_victims_total": self.compact_victims_total,
            "compact_survivor_rows_total": self.compact_survivor_rows_total,
            "compact_retries_total": self.compact_retries_total,
            "compact_escalations_total": self.compact_escalations_total,
            "full_rebuild_total": self.full_rebuild_total,
        }

    # ---------------------------------------------------------- degradation
    def set_fault_plane(self, plane) -> None:
        """Arm chaos-mode injection: forced merge failures, merge
        suppression (the delta grows past the threshold) and a forced
        EncodeOverflow. ``plane`` has ``merge_fault()``,
        ``merge_fail_active()``, ``merges_suppressed()``,
        ``note_suppressed_merge()``, ``compact_fault()`` and
        ``encode_overflow()``; ``None`` disarms."""
        self._fault_plane = plane

    def _enter_degraded_locked(self, state: str) -> None:
        """Under ``_mlock``: into quarantined/rebuilding; the degraded clock
        starts on the first transition out of serving."""
        if self._mirror_state == "serving":
            self._degraded_since = time.monotonic()
        self._mirror_state = state

    def _exit_degraded_locked(self) -> None:
        """Under ``_mlock``: back to serving, the degraded window counted."""
        if self._mirror_state != "serving":
            dt = time.monotonic() - self._degraded_since
            self.degraded_seconds_total += dt
            if self._metrics is not None:
                self._metrics.emit_counter("kb.degraded.seconds", dt)
        self._mirror_state = "serving"

    def _degraded(self) -> bool:
        """True while the mirror is quarantined or rebuilding: the query
        paths then serve from the host store, and the background rebuild is
        kicked again in case an earlier attempt gave up."""
        with self._mlock:
            degraded = self._mirror_state != "serving"
        if degraded:
            self._kick_rebuild()
        return degraded

    def _kick_rebuild(self) -> None:
        """Single-flight background rebuild from the store, with bounded
        jittered-backoff retries: recovery never runs on a reader's thread."""
        if not self._rebuild_kick.acquire(blocking=False):
            return

        def run() -> None:
            try:
                backoff = 0.05
                for _attempt in range(16):
                    try:
                        if self._rebuild_offline():
                            return
                    except Exception:
                        with self._merr_lock:
                            self.merge_bg_errors += 1
                        self._emit_counter("kb.mirror.merge.errors")
                    time.sleep(backoff * random.uniform(0.5, 1.5))
                    backoff = min(backoff * 2.0, 1.0)
                # gave up: stay quarantined; the next degraded read re-kicks
            finally:
                self._rebuild_kick.release()

        try:
            threading.Thread(target=run, name="kb-mirror-rebuild",
                             daemon=True).start()
        except BaseException:
            self._rebuild_kick.release()
            raise

    def _rebuild_offline(self) -> bool:
        """One rebuild attempt off the engine lock: build a fresh mirror
        from the store, then swap under ``_mlock``. Returns False when a
        newer poisoning superseded it (the caller retries)."""
        with self._merge_lock:
            with self._mlock:
                if not self._force_rebuild and self._mirror is not None:
                    self._exit_degraded_locked()
                    return True  # something else already recovered
                epoch = self._poison_epoch
                delta0 = self._delta
                n0 = len(delta0)
                self._enter_degraded_locked("rebuilding")
            m = self._build_mirror_from_store()
            with self._mlock:
                if self._poison_epoch != epoch or self._delta is not delta0:
                    # poisoned again, or a foreground rebuild swapped state
                    # meanwhile: never overwrite fresher state
                    return not self._force_rebuild and self._mirror is not None
                self._mirror = m
                tail = self._delta.tail_rows(n0)
                self._force_rebuild = False
                self._delta = self._fresh_delta()
                if tail:
                    self._delta.extend(tail)
                self._probe_cache = None
                self.rebuild_bg_count += 1
                self._exit_degraded_locked()
        return True

    # ------------------------------------------------------------ write feed
    def record_version_rows(self, rows: list[tuple[bytes, int, bytes]]) -> None:
        plane = self._fault_plane
        with self._mlock:
            self._delta.extend(rows)
            if plane is not None and plane.encode_overflow():
                # chaos: an inexpressible key landed; the next merge
                # rebuilds from the store
                self._delta.force_overflow()
            healthy = self._mirror is not None and not self._force_rebuild
            kick = healthy and (
                len(self._delta) >= self._merge_threshold
                # an open merge-fail window kicks eagerly, so the failing
                # merge's retries and escalation actually run
                or (plane is not None and len(self._delta) > 0
                    and plane.merge_fail_active()))
            pending = len(self._delta) > 0
        if plane is not None and plane.merges_suppressed():
            # chaos: merges suppressed; the delta grows and readers pay the
            # (exact) overlay. Each write onto a pending delta counts one
            # denied merge.
            if pending:
                plane.note_suppressed_merge()
            return
        if kick:
            self._kick_merge()

    def _kick_merge(self) -> None:
        """Single-flight background incremental merge, started by the write
        that crosses the threshold; a kick while one runs is dropped (the
        next crossing re-kicks, ``publish()`` sweeps any tail). A failing
        merge retries with jittered backoff, then escalates to one rebuild
        from the store, quarantining meanwhile; readers keep serving
        mirror + overlay, which stays exact, until then."""
        if not self._merge_kick.acquire(blocking=False):
            return

        def run() -> None:
            try:
                backoff = 0.05
                for attempt in range(self._merge_max_retries):
                    try:
                        self._merge_delta()
                        return
                    except Exception as e:
                        with self._merr_lock:
                            self.merge_bg_errors += 1
                            self._merge_bg_last_error = e
                        self._emit_counter("kb.mirror.merge.errors")
                        if attempt + 1 >= self._merge_max_retries:
                            break
                        self.merge_retries_total += 1
                        self._emit_counter("kb.mirror.merge.retries")
                        time.sleep(backoff * random.uniform(0.5, 1.5))
                        backoff = min(backoff * 2.0, 1.0)
                self.merge_escalations_total += 1
                self._emit_counter("kb.mirror.merge.escalations")
                try:
                    with self._mlock:
                        self._force_rebuild = True
                        self._poison_epoch += 1
                        self._enter_degraded_locked("quarantined")
                        if self._mirror is not None:
                            self.full_rebuild_total += 1
                    self._rebuild_offline()
                except Exception as e:  # keep the failure visible
                    with self._merr_lock:
                        self._merge_bg_last_error = e
                    self._emit_counter("kb.mirror.merge.errors")
            finally:
                self._merge_kick.release()

        try:
            threading.Thread(target=run, name="kb-mirror-merge",
                             daemon=True).start()
        except BaseException:
            self._merge_kick.release()
            raise

    def mark_uncertain(self) -> None:
        """A commit with unknowable outcome may or may not have produced
        rows; only the store knows. The mirror quarantines: reads go to the
        host store while a single-flight background rebuild runs."""
        with self._mlock:
            self._force_rebuild = True
            self._poison_epoch += 1
            self._enter_degraded_locked("quarantined")
        self._kick_rebuild()

    # -------------------------------------------------------------- publish
    def _ensure_published(self, full: bool = False) -> None:
        plane = self._fault_plane
        with self._mlock:
            if self._force_rebuild or self._mirror is None:
                self._rebuild_from_store()
                return
            want_merge = len(self._delta) and (
                full or len(self._delta) >= self._merge_threshold)
            if not want_merge or (not full and self._compact_active):
                return
        if not full and plane is not None and plane.merges_suppressed():
            # chaos: serve mirror + overlay (still exact); each read that
            # would have merged counts one suppressed merge
            plane.note_suppressed_merge()
            return
        if full:
            self._merge_delta()
            return
        try:
            self._merge_delta()
        except Exception as e:
            # a failed read-path merge must not fail the read: mirror +
            # overlay is still exact, only larger
            with self._merr_lock:
                self.merge_bg_errors += 1
                self._merge_bg_last_error = e
            self._emit_counter("kb.mirror.merge.errors")

    def _build_mirror_from_store(self) -> Mirror:
        """A fresh Mirror from the authoritative store. Pure read: the only
        scanner state it changes is ``mirror_builds``, which counts the
        builds by path: ``export`` when the inner engine's C++ bulk export
        (``export_mvcc``) returned numpy arrays, ``rows`` when the rows were
        iterated one by one (an engine without the export, or whose export
        failed with a ``StorageError``, such as a ``kbstored`` that predates
        it)."""
        snapshot = self._store.get_timestamp_oracle()
        lo, hi = coder.internal_range(b"", b"")
        exporter = getattr(self._store, "untracked", lambda: self._store)()
        if hasattr(exporter, "export_mvcc"):
            try:
                arrays = exporter.export_mvcc(lo, hi, snapshot, self._kw,
                                              coder.MAGIC, TOMBSTONE)
            except StorageError as exc:
                logging.getLogger("kubebrain").warning(
                    "bulk export unavailable (%s); mirror build falling back "
                    "to per-row iteration", exc)
            else:
                self.mirror_builds["export"] += 1
                return build_mirror_from_arrays(
                    *arrays, self._slots, self._kw, snapshot,
                    n_parts=self._partitions, encode=self._encode)
        self.mirror_builds["rows"] += 1
        rows: list[tuple[bytes, int, bytes]] = []
        for ikey, value in self._store.iter(lo, hi, snapshot_ts=snapshot):
            ukey, rev = coder.decode(ikey)
            if rev != 0:
                rows.append((ukey, rev, value))
        return build_mirror(rows, self._slots, self._kw, snapshot,
                            n_parts=self._partitions, encode=self._encode)

    def _rebuild_from_store(self) -> None:
        """Synchronous rebuild; the caller holds ``_mlock``, so delta
        recording waits and no row is lost: a write the snapshot missed
        lands in the fresh delta."""
        self._mirror = self._build_mirror_from_store()
        self._delta = self._fresh_delta()
        self._force_rebuild = False
        self._probe_cache = None
        self.full_rebuild_total += 1
        self._exit_degraded_locked()

    def _fresh_delta(self) -> _DeltaIndex:
        """A delta index bound to the current mirror's stored domain, so
        write-time sealing encodes against the published dictionary."""
        enc = self._mirror.encoding if self._mirror is not None else None
        seal = max(64, min(512, self._merge_threshold // 4 or 64))
        return _DeltaIndex(self._kw, encoding=enc, seal_rows=seal)

    def _merge_delta(self) -> None:
        """Incremental delta merge, off the engine lock (counterpart of
        ``storage/tpu/engine.py:1010``). The sealed stored-domain blocks are
        k-way interleaved (:func:`merge_sorted_stored`) and land in the
        dirty partitions only (:func:`merge_partitions_stored`); readers
        keep serving mirror + overlay, and the swap under ``_mlock`` keeps
        every row appended after the snapshot in the successor overlay. An
        overflowed delta or a width drift rebuilds from the store instead,
        also off the lock; an empty or poisoned mirror rebuilds under it.
        Both count in ``full_rebuild_total``."""
        plane = self._fault_plane
        if plane is not None and plane.merge_fault():
            # chaos: fail before any state changes; readers keep serving
            # mirror + overlay, the retries and the escalation recover
            raise RuntimeError("injected merge failure (fault plane)")
        with self._merge_lock:
            t0 = time.monotonic()
            with self._mlock:
                if self._force_rebuild or self._mirror is None:
                    self._rebuild_from_store()
                    return
                mirror = self._mirror
                blocks, rows_prefix, overflow = self._delta.snapshot_blocks()
            n_rows = len(rows_prefix)
            if n_rows == 0:
                return
            ts = self._store.get_timestamp_oracle()
            m = None
            if not overflow:
                m = merge_partitions_stored(mirror, merge_sorted_stored(blocks),
                                            ts)
            full = m is None
            if full:
                # an overflowed delta or a width drift: a fresh mirror from
                # the store (the JAX engine merges the decoded rows and
                # re-partitions), built off the engine lock as the JAX
                # engine builds its full merge, so writes and reads go on;
                # rows recorded since the snapshot stay in the delta
                m = self._build_mirror_from_store()
            with self._mlock:
                if self._mirror is not mirror:
                    return  # superseded by a fresher mirror from the store
                self.merge_count += 1
                self._mirror = m
                tail = self._delta.tail_rows(n_rows)
                self._delta = self._fresh_delta()
                if tail:
                    self._delta.extend(tail)
                self._probe_cache = None
                if full:
                    self.full_rebuild_total += 1
                else:
                    self.merge_rows_total += n_rows
                dt = time.monotonic() - t0
            if self._metrics is not None:
                self._metrics.emit_histogram(
                    "kb.mirror.merge.seconds", dt,
                    kind="full_rebuild" if full else "incremental")
                if not full:
                    self._metrics.emit_counter("kb.mirror.merge.rows.total",
                                               n_rows)

    def publish(self) -> None:
        """Force the mirror fully up to date (startup hook)."""
        self._ensure_published(full=True)

    # -------------------------------------------------------------- queries
    def _per_slot(self, mirror: Mirror, kernel, *query):
        """``kernel(shard columns, *query)`` on every shard of ``mirror``,
        the query's tensors moved to each slot → ``([mask], [counts])``, one
        pair per slot. Every launch is issued before any result is read."""
        masks, counts = [], []
        with launch_owner.owned_by(self.launch_owner):
            for sh in mirror.shards:
                q = [t.to(sh.device) for t in query]
                m, c = kernel(sh.keys, sh.revs, sh.tomb, sh.n_valid, *q)
                masks.append(m)
                counts.append(c)
        return masks, counts

    def _dev_mask(self, mirror: Mirror, start: bytes, end: bytes, read_rev: int):
        """Visibility through K1, once per slot: ``([mask [k, N]], [counts
        [k]])`` — with :meth:`_dev_mask_batch` the only place a scan kernel
        is launched, so count/range/stream cannot diverge."""
        starts, ends, unb, rrev = query_tensors(
            mirror.encoding, self._kw, [(start, end, read_rev)], "cpu")
        return self._per_slot(mirror, scan_kernels.visibility_mask_batch,
                              starts[0], ends[0], unb, rrev)

    def _dev_mask_batch(self, mirror: Mirror, specs):
        """Batched visibility for Q distinct ``(start, end, read_rev)``
        queries in ONE launch of K2 per slot. Q is padded to the next power
        of two with copies of query 0; ``([mask [Qpad, k, N]], [counts
        [Qpad, k]])`` cover the padded axis and callers slice
        ``[:len(specs)]``."""
        qpad = 1
        while qpad < len(specs):
            qpad *= 2
        padded = list(specs) + [specs[0]] * (qpad - len(specs))
        return self._per_slot(
            mirror, scan_kernels.visibility_mask_batch_q,
            *query_tensors(mirror.encoding, self._kw, padded, "cpu"))

    def _dev_visible_indices(self, masks, counts, n_rows: int):
        """(total, flat p·N + row indices int64) from the per-slot device
        masks [k, N]: every slot's per-partition counts first (a tiny
        transfer), then, from each slot with a visible row, its compacted
        index block [k, pow2(the slot's max count)], its local partitions
        mapped to the global p — O(visible rows) on the wire."""
        counts_h = [_host_pull(c) for c in counts]  # waits for the kernels
        total = int(sum(int(c.sum()) for c in counts_h))
        if total == 0:
            return 0, np.empty(0, dtype=np.int64)
        pieces, lo = [], 0
        for mask, c_h in zip(masks, counts_h):
            if c_h.any():
                size = _pow2_bucket(int(c_h.max()), n_rows)
                out = _host_pull(_part_indices_of_mask(mask, size))
                pieces += [out[p, :c].astype(np.int64) + (lo + p) * n_rows
                           for p, c in enumerate(c_h) if c]
            lo += len(c_h)
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
        if self._degraded():
            return Scanner.range_(self, start, end, read_revision, limit)
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
        if self._degraded():
            for i, spec in enumerate(queries):
                try:
                    if spec[0] == "count":
                        out[i] = Scanner.count(self, spec[1], spec[2], spec[3])
                    else:
                        out[i] = Scanner.range_(self, spec[1], spec[2],
                                                spec[3], spec[4])
                except Exception as e:
                    out[i] = e
            return out
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
            masks, counts = self._dev_mask_batch(
                mirror, [(s[1], s[2], s[3]) for _, s in device])
            sel = np.zeros(int(masks[0].shape[0]), dtype=bool)
            for k, (_, s) in enumerate(device):
                sel[k] = s[0] == "range"  # counts (and pow2 pad) stay off-wire
        n_rows = mirror.keys_host.shape[1]
        assert int(masks[0].shape[2]) == n_rows, (masks[0].shape, n_rows)
        stride = mirror.partitions * n_rows
        idx = np.empty(0, dtype=np.int64)
        with TRACER.stage("device_compute", device=True):
            # waits for the kernels; [Qpad, k] per slot
            per_slot = [_host_pull(c) for c in counts]
            counts_h = np.concatenate(per_slot, axis=1)  # [Qpad, P]
            blocks = []  # (first partition, [Qpad, k, size] or None, counts)
            for sh, mask, c_h in zip(mirror.shards, masks, per_slot):
                want = int(c_h[sel].max()) if sel.any() else 0
                block = None
                if want:
                    size = _pow2_bucket(want, n_rows)
                    sel_dev = torch.from_numpy(sel).to(mask.device)
                    block = _host_pull(_part_indices_of_mask(
                        mask & sel_dev.view(-1, 1, 1), size))
                blocks.append((sh.lo, block, c_h))
            pieces = []
            for k in np.nonzero(sel)[0]:
                base = int(k) * stride
                for lo, block, c_h in blocks:
                    for p in range(c_h.shape[1] if block is not None else 0):
                        c = int(c_h[k, p])
                        if c:
                            pieces.append(block[k, p, :c].astype(np.int64)
                                          + base + (lo + p) * n_rows)
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
        if self._degraded():
            return Scanner.range_stream(self, start, end, read_revision,
                                        batch_size)
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
        if self._degraded():
            return Scanner.count(self, start, end, read_revision)
        mirror, overlay = self._published_view(start, end, read_revision)
        with TRACER.stage("device_dispatch", device=True):
            _, counts = self._dev_mask(mirror, start, end, read_revision)
        with TRACER.stage("device_compute", device=True):
            total = sum(int(_host_pull(c).sum()) for c in counts)
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


    # -------------------------------------------------------------- compact
    def _victim_args(self, mirror: Mirror, start: bytes, end: bytes,
                     compact_rev: int, ttl_cutoff: int) -> list[tuple]:
        """K3's argument lists for internal-key borders [start, end) over
        ``mirror``, one per slot: its shard's columns and the flipped bound
        rows on its device."""
        s_user = coder.decode(start)[0] if coder.is_internal_key(start) else b""
        e_user = coder.decode(end)[0] if coder.is_internal_key(end) else b""
        s_row, e_row, unbounded = bound_rows(mirror.encoding, self._kw,
                                             s_user, e_user)
        s_row, e_row = flip_sign(s_row), flip_sign(e_row)
        return [(sh.keys, sh.revs, sh.tomb, sh.ttl, sh.n_valid,
                 torch.from_numpy(s_row).to(sh.device),
                 torch.from_numpy(e_row).to(sh.device),
                 unbounded, compact_rev, ttl_cutoff) for sh in mirror.shards]

    def _victim_mask(self, mirror: Mirror, start: bytes, end: bytes,
                     compact_rev: int, ttl_cutoff: int):
        """Per slot, the victim mask [k, N] and the victims of each
        partition int32[k], both from one K3 launch: ``([mask],
        [counts])``. The one place compaction launches it."""
        args = self._victim_args(mirror, start, end, compact_rev, ttl_cutoff)
        with launch_owner.owned_by(self.launch_owner):
            out = [compact_kernels.victim_mask_batch(*a) for a in args]
        return [m for m, _c in out], [c for _m, c in out]

    def _pull_victim_indices(self, masks, counts,
                             mirror: Mirror) -> dict[int, np.ndarray]:
        """``{partition: ascending victim row indices}`` for every partition
        with a victim, from the per-slot masks [k, N] and counts [k] of
        :meth:`_victim_mask`, through the two-phase transfer of
        ``storage/tpu/engine.py:1622``: every slot's victim counts first
        (4·P bytes; the valid rows come from the mirror's host ``n_valid``),
        then, per slot with a victim, only the smaller of its victim and
        survivor index sets as a [k, pow2(max count)] block, the complement
        rebuilt on the host. A slot's [k, N] mask itself crosses only when
        that block would be wider than it."""
        vic = [_host_pull(c) for c in counts]
        out: dict[int, np.ndarray] = {}
        lo = 0
        for mask, vic_h in zip(masks, vic):
            self._pull_slot_victims(mask, vic_h, mirror.n_valid[lo:lo + len(vic_h)],
                                    lo, out)
            lo += len(vic_h)
        return out

    @staticmethod
    def _pull_slot_victims(mask: torch.Tensor, vic_h: np.ndarray,
                           n_valid: np.ndarray, lo: int, out: dict) -> None:
        """One slot's share of :meth:`_pull_victim_indices`: its partitions
        are ``lo + p``."""
        n_rows = int(mask.shape[-1])
        valid_h = np.minimum(n_valid, n_rows)
        total_vic = int(vic_h.sum())
        if total_vic == 0:
            return
        surv_h = valid_h - vic_h
        use_survivors = int(surv_h.sum()) < total_vic
        want = int(surv_h.max()) if use_survivors else int(vic_h.max())
        size = _pow2_bucket(want, n_rows)
        if size * 8 > n_rows:
            mask_h = _host_pull(mask)
            for p in np.nonzero(vic_h)[0]:
                p = int(p)
                out[lo + p] = np.nonzero(mask_h[p, : int(valid_h[p])])[0]
            return
        if use_survivors:
            nv = torch.from_numpy(np.ascontiguousarray(n_valid, np.int32))
            idx = _host_pull(_part_survivor_indices(mask, nv.to(mask.device),
                                                    size))
            for p in np.nonzero(vic_h)[0]:
                p = int(p)
                pmask = np.ones(int(valid_h[p]), dtype=bool)
                pmask[idx[p, : int(surv_h[p])].astype(np.int64)] = False
                out[lo + p] = np.nonzero(pmask)[0]
        else:
            idx = _host_pull(_part_indices_of_mask(mask, size))
            for p in np.nonzero(vic_h)[0]:
                p = int(p)
                out[lo + p] = idx[p, : int(vic_h[p])].astype(np.int64)

    def _compact_victim_rows(self, mirror: Mirror, p: int, rows: np.ndarray):
        """The victim-only decode point: raw key bytes for exactly the rows
        compaction deletes from the store (the engine speaks raw keys), never
        a whole partition."""
        k_u8, lens = mirror.decoded_keys(p, rows)
        return k_u8, np.asarray(lens, np.int32)

    def compact(self, start: bytes, end: bytes, compact_revision: int) -> CompactStats:
        """Device compaction (counterpart of ``storage/tpu/engine.py:1687``):
        mark (K3 + the victim index pull) → gc (store deletes of the victim
        rows, guarded revision-record GC, history pruning) → merge
        (survivors gathered in the stored domain, pending delta merged) →
        publish (swap under ``_mlock``). The store's deletes go through the
        untracked inner engine, so they neither feed the delta nor poison
        the mirror. The whole pass holds ``_merge_lock``; readers keep
        serving mirror + overlay. A failed mirror half retries with backoff,
        then escalates to quarantine and a rebuild from the GC'd store. A
        failed gc quarantines the mirror the same way before it re-raises:
        the store may already lack rows the mirror holds.
        ``pre_merge`` times the merge of the pending delta before marking."""
        t0 = time.monotonic()
        self._ensure_published(full=True)
        phases: dict[str, float] = {"pre_merge": time.monotonic() - t0}
        store = getattr(self._store, "untracked", self._store.exclusive_client)()
        self.compact_history.log(compact_revision)
        ttl_cutoff = 0
        if not store.support_ttl():
            ttl_cutoff = self.compact_history.timeout_revision(
                scanner_mod.EVENTS_TTL_SECONDS)
        applied = superseded = False
        gc_error = None
        with self._merge_lock:
            with self._mlock:
                mirror = self._mirror
                self._compact_active = True
            try:
                t0 = time.monotonic()
                victims_by_part = self._pull_victim_indices(
                    *self._victim_mask(mirror, start, end, compact_revision,
                                       ttl_cutoff), mirror)
                phases["mark"] = time.monotonic() - t0

                t0 = time.monotonic()
                stats = CompactStats(scanned=mirror.rows, mirror_path="none",
                                     phase_seconds=phases)
                try:
                    keep_idx = self._compact_gc(store, mirror, victims_by_part,
                                                stats)
                except Exception as e:
                    gc_error = e
                else:
                    phases["gc"] = time.monotonic() - t0
                    n_victims = sum(len(v) for v in victims_by_part.values())
                    stats.survivor_rows = mirror.rows - n_victims
                    stats.dirty_partitions = len(keep_idx)
                    try:
                        superseded = self._compact_apply_locked(
                            mirror, keep_idx, stats, phases)
                        applied = True
                    except Exception as e:
                        self.compact_errors += 1
                        self._compact_last_error = e
                        self._emit_counter("kb.compact.errors")
            finally:
                with self._mlock:
                    self._compact_active = False
        if gc_error is not None:
            self._quarantine_failed_gc(gc_error)
            raise gc_error
        if superseded:
            self._quarantine_superseded_compact(stats)
        elif not applied:
            self._compact_retry_escalate(mirror, keep_idx, stats, phases)
        self.compact_count += 1
        self.compact_victims_total += n_victims
        self.compact_survivor_rows_total += stats.survivor_rows
        self._emit_compact_metrics(stats, phases)
        return stats

    def _emit_compact_metrics(self, stats: CompactStats, phases) -> None:
        """The compaction's histograms and victim counters, as the JAX
        engine emits them (``storage/tpu/engine.py:1896-1921``). The port's
        ``pre_merge`` phase has no JAX series and is not emitted."""
        if self._metrics is None:
            return
        for ph in ("mark", "gc", "merge", "publish"):
            if ph in phases:
                self._metrics.emit_histogram("kb.compact.seconds", phases[ph],
                                             phase=ph)
        for kind, n in (("superseded", stats.deleted_versions),
                        ("tombstone", stats.deleted_tombstones),
                        ("ttl_expired", stats.expired_ttl),
                        ("rev_record", stats.deleted_rev_records)):
            if n:
                self._metrics.emit_counter("kb.compact.victims.total", n,
                                           kind=kind)
        if stats.mirror_path == "full_rebuild":
            # a compaction that fell back to the full rebuild shows on the
            # merge histogram's full-rebuild series, as in the JAX engine
            self._metrics.emit_histogram(
                "kb.mirror.merge.seconds", phases.get("merge", 0.0),
                kind="full_rebuild")

    def _emit_counter(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.emit_counter(name, 1)

    def _compact_gc(self, store, mirror: Mirror, victims_by_part,
                    stats: CompactStats) -> dict[int, np.ndarray]:
        """Delete the victims from the store and count them into ``stats``;
        returns ``{dirty partition: surviving row indices}``. Victim classes
        and revision-record GC follow the host scanner's rules
        (``backend/scanner.py``); group structure is read off the stored key
        rows (encoded equality is raw equality), so only victims decode."""
        retry_min = self._retry_min_revision()
        bulk = getattr(store, "bulk_gc", None)
        pending: list[bytes] = []
        bulk_victims, bulk_recs = [], []
        keep_idx: dict[int, np.ndarray] = {}
        for p in sorted(victims_by_part):
            victims = victims_by_part[p]
            nv = int(mirror.n_valid[p])
            pmask = np.zeros(nv, dtype=bool)
            pmask[victims] = True
            keys_p = mirror.keys_host[p, :nv]
            revs_all = mirror.revs_host[p, :nv]
            tomb_all = mirror.tomb_host[p, :nv]
            same_prev = np.zeros(nv, dtype=bool)
            same_prev[1:] = (keys_p[1:] == keys_p[:-1]).all(axis=1)
            group_starts = np.nonzero(~same_prev)[0]
            group_ends = np.append(group_starts[1:], nv)
            doomed_per_group = np.add.reduceat(pmask.astype(np.int64), group_starts)
            last_idx = group_ends - 1
            gid = np.cumsum(~same_prev) - 1

            v_tomb = tomb_all[victims].astype(bool)
            v_is_last = victims == last_idx[gid[victims]]
            stats.deleted_tombstones += int(v_tomb.sum())
            stats.deleted_versions += int((~v_tomb & ~v_is_last).sum())
            stats.expired_ttl += int((~v_tomb & v_is_last).sum())

            # revision-record GC: fully doomed groups whose last revision is
            # below the uncertain-retry fence
            dg = np.nonzero(doomed_per_group == group_ends - group_starts)[0]
            d_last = last_idx[dg]
            d_rev = revs_all[d_last].astype(np.uint64)
            if retry_min and len(dg):
                ok = d_rev < np.uint64(retry_min)
                dg, d_last, d_rev = dg[ok], d_last[ok], d_rev[ok]
            # a fully doomed group's first row is itself a victim, so the
            # victims' decode covers the revision-record keys too
            k_u8_v, lens_v = self._compact_victim_rows(mirror, p, victims)
            f_pos = np.searchsorted(victims, group_starts[dg])
            if bulk is not None:
                bulk_victims.append((k_u8_v, lens_v,
                                     revs_all[victims].astype(np.uint64)))
                bulk_recs.append((k_u8_v[f_pos], lens_v[f_pos], d_rev,
                                  tomb_all[d_last].astype(np.uint8)))
            else:
                for j, i in enumerate(victims):
                    uk = k_u8_v[j, : int(lens_v[j])].tobytes()
                    pending.append(coder.encode_object_key(uk, int(revs_all[int(i)])))
                for j in range(len(dg)):
                    raw = coder.encode_rev_value(
                        int(d_rev[j]), deleted=bool(tomb_all[int(d_last[j])]))
                    fj = int(f_pos[j])
                    uk = k_u8_v[fj, : int(lens_v[fj])].tobytes()
                    try:
                        store.del_current(coder.encode_revision_key(uk), raw)
                        stats.deleted_rev_records += 1
                    except CASFailedError:
                        pass  # rewritten since the mirror snapshot
            keep_idx[p] = np.nonzero(~pmask)[0]
        if bulk is not None and bulk_victims:
            vk, vl, vr = (np.concatenate([b[i] for b in bulk_victims])
                          for i in range(3))
            rk, rl, rr, rt = (np.concatenate([b[i] for b in bulk_recs])
                              for i in range(4))
            stats.deleted_rev_records += bulk(vk, vl, vr, rk, rl, rr, rt)
        for b0 in range(0, len(pending), 256):
            batch = store.begin_batch_write()
            for k in pending[b0 : b0 + 256]:
                batch.delete(k)
            batch.commit()
        # free the version chains the logical deletes above made unreachable
        pruner = getattr(store, "prune_versions", None)
        if pruner is not None:
            pruner(store.get_timestamp_oracle())
        return keep_idx

    def _compact_apply_locked(self, mirror: Mirror, keep_idx, stats,
                              phases) -> bool:
        """One attempt at the compaction's mirror half; the caller holds
        ``_merge_lock``, ``_mlock`` is taken for the delta snapshot and the
        swap only. Survivors are gathered in the stored domain and the
        delta sealed before the snapshot is merged in. Returns True when the
        mirror was superseded (an uncertainty rebuild swapped it)."""
        plane = self._fault_plane
        if plane is not None and plane.compact_fault():
            # chaos: fail before any state changes; the caller's retries
            # and escalation recover, the store's deletes stand
            raise RuntimeError("injected compact failure (fault plane)")
        t0 = time.monotonic()
        with self._mlock:
            if self._force_rebuild or self._mirror is not mirror:
                return True
            blocks, rows_prefix, overflow = self._delta.snapshot_blocks()
        n_rows = len(rows_prefix)
        ts = self._store.get_timestamp_oracle()
        m = None
        if not (n_rows and overflow):
            m = compact_partitions_stored(mirror, keep_idx, ts)
        if m is not None and n_rows:
            m = merge_partitions_stored(m, merge_sorted_stored(blocks), ts)
        full = m is None
        if full:
            # width drift, an overflowed dictionary or no host TTL column:
            # the store, already GC'd, holds exactly the rows wanted
            m = self._build_mirror_from_store()
        phases["merge"] = time.monotonic() - t0
        t1 = time.monotonic()
        superseded = False
        with self._mlock:
            if self._force_rebuild or self._mirror is not mirror:
                superseded = True
            elif m is mirror and n_rows == 0:
                stats.mirror_path = "stored_incremental"  # nothing changed
            else:
                self._mirror = m
                tail = self._delta.tail_rows(n_rows)
                self._delta = self._fresh_delta()
                if tail:
                    self._delta.extend(tail)
                self._probe_cache = None
                if full:
                    self.full_rebuild_total += 1
                stats.mirror_path = "full_rebuild" if full else "stored_incremental"
        phases["publish"] = time.monotonic() - t1
        return superseded

    def _compact_apply(self, mirror: Mirror, keep_idx, stats, phases) -> None:
        """A retry of the mirror half, re-taking ``_merge_lock``."""
        with self._merge_lock:
            with self._mlock:
                self._compact_active = True
            try:
                superseded = self._compact_apply_locked(
                    mirror, keep_idx, stats, phases)
            finally:
                with self._mlock:
                    self._compact_active = False
        if superseded:
            self._quarantine_superseded_compact(stats)

    def _compact_retry_escalate(self, mirror: Mirror, keep_idx, stats,
                                phases) -> None:
        """Attempts 2..K of the mirror half with jittered backoff (sleeps
        hold no lock), then escalate: quarantine, and one background rebuild
        from the already-GC'd store recovers. The store's deletes stand
        either way."""
        backoff = 0.05
        for _attempt in range(1, self._merge_max_retries):
            self.compact_retries_total += 1
            self._emit_counter("kb.compact.retries")
            time.sleep(backoff * random.uniform(0.5, 1.5))
            backoff = min(backoff * 2.0, 1.0)
            try:
                self._compact_apply(mirror, keep_idx, stats, phases)
                return
            except Exception as e:
                self.compact_errors += 1
                self._compact_last_error = e
                self._emit_counter("kb.compact.errors")
        self.compact_escalations_total += 1
        self._emit_counter("kb.compact.escalations")
        stats.mirror_path = "escalated"
        self._quarantine_and_rebuild()

    def _quarantine_failed_gc(self, err: Exception) -> None:
        """A gc that raised may have removed rows the mirror still serves:
        count the error, then quarantine."""
        self.compact_errors += 1
        self._compact_last_error = err
        self._emit_counter("kb.compact.errors")
        self._quarantine_and_rebuild()

    def _quarantine_superseded_compact(self, stats) -> None:
        """A mirror swapped mid-pass may have been built from a store
        snapshot older than this compaction's deletes: quarantine, and one
        background rebuild converges."""
        stats.mirror_path = "superseded"
        self._quarantine_and_rebuild()

    def _quarantine_and_rebuild(self) -> None:
        """Quarantine the mirror (reads take the host path) and kick one
        background rebuild from the store."""
        with self._mlock:
            self._force_rebuild = True
            self._poison_epoch += 1
            self._enter_degraded_locked("quarantined")
        self._kick_rebuild()


class CudaKvStorage(KvStorage):
    """Decorator pairing a host engine with a TorchScanner delta feed.

    Every committed Put to an object key (revision >= 1) is a version row
    for the mirror; uncertain commits force a rebuild from the store."""

    def __init__(self, inner: KvStorage, device=None,
                 key_width: int = keyops.KEY_WIDTH, partitions: int = 0,
                 mesh=None, **scanner_kw):
        self._inner = inner
        self._device, slots = placement(device, mesh)
        # the mirror's part slots, resolved once, so that the scanner
        # holds the mesh this engine was built with; a bad partition count
        # raises here, not at the first read
        self._mesh = Mesh.of(slots)
        partition_count(partitions, slots)
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
                                     key_width=self._kw, mesh=self._mesh,
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
        """One-call write through the inner engine, its version row recorded
        into the delta; an uncertain outcome quarantines the mirror, as a
        grouped or batched one does (the JAX engine's fast path does not,
        ``kubebrain_tpu/storage/tpu/engine.py:2152``: a maybe-applied row
        would sit in the store and never in the mirror)."""
        try:
            self._inner.mvcc_write(
                rev_key, rev_val, expected, obj_key, obj_val, last_key,
                last_val, ttl_seconds)
        except UncertainResultError:
            self._on_uncertain()
            raise
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
        """One-call delete; an uncertain outcome quarantines the mirror."""
        try:
            result = self._inner.mvcc_delete(
                rev_key, expected_rev, new_rev, new_record, tombstone,
                last_key, last_val)
        except UncertainResultError:
            self._on_uncertain()
            raise
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
                  inner_wrap=None, inner_partitions: int = 0, mesh=None,
                  **inner_kw) -> CudaKvStorage:
    """``partitions`` is the mirror's partition count (a multiple of the
    mesh's ``part`` slots); ``inner_partitions`` the host engine's own
    (``native``/``remote`` ``partitions``: the shard map its host scans
    split by), passed on when nonzero."""
    from .. import new_storage

    # no card and no explicit CPU, or partitions the mesh can't split:
    # raise here, before the host engine opens
    dev, slots = placement(device, mesh)
    partition_count(partitions, slots)
    scanner_kw = {}
    if encode_keys is not None:
        scanner_kw["encode_keys"] = encode_keys
    if merge_threshold:
        scanner_kw["merge_threshold"] = merge_threshold
    if inner_partitions:
        inner_kw["partitions"] = inner_partitions
    host = new_storage(inner, **inner_kw)
    if inner_wrap is not None:
        # decorate the HOST engine (chaos mode wraps FaultyStorage here, so
        # injected uncertainty exercises the mirror's quarantine machinery)
        host = inner_wrap(host)
    return CudaKvStorage(host, device=dev, key_width=key_width,
                         partitions=partitions, mesh=mesh, **scanner_kw)


register_engine("cuda", _cuda_factory)
