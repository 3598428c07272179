#!/usr/bin/env python3
"""Drive kubebrain_tpu_torch on one CUDA card and check every result.

    python3 chip_smoke.py [--seed 0] [--keys 1000000]
                          [--kernel-keys 200000] [--kernel-revs 100]
    python3 chip_smoke.py --watch-ab DIR [--watchers 10000] [--writes 10000]

Phases, in the order they run (any failure exits non-zero and prints no
result line):

(a) build: compile every ``kubebrain_tpu_torch/csrc/*.cu`` with nvcc (one
    process per source, started together) and print the build seconds, the
    ptxas report and the card's name and power limit.
(b) K1/K2 at the scan bench shape: a synthetic mirror of ``--kernel-keys``
    keys × ``--kernel-revs`` revisions (20M version rows by default), raw
    128-byte keys and the same rows encoded. K1 (one ``/registry/pods/``
    query at a mid-history revision) and K2 (8 distinct prefix/revision
    queries) must give masks and counts bit-identical to the plain PyTorch
    version; kernel, plain and bound times are printed. Then the edge
    queries of the kernels' block classification (bounds on the rows of
    block edges, start == end, a start past every key, an end below every
    key, a NUL-bound single key, an unbounded end), each through K1 and all
    of them through one K2 launch padded to a power of two, must be
    bit-identical too.
(d) K3 at the scan bench shape: the same rows, raw and encoded, with the
    TTL flag on every third key's whole chain, compacted at a mid-history
    revision with a TTL cutoff below it, once unbounded and once over
    [start, end), and once with the cutoff past the compact revision; then
    a mirror of 24 chains of 1,000-5,853 rows, which cross many of the
    kernel's tiles, with a TTL cutoff that expires some chains whole and
    leaves others; then the tile-edge mirror (P = 3, one partition empty, a
    capacity that is no multiple of the rows per thread; chains of tile-1,
    tile, tile+1, 2·tile, tile and 5·tile rows, so chains start on a tile's
    first row and end on its last, and tiles hold no group end) under six
    cases, bounds on tile edges and a cutoff of 0 among them, raw (C = 32)
    and narrow (C = 8). Every mask and every per-partition count must be
    bit-identical to the plain PyTorch version; kernel, plain and bound
    times are printed, with each case's tile census (tiles outside, inside,
    straddling, past n_valid, and tiles that looked back).
(c) main path: ``--keys`` kube-shaped user keys (version chains, tombstones,
    256–2047-byte values) loaded into memkv, served by
    ``Backend(new_storage("cuda", inner=...))``: per-namespace Range, full
    ``/registry/pods/`` Range, Count, a Range at an older revision, one
    ``list_batch`` of 8 queries (K2), and writes read back through the delta
    overlay. Every response must equal the generic host ``Scanner`` over the
    same store, byte for byte. K1 and K2 launches are counted over this
    phase and must both be > 0; then both kernels are held against the plain
    version at the mirror's own shape, the edge queries of (b) included. No
    merge may have failed and no read
    may have left the device (the engine's error, retry, escalation,
    degraded-seconds and background-rebuild counters all stay 0).
(e) compaction on the main path, same store: a few hundred writes left in
    the delta, the same aged ``CompactHistory`` entry on both sides (so
    ``/events/`` rows expire by TTL), then ``Backend.compact``. The store
    dump, ``version_count()`` and the ``CompactStats`` victim fields must
    equal those that the host ``Scanner``'s compaction leaves on a twin
    memkv filled from a dump of the same store; every Range, Count and
    ``list_batch`` after it must equal the host ``Scanner`` over the
    compacted store; ``full_rebuild_total`` must not move, the mirror path
    must be ``stored_incremental``, K3 must have launched and the counters
    of (c) must still be 0. The phase seconds (pre-pass merge, mark, gc,
    merge, publish) are printed; then K3's mask and counts are held against
    the plain version on the inputs the compaction gave it.
(f) watch fan-out on the main path, same Backend (built with
    ``BackendConfig(fanout_matcher=DeviceFanout())``). First the kernels,
    which match in the rank space of the watcher table's rank index: K4
    (``fanout_dispatch``: counts and compacted indices) and K5
    (``fanout_mask_range``: the legacy E-major mask) must be bit-identical
    to the plain version by chunk compares, which the plain version in rank
    space must equal too, on (i) ``bench.py``'s fan-out population (10,000
    watchers, 100 broad) x 512 events, C = 16; (ii) the same generator at
    100,000 watchers (1,000 broad) x 4,096 events; (iii) the edge cases
    (event keys equal to a start and to an end, a NUL-bound single key,
    revisions at and one below min_rev, n_ev < E, slots freed by a churn
    sync, which updates the index, a size below the total, a 200-byte key
    that makes C = 64), also held against ``match_oracle``, and a block of
    4,096 events at a pinned 16-byte width (C = 4); (iv) K5 at 10,000 x 300
    and x 512; (v) 64 watchers x ``--deep-events`` (40,000; E = 65,536)
    and (vi) 10,000 watchers x half as many (E = 32,768, past 16,384 and
    within the int32 flat index of 10,240 slots). (i), (ii), (iv), (v) and
    (vi) are also held against ``match_oracle`` for every watcher or a
    seeded sample of 256. (i) and (ii) also time the rank index's rebuild
    and the table's publication after one watcher-set change of each kind
    (a re-watch of the same range, a single-key watch of a new key, a
    ``min_rev`` change), then hold K4 on the churned table against the
    plain versions ((i) also against ``match_oracle``). A measured case
    whose profile keeps no record of its kernels fails (after two
    retries).
    Then end to end: ``--watchers`` watchers of the (i) shape registered
    through ``Backend.watch_range`` (a fifth of them starting a few hundred
    revisions ahead), drained by consumer threads, while ``--writers``
    threads write ``--writes`` creates, updates and deletes, and watchers
    are re-established at client-go's informer rate (each watcher every
    450 seconds on average: a cohort of extra watchers, the oldest
    unwatched and a new one registered from the next revision).
    Every watcher's events must equal ``match_oracle`` over the hub's full
    event stream, in revision order, none dropped, and every churned
    watcher's the oracle's first from its start revision; the matcher's
    blocks and dispatches and K4's launches must all be > 0. The same drive at a
    tenth of the size runs a second Backend whose hub holds the legacy
    ``FanoutMatcher`` (K5's launches > 0). Last, the routing crossover: one
    block at 10,000 watchers without the broad cohort (the hub's interval
    index serves it) for E in {1, 8, 64, 512}: the hub's K4 route
    (``DeviceFanout.deliver`` and the queue puts) against ``stream`` through
    the index of a hub without a matcher.

(g) deployed engines: ``make -C native libkbstore.so kvrpc/kbstored`` runs
    beside the kernels' nvcc in (a); a failed build fails the run.
    (g1) ``cuda`` over ``native`` in the README's single-node shape: a
    fresh data dir under ``build/smoke/``, fsync off, 4 native partitions
    (the CLI's ``--native-partitions`` default), loaded with (c)'s dataset
    through the untracked engine. The mirror must be built by the engine's
    C++ bulk export (``mirror_builds``); a per-row build of the same store
    is timed beside it and must equal it column for column. (c)'s request
    set must equal the generic host ``Scanner`` over the same store, K1 and
    K2 launching; (e)'s compaction (through ``kb_bulk_gc``) must leave the
    store dump, ``version_count()`` and victim fields of the host
    ``Scanner``'s compaction on a native twin. Then the store closes, a
    ``cuda`` over native reopens the same dir, boots by export, and every
    Range, Count and ``list_batch`` answer at the head and the compaction
    revision equals the one before the restart. (g2) the same load, serve
    and compaction checks for ``cuda`` over ``remote``: a ``kbstored`` on a
    data dir, the pool of 8 (the CLI's ``--storage-pool`` default), the
    twin on a second ``kbstored``; ``--remote-keys`` deep (250,000: its load
    and its compaction's deletes go over TCP a request at a time).
(h) chaos: ``cuda`` over native with the inner engine wrapped by
    ``FaultyStorage`` through ``inner_wrap`` and a ``FaultPlane`` of
    ``faults.generate(preset, --seed, --chaos-horizon)``, the ``storage``
    preset, then ``merge``, over ``--chaos-keys`` keys. The plane is armed
    over a watch drive of ``--chaos-watchers`` watchers (70 broad) whose
    writers go on through faults, with a reader of Range, Count and
    ``list_batch`` and one compaction midway. After the horizon the retry
    FIFO is drained, and: every acknowledged write reads back, no write
    that failed definitely is present, every key an uncertain write
    touched holds a value it may, the mirror serves again, every watcher's
    events equal ``match_oracle`` with none dropped, every response equals
    the host ``Scanner``, and a compaction runs with K1-K3 launching. The
    plane's injected counts, quarantines, degraded seconds and rebuilds are
    printed.

Each phase's seconds are printed before the result lines.

Each measured kernel case prints its time per call over many launches back
to back between one pair of CUDA events (the host's side of each call
included where it is the longer), its device time from ``torch.profiler``
with the L2 cache flushed before each call (and the kernel records the
profiler kept per call), the plain version's time, its
bound (the valid rows inside the queries' ranges for K1/K2, inside the
compaction's [start, end) for K3; for K4/K5 the least work of rank space,
three compares per pair and the rank searches) and the full-scan bound of
every valid row (for K4/K5 the compare bound, 2C + 1 compares per pair).

Output, last three lines: the kernels JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.

``--watch-ab DIR`` runs only the watch drive on an empty store, through
the package of checkout DIR and through this one in turns (DIR, this,
this, DIR), each in a process of its own: one JSON line per run, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import math
import queue
import random
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from kubebrain_tpu_torch import _build, coder
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.common import LAST_REV_KEY, TOMBSTONE, WatchEvent
from kubebrain_tpu_torch.backend.scanner import EVENTS_TTL_SECONDS, Scanner
from kubebrain_tpu_torch.backend.watcherhub import ProgressMarker, WatcherHub
from kubebrain_tpu_torch.device import TRANSFER_METER, resolve_device
from kubebrain_tpu_torch.faults import FaultPlane, FaultyStorage, generate
from kubebrain_tpu_torch.fanout import DeviceFanout, match_oracle
from kubebrain_tpu_torch.fanout.dispatch import max_block_events
from kubebrain_tpu_torch.ops import compact, compact_kernels, fanout, fanout_kernels
from kubebrain_tpu_torch.ops import scan, scan_kernels
from kubebrain_tpu_torch.ops import keys as keyops
from kubebrain_tpu_torch.ops.scan import flip_sign
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.errors import (
    KeyNotFoundError,
    StorageError,
    UncertainResultError,
)
from kubebrain_tpu_torch.storage.cuda.encode import build_encoding
from kubebrain_tpu_torch.trace import TRACER
from kubebrain_tpu_torch.storage.cuda.engine import (
    _part_indices_of_mask,
    bound_rows,
    query_tensors,
)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
VECTOR_OPS_PER_S = 67e12    # H100 SXM non-tensor 32-bit rate
SOURCES = {
    "scan_mask": "kubebrain_tpu_torch/csrc/scan_visibility.cu",
    "scan_mask_q": "kubebrain_tpu_torch/csrc/scan_visibility.cu",
    "victim_mask": "kubebrain_tpu_torch/csrc/compact_victims.cu",
    "fanout_dispatch": "kubebrain_tpu_torch/csrc/fanout_match.cu",
    "fanout_mask_range": "kubebrain_tpu_torch/csrc/fanout_match.cu",
}
REPLACES = {
    "scan_mask": "kubebrain_tpu/ops/scan_pallas.py:175",
    "scan_mask_q": "kubebrain_tpu/ops/scan_pallas.py:222",
    "victim_mask": "kubebrain_tpu/ops/compact_pallas.py:122",
    "fanout_dispatch": "kubebrain_tpu/fanout/dispatch.py:68",
    "fanout_mask_range": "kubebrain_tpu/ops/fanout.py:46",
}
VICTIM_FIELDS = ("deleted_versions", "deleted_tombstones", "deleted_rev_records",
                 "expired_ttl")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Time of one call of ``fn``: ``reps`` calls back to back between one
    pair of CUDA events, after a warm-up call, over ``reps``. Where the
    host's side of a call (a wrapper's checks, allocations and launch)
    takes longer than the device's, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


#: more than the H100's 50 MB L2 cache
FLUSH_BYTES = 64 << 20


def device_ms(fn, kernels: tuple[str, ...], reps: int
              ) -> tuple[float | None, float]:
    """Device time per call of ``fn`` of the CUDA kernels whose names
    contain one of ``kernels``, from ``torch.profiler``, with the L2 cache
    flushed before every call (a request finds the mirror cold): the
    kernels' own duration without the host's side of the call. Each kernel
    function the profiler names launches once per call (K4's two passes
    and its scan; K1-K3's and K5's one kernel), so the time is the sum of
    their mean durations per launch: late in a long process the profiler
    keeps only some of the records, and a sum over the records would fall
    short. None where it kept no record of them. Second, the records it
    kept per call (3 for K4 and 1 for the others when none is lost)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    matched = [ev for ev in prof.key_averages()
               if any(k in ev.key for k in kernels)]
    per_call = sum(ev.device_time_total / ev.count for ev in matched)
    if len(matched) > 1:
        log("device ms per launch: " + ", ".join(
            f"{next(k for k in kernels if k in ev.key)} "
            f"{ev.device_time_total / ev.count / 1e3}" for ev in matched))
    return (per_call / 1e3 if matched else None,
            sum(ev.count for ev in matched) / reps)


def cold_ms(fn, reps: int) -> float:
    """Time of one call of ``fn`` with the L2 cache flushed before it: a
    CUDA event pair around each call (the flush outside it), median over
    ``reps``. Where the host enqueues the call slower than the card runs
    it, this is the host's time; it cross-checks the profiler's
    ``device_ms``."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / VECTOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound_ms(keys_t, rows: int, q: int, full: bool = False
                  ) -> tuple[float, str]:
    """Least time for one visibility launch that needs ``rows`` rows:
    inputs read once (their keys, revisions and tombstones; n_valid and the
    per-query bounds), outputs written once (Q mask bytes for every row of
    [P, N] and the counts), over the memory rate; or the compares over the
    vector rate, whichever is larger. The bound passes the rows inside the
    queries' ranges (their union under n_valid), with C next-key and Q
    revision compares each; the full-scan bound (``full``, the bound of the
    kernel before it classified blocks) every valid row, with 2·Q·C chunk
    compares each."""
    p, c, n = keys_t.shape
    return _bound(rows * (4 * c + 8 + 1) + 4 * p + q * (8 * c + 4 + 8)
                  + q * p * n + 4 * q * p,
                  rows * (2 * q * c if full else c + q))


def rows_in_range(keys_t, nv, starts, ends, unb) -> int:
    """Valid rows inside at least one query's range (the union over the
    queries): the rows whose columns a visibility launch must read."""
    valid = (torch.arange(keys_t.shape[2], device=keys_t.device).unsqueeze(0)
             < nv.to(torch.int64).unsqueeze(1))
    hit = scan.key_in_range(keys_t, starts, ends, unb).any(dim=0)
    return int((hit & valid).sum())


def victim_bound_ms(keys_t, rows: int, full: bool = False) -> tuple[float, str]:
    """Least time for one K3 launch that needs ``rows`` rows: keys,
    revision, tombstone and TTL flag of each read once, n_valid and the two
    bounds, one mask byte written for every row of [P, N] and the counts,
    over the memory rate; or the compares over the vector rate, whichever
    is larger. The bound passes the valid rows inside [start, end), with C
    next-key compares each; the full-scan bound (``full``, the bound of the
    kernel before it classified tiles) every valid row, with 3·C chunk
    compares each (next key, start, end)."""
    p, c, n = keys_t.shape
    return _bound(rows * (4 * c + 8 + 1 + 1) + 4 * p + 8 * c + p * n + 4 * p,
                  rows * (3 * c if full else c))


def victim_rows_in_range(keys_t, nv, start, end, unbounded) -> int:
    """Valid rows inside [start, end): the rows whose columns K3 must read."""
    valid = (torch.arange(keys_t.shape[2], device=keys_t.device).unsqueeze(0)
             < nv.to(torch.int64).unsqueeze(1))
    unb = torch.tensor([int(bool(unbounded))], device=keys_t.device)
    hit = scan.key_in_range(keys_t, start.view(1, -1), end.view(1, -1), unb)[0]
    return int((hit & valid).sum())


def tile_census(keys_t, revs, ttl, nv, start, end, unbounded,
                ttl_cutoff) -> dict:
    """K3's tiles of one launch by the plain classification: outside,
    inside, straddling, past n_valid, and the tiles that looked back."""
    cls, reach = compact.victim_lookback(keys_t, revs, ttl, nv, start, end,
                                         unbounded, ttl_cutoff)
    n = torch.bincount(cls.flatten().long(), minlength=4).tolist()
    return {"outside": n[compact.OUTSIDE], "inside": n[compact.INSIDE],
            "straddling": n[compact.STRADDLE], "past": n[compact.PAST],
            "looked_back": int((reach >= 0).sum())}


class Case:
    """One kernel call on fixed device inputs, its plain counterpart, the
    comparison between them and the bounds of the work (callables, computed
    when the case is measured)."""

    def __init__(self, name, kernel, plain, bound, bound_full, kernels,
                 also_plain=None):
        self.name = name
        self.kernel = kernel
        self.plain = plain
        self.bound = bound
        self.bound_full = bound_full
        self.kernels = kernels  # CUDA kernel names the profiler reports
        # a second plain version the first must equal (K4/K5: rank space)
        self.also_plain = also_plain

    def check(self) -> int:
        """Max |kernel - plain| over every output (must be 0)."""
        got = self.kernel()
        torch.cuda.synchronize()
        want = self.plain()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{self.name}: kernel disagrees with plain "
                                 f"(max abs err {err})")
        if self.also_plain is not None:
            other = self.also_plain()
            if isinstance(other, torch.Tensor):
                other = (other,)
            if not all(torch.equal(a, b) for a, b in zip(want, other)):
                raise AssertionError(f"{self.name}: the plain versions "
                                     f"disagree")
        return err

    def measure(self, reps: int) -> dict:
        b, by = self.bound()
        dev_ms, records = device_ms(self.kernel, self.kernels, reps)
        for more in (2, 4):  # the profiler drops records late in a process
            if records > 0:
                break
            dev_ms, records = device_ms(self.kernel, self.kernels, more * reps)
        if records <= 0:
            raise AssertionError(f"{self.name}: the profiler kept no record "
                                 f"of {self.kernels}")
        return {"ms": time_ms(self.kernel, reps),
                "device_ms": dev_ms, "device_records": records,
                "cold_ms": cold_ms(self.kernel, reps),
                "plain_ms": time_ms(self.plain, max(3, reps // 4)),
                "bound_ms": b, "bound_by": by,
                "bound_full_ms": self.bound_full()[0]}


def scan_case(name, keys_t, revs, tomb, nv, starts, ends, unb, rrevs) -> Case:
    """K1 (``scan_mask``, the first query only) or K2 (``scan_mask_q``)."""
    q = 1 if name == "scan_mask" else starts.shape[0]
    if name == "scan_mask":
        kernel = lambda: scan_kernels.visibility_mask_batch(
            keys_t, revs, tomb, nv, starts[0], ends[0], unb, rrevs)
    else:
        kernel = lambda: scan_kernels.visibility_mask_batch_q(
            keys_t, revs, tomb, nv, starts, ends, unb, rrevs)

    def plain():
        m = scan.visibility_mask(keys_t, revs, tomb, nv, starts, ends, unb,
                                 rrevs)
        if name == "scan_mask":
            m = m[0]
        return m, m.sum(dim=-1, dtype=torch.int32)

    return Case(name, kernel, plain,
                lambda: scan_bound_ms(keys_t, rows_in_range(
                    keys_t, nv, starts[:q], ends[:q], unb[:q]), q),
                lambda: scan_bound_ms(keys_t, int(nv.sum()), q, full=True),
                ("visibility_kernel",))


def victim_case(keys_t, revs, tomb, ttl, nv, start, end, unbounded,
                compact_rev, ttl_cutoff) -> Case:
    """K3 on the given inputs (the wrapper's own argument list): its mask
    and per-partition counts."""
    args = (keys_t, revs, tomb, ttl, nv, start, end, unbounded, compact_rev,
            ttl_cutoff)

    def plain():
        m = compact.victim_mask(*args)
        return m, m.sum(dim=1, dtype=torch.int32)

    return Case("victim_mask", lambda: compact_kernels.victim_mask_batch(*args),
                plain,
                lambda: victim_bound_ms(keys_t, victim_rows_in_range(
                    keys_t, nv, start, end, unbounded)),
                lambda: victim_bound_ms(keys_t, int(nv.sum()), full=True),
                ("victim_kernel",))


def victim_checks(args: tuple, measure_reps: int = 0) -> dict:
    """K3 on ``args`` against the plain version, mask and counts (raises
    where they differ); measured with ``measure_reps``. Adds the victims
    and the tile census."""
    case = victim_case(*args)
    err = case.check()
    m = case.measure(measure_reps) if measure_reps else {}
    keys_t, revs, _tomb, ttl, nv, start, end, unb, _crev, cutoff = args
    m.update(max_abs_err=err, victims=int(case.kernel()[1].sum()),
             tiles=tile_census(keys_t, revs, ttl, nv, start, end, unb, cutoff))
    return m


def describe(name: str, what: str, m: dict) -> str:
    """One measured case as a log line."""
    blocks = (f", (query, block) pairs outside/inside/straddling "
              f"{m['blocks']}" if "blocks" in m else "")
    tiles = f", tiles {m['tiles']}" if "tiles" in m else ""
    return (f"kernel {name} [{what}]: {m['ms']} ms per call back to back, "
            f"device {m['device_ms']} ms ({m['device_records']} kernel "
            f"records per call), one call L2-cold {m['cold_ms']} ms (plain "
            f"{m['plain_ms']} ms, bound "
            f"{m['bound_ms']} ms by {m['bound_by']}, full-scan bound "
            f"{m['bound_full_ms']} ms){blocks}{tiles}, max_abs_err "
            f"{m['max_abs_err']}")


def block_census(keys_t, nv, starts, ends, unb) -> list[int]:
    """(query, block) pairs of a launch that are outside, inside and
    straddling, by the plain classification of the kernel's blocks."""
    cls = scan.block_classes(keys_t, nv, starts, ends, unb)
    return torch.bincount(cls.flatten().long(), minlength=3).tolist()


def pow2_padded(specs: list) -> list:
    """Specs padded to a power of two with copies of the first, as the
    engine pads a batch (``TorchScanner._dev_mask_batch``)."""
    q = 1
    while q < len(specs):
        q *= 2
    return list(specs) + [specs[0]] * (q - len(specs))


def edge_specs(key_at, rows, n_valid: int, read_rev: int) -> list:
    """Queries on the kernels' block edges and the other edge cases of
    their block classification. For each row r of ``rows`` (254: block 0's
    last owned row; 255: its look-ahead row and block 1's first; 256; 510:
    block 1's look-ahead row), a range that starts at row r's key and one
    that ends at it; then start == end, a start past every key, an end below
    every key, a NUL-bound single key and an unbounded end."""
    specs = []
    for r in rows:
        k = key_at(r)
        specs.append((k, key_at(min(r + 300, n_valid - 1)), read_rev))
        specs.append((key_at(max(r - 300, 0)), k, read_rev))
    k = key_at(rows[1])
    specs += [(k, k, read_rev), (b"\xff", b"", read_rev),
              (b"", b"/", read_rev), (k, k + b"\x00", read_rev),
              (k, b"", read_rev)]
    return specs


def check_edges(cols, enc, width: int, specs, dev) -> dict:
    """K1 on each of ``specs``, and K2 on all of them in one launch padded
    as the engine pads a batch, against the plain version (bit-identical,
    else AssertionError). ``cols`` = (keys_t, revs, tomb, n_valid)."""
    err1 = max(scan_case("scan_mask", *cols, *query_tensors(
        enc, width, [spec], dev)).check() for spec in specs)
    q_args = query_tensors(enc, width, pow2_padded(specs), dev)
    err2 = scan_case("scan_mask_q", *cols, *q_args).check()
    return {"scan_mask": err1, "scan_mask_q": err2, "queries": len(specs),
            "blocks": block_census(cols[0], cols[3], *q_args[:3])}


def flipped(row, dev) -> torch.Tensor:
    """A packed uint32 bound row → the kernels' flipped int32 row on dev."""
    return torch.from_numpy(flip_sign(row)).to(dev)


# ------------------------------------------------------------ phases b, d
BENCH_PREFIX = b"/registry/pods/default/pod-"


def bench_key(i: int) -> bytes:
    return BENCH_PREFIX + b"%08d" % i


def bench_layouts(n_keys: int) -> dict:
    """The scan bench's user keys ('/registry/pods/default/pod-%08d') as
    stored chunk rows uint32[n_keys, C]: raw 128-byte keys and the same keys
    encoded. Returns {label: (encoding or None, chunks)}."""
    width = keyops.KEY_WIDTH
    key_bytes = np.zeros((n_keys, width), np.uint8)
    key_bytes[:, : len(BENCH_PREFIX)] = np.frombuffer(BENCH_PREFIX, np.uint8)
    x = np.arange(n_keys, dtype=np.int64)
    for d in range(7, -1, -1):
        key_bytes[:, len(BENCH_PREFIX) + d] = (x % 10) + ord("0")
        x //= 10
    lens = np.full(n_keys, len(BENCH_PREFIX) + 8, np.int32)
    encoding = build_encoding(key_bytes, lens, raw_width=width)
    enc_u8, _ = encoding.encode_keys(key_bytes, lens)
    return {"raw": (None, keyops.bytes_to_chunks(key_bytes)),
            "encoded": (encoding, keyops.bytes_to_chunks(enc_u8))}


def bench_mirror(chunks: np.ndarray, revs_per_key: int, dev):
    """Device columns of the bench mirror, one partition: every key a chain
    of ``revs_per_key`` versions, revisions 1..n ascending, the last
    version of every 10th key tombstoned → (keys_t, revs, tomb, n_valid)."""
    n_keys, c = chunks.shape
    n = n_keys * revs_per_key
    keys_t = (torch.from_numpy(flip_sign(chunks)).to(dev)
              .repeat_interleave(revs_per_key, dim=0).t().contiguous()
              .view(1, c, n))
    revs = torch.arange(1, n + 1, dtype=torch.int64, device=dev).view(1, n)
    tomb = torch.zeros((1, n), dtype=torch.int8, device=dev)
    tomb[0, revs_per_key - 1 :: 10 * revs_per_key] = 1
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    return keys_t, revs, tomb, nv


def kernel_phase(layouts: dict, revs_per_key: int, dev) -> dict:
    """(b): K1/K2 against the plain version on the bench mirror."""
    width = keyops.KEY_WIDTH
    results = {}
    for label, (enc, chunks) in layouts.items():
        n_keys, c = chunks.shape
        n = n_keys * revs_per_key
        specs_q = [
            (b"/registry/pods/", b"/registry/pods0", n // 2),
            (bench_key(n_keys // 4), bench_key(n_keys // 2), n),
            (b"/registry/", b"", n // 3),
            (bench_key(7), bench_key(7) + b"\x00", n),
            (BENCH_PREFIX + b"0000", BENCH_PREFIX + b"0001", n // 5),
            (bench_key(n_keys - 3), b"", n),
            (b"/events/", b"/events0", n),
            (b"", b"", 1),
        ]
        cols = bench_mirror(chunks, revs_per_key, dev)
        for name, specs in (("scan_mask", specs_q[:1]), ("scan_mask_q", specs_q)):
            q_args = query_tensors(enc, width, specs, dev)
            case = scan_case(name, *cols, *q_args)
            err = case.check()
            m = case.measure(reps=20)
            m.update(max_abs_err=err, chunks=c, rows=n, queries=len(specs),
                     blocks=block_census(cols[0], cols[3], *q_args[:3]))
            results[(name, label)] = m
            log(describe(name, f"{label}, C={c}, {n} rows, Q={len(specs)}", m))
        # key starts fall on block edges every lcm(255, revs_per_key) rows
        step = math.lcm(scan.BLOCK_OWNED, revs_per_key)
        rows = sorted({r for r in (254, 255, 256, 510, step - 1, step, step + 1,
                                   n // 2 // step * step) if 0 < r < n})
        edges = check_edges(cols, enc, width, edge_specs(
            lambda r: bench_key(r // revs_per_key), rows, n, n // 2), dev)
        for name in ("scan_mask", "scan_mask_q"):
            results[(name, f"{label} edges")] = {"max_abs_err": edges[name]}
        log(f"kernels scan_mask, scan_mask_q [{label}, {n} rows, "
            f"{edges['queries']} edge queries at rows {rows}]: bit-identical "
            f"to the plain version; (query, block) pairs outside/inside/"
            f"straddling {edges['blocks']}")
        del cols
        torch.cuda.empty_cache()
    return results


def victim_phase(layouts: dict, revs_per_key: int, dev) -> dict:
    """(d): K3 against the plain version on the bench mirror, on long TTL
    chains and on the tile-edge mirror."""
    width = keyops.KEY_WIDTH
    results = {}
    for label, (enc, chunks) in layouts.items():
        n_keys, c = chunks.shape
        n = n_keys * revs_per_key
        keys_t, revs, tomb, nv = bench_mirror(chunks, revs_per_key, dev)
        key_of_row = torch.arange(n, device=dev) // revs_per_key
        ttl = (key_of_row % 3 == 0).to(torch.int8).view(1, n)
        middle = (bench_key(n_keys // 4), bench_key(3 * n_keys // 4))
        # the third case puts the TTL cutoff past the compact revision, so
        # rows that are not superseded expire by their group's verdict alone
        for what, bounds, crev, cutoff in (
                ("unbounded", (b"", b""), n // 2, n // 3),
                ("[start, end)", middle, n // 2, n // 3),
                ("unbounded, cutoff past compact", (b"", b""), n // 3, n // 2)):
            s_row, e_row, unb = bound_rows(enc, width, *bounds)
            m = victim_checks((keys_t, revs, tomb, ttl, nv, flipped(s_row, dev),
                               flipped(e_row, dev), unb, crev, cutoff),
                              measure_reps=20)
            m.update(chunks=c, rows=n)
            results[(label, what)] = m
            log(describe("victim_mask", f"{label}, C={c}, {n} rows, {what}, "
                         f"compact_rev {crev}, ttl_cutoff {cutoff}, "
                         f"{m['victims']} victims", m))
        del keys_t, revs, tomb, ttl, key_of_row
        torch.cuda.empty_cache()
    results[("raw", "long chains")] = long_chain_case(dev)
    results.update(tile_edge_phase(dev))
    return results


def long_chain_case(dev) -> dict:
    """K3 on 24 '/events/chain-NNNN' chains of 1,000-5,853 rows. Revisions
    interleave across chains, so with the TTL cutoff at the median chain end
    about half the TTL chains expire whole and the rest keep every row;
    chains k % 4 == 3 carry no TTL flag, and every fifth chain ends in a
    tombstone."""
    n_chains = 24
    lens = np.array([1000 + 211 * k for k in range(n_chains)])
    key_bytes = np.zeros((n_chains, keyops.KEY_WIDTH), np.uint8)
    for k in range(n_chains):
        uk = b"/events/chain-%04d" % k
        key_bytes[k, : len(uk)] = np.frombuffer(uk, np.uint8)
    chunks = keyops.bytes_to_chunks(key_bytes)
    chain = np.repeat(np.arange(n_chains), lens)
    n = len(chain)
    pos = np.arange(n) - np.repeat(np.cumsum(lens) - lens, lens)
    revs_np = pos * n_chains + chain + 1
    last_rev = (lens - 1) * n_chains + np.arange(n_chains) + 1
    cutoff = int(np.median(last_rev))
    ttl_chain = np.arange(n_chains) % 4 != 3
    expires = ttl_chain & (last_rev <= cutoff)
    if not expires.any() or not (ttl_chain & ~expires).any():
        raise AssertionError("long-chain case lacks an expiring or a kept chain")
    tomb_np = np.zeros(n, bool)
    tomb_np[np.cumsum(lens)[::5] - 1] = True

    keys_t = torch.from_numpy(
        np.ascontiguousarray(flip_sign(chunks[chain]).T)).to(dev).view(1, -1, n)
    revs = torch.from_numpy(revs_np.astype(np.int64)).to(dev).view(1, n)
    tomb = torch.from_numpy(tomb_np.astype(np.int8)).to(dev).view(1, n)
    ttl = torch.from_numpy(ttl_chain[chain].astype(np.int8)).to(dev).view(1, n)
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    zero = flipped(np.zeros(chunks.shape[1], np.uint32), dev)
    compact_rev = int(np.median(revs_np))
    args = (keys_t, revs, tomb, ttl, nv, zero, zero, True, compact_rev, cutoff)
    m = victim_checks(args, measure_reps=20)
    mask = compact_kernels.victim_mask_batch(*args)[0].cpu().numpy()[0]
    if not mask[expires[chain]].all():
        raise AssertionError("a TTL chain past the cutoff did not expire whole")
    m["rows"] = n
    log(describe("victim_mask", f"raw, {n_chains} chains of {lens.min()}-"
                 f"{lens.max()} rows, {n} rows, ttl_cutoff {cutoff}, "
                 f"{int(expires.sum())} chains expire whole, {m['victims']} "
                 f"victims", m))
    return m


def tile_edge_mirror(tile: int, width: int, dev):
    """K3's tile-edge mirror, raw keys cut to ``width`` bytes, P = 3:

    - partition 0: TTL chains '/events/edge-a' .. 'edge-f' of tile-1, tile,
      tile+1, 2·tile, tile and 5·tile rows (b starts on tile 0's last row,
      c ends on tile 2's last row, d fills tiles 3-4, e tile 5 and f tiles
      6-10, so tiles 3 and 6-9 hold no group end), then 37 singletons,
      every seventh row a tombstone;
    - partition 1: empty (n_valid 0);
    - partition 2: '/registry/edge/' chains of 3 rows and one of tile+5
      rows, without TTL;

    revisions ascend with the row inside each partition, and the capacity
    is the largest n_valid + 37, a multiple of neither 4 nor 8 nor the
    tile. Returns (keys_t, revs, tomb, ttl, n_valid, the user key of each
    row of partition 0)."""
    part0 = [b"/events/edge-%s" % name for name, rows in (
        (b"a", tile - 1), (b"b", tile), (b"c", tile + 1), (b"d", 2 * tile),
        (b"e", tile), (b"f", 5 * tile)) for _ in range(rows)]
    part0 += [b"/events/edge-s%04d" % i for i in range(37)]
    part2 = ([b"/registry/edge/k%04d" % (i // 3) for i in range(3 * 40)]
             + [b"/registry/edge/long"] * (tile + 5))
    parts = [part0, [], part2]
    cap = max(len(x) for x in parts) + 37
    keys = np.zeros((3, cap, width), np.uint8)
    revs = np.zeros((3, cap), np.int64)
    tomb = np.zeros((3, cap), np.int8)
    ttl = np.zeros((3, cap), np.int8)
    for p, rows in enumerate(parts):
        for i, k in enumerate(rows):
            keys[p, i, : len(k)] = np.frombuffer(k, np.uint8)
        revs[p, : len(rows)] = np.arange(1, len(rows) + 1)
        tomb[p, : len(rows)] = np.arange(len(rows)) % 7 == 6
        ttl[p, : len(rows)] = [k.startswith(b"/events/") for k in rows]
    chunks = keyops.bytes_to_chunks(keys.reshape(3 * cap, width))
    chunks = chunks.reshape(3, cap, -1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cols = (put(np.transpose(flip_sign(chunks), (0, 2, 1))), put(revs),
            put(tomb), put(ttl), put(np.array([len(x) for x in parts], np.int32)))
    return (*cols, part0)


def tile_edge_phase(dev) -> dict:
    """(d), last: K3 on the tile-edge mirror under six cases, raw (C = 32)
    and narrow (C = 8): mask and counts bit-identical to the plain
    version."""
    tile = compact.TILE_ROWS
    results = {}
    for label, width in (("raw", keyops.KEY_WIDTH), ("narrow", 32)):
        *cols, key0 = tile_edge_mirror(tile, width, dev)
        c = cols[0].shape[1]
        zero = flipped(np.zeros(c, np.uint32), dev)
        at = lambda row: flipped(keyops.pack_one(key0[row], width), dev)
        for what, (s, e), crev, cutoff in (
                ("unbounded, a and b expire", (None, None), 8 * tile, 2 * tile),
                ("unbounded, a-e expire", (None, None), 8 * tile, 6 * tile),
                ("[tile 3, tile 5)", (3 * tile, 5 * tile), 8 * tile, 6 * tile),
                ("[row tile-1, row 2·tile-1)", (tile - 1, 2 * tile - 1),
                 8 * tile, 2 * tile),
                ("unbounded, cutoff 0", (None, None), 8 * tile, 0),
                ("unbounded, cutoff past compact", (None, None), 2 * tile,
                 12 * tile)):
            bounds = (zero, zero, True) if s is None else (at(s), at(e), False)
            args = (*cols, *bounds, crev, cutoff)
            m = victim_checks(args)
            results[(f"tile edges {label}", what)] = m
            log(f"kernel victim_mask [tile edges, {label}, C={c}, P=3, "
                f"n_valid {cols[4].tolist()}, N={cols[0].shape[2]}, tile "
                f"{tile}, {what}, compact_rev {crev}, ttl_cutoff {cutoff}]: "
                f"mask and counts bit-identical to the plain version, "
                f"{m['victims']} victims, tiles {m['tiles']}")
    return results


# ------------------------------------------------------------ phases c, e
def kube_dataset(n_keys: int, seed: int):
    """Sorted (internal key, value) rows shaped like a kube store:
    /events/ singletons, then /registry/pods/ keys in 32 namespaces as
    superseded chains, tombstoned chains and clean singletons; values of
    256–2047 bytes. Returns (rows, top revision)."""
    rng = random.Random(seed)
    rows: list[tuple[bytes, bytes]] = []
    rev = 0
    payload = bytes(range(256)) * 8

    def body(i):
        return payload[: rng.randrange(256, 2048)] + b"#%d" % i

    def version(uk, value):
        nonlocal rev
        rev += 1
        rows.append((coder.encode_object_key(uk, rev), value))
        return rev

    def rev_record(uk, latest, deleted):
        rows.append((coder.encode_revision_key(uk),
                     coder.encode_rev_value(latest, deleted=deleted)))

    n_events = n_keys // 4
    for i in range(n_events):
        uk = b"/events/ns%02d/ev-%06d" % (i % 20, i)
        rev_record(uk, version(uk, body(i)), False)
    for i in range(n_keys - n_events):
        uk = b"/registry/pods/ns%02d/pod-%06d" % (i % 32, i)
        shape = i % 3
        if shape == 0:  # chain of 3-5 versions
            r = version(uk, body(i))
            for j in range(2 + rng.randrange(3)):
                r = version(uk, body(i + j))
            rev_record(uk, r, False)
        elif shape == 1:  # created, then deleted
            version(uk, body(i))
            rev_record(uk, version(uk, TOMBSTONE), True)
        else:
            rev_record(uk, version(uk, body(i)), False)
    rows.sort(key=lambda kv: kv[0])
    return rows, rev


def load_rows(inner, rows, top: int) -> float:
    """Put ``rows`` into ``inner`` (an untracked engine) 1,024 to a batch,
    then ``LAST_REV_KEY`` at ``top``; returns the seconds it took."""
    t0 = time.perf_counter()
    for b0 in range(0, len(rows), 1024):
        bw = inner.begin_batch_write()
        for k, v in rows[b0 : b0 + 1024]:
            bw.put(k, v)
        bw.commit()
    bw = inner.begin_batch_write()
    bw.put(LAST_REV_KEY, coder.encode_rev_value(top))
    bw.commit()
    return time.perf_counter() - t0


def load_store(n_keys: int, seed: int, dev, data=None):
    """A cuda store over memkv, without engine TTL (so /events/ rows expire
    through the compaction history), loaded with :func:`kube_dataset`
    (``data``, when given, is its result) through the untracked inner
    engine. Returns (store, top revision)."""
    t0 = time.perf_counter()
    rows, top = data or kube_dataset(n_keys, seed)
    store = new_storage("cuda", inner="memkv", device=dev, ttl_supported=False)
    load_rows(store.untracked(), rows, top)
    log(f"main path: {n_keys} user keys, {len(rows)} store rows, top revision "
        f"{top}, loaded in {time.perf_counter() - t0:.1f} s")
    return store, top


def same_kvs(got, want, what: str) -> None:
    g = [(kv.key, kv.value, kv.revision) for kv in got]
    w = [(kv.key, kv.value, kv.revision) for kv in want]
    if g != w:
        raise AssertionError(f"{what}: {len(g)} rows differ from the host "
                             f"scanner's {len(w)}")


def check_batch(batch, results, oracle, head: int) -> None:
    """Every answer of one ``list_batch`` against the host scanner."""
    for q, res in zip(batch, results):
        rr = q[3] or head
        if isinstance(res, BaseException):
            raise res
        if q[0] == "count":
            if res[0] != oracle.count(q[1], q[2], rr):
                raise AssertionError(f"batched count {q} differs")
        else:
            same_kvs(res.kvs, oracle.range_(q[1], q[2], rr)[0],
                     f"batched range {q}")


#: counters that move only when a merge or compaction failed, or reads left
#: the device for the host scanner (quarantine, background rebuild)
OFF_DEVICE_COUNTERS = (
    "merge_bg_errors", "merge_retries_total", "merge_escalations_total",
    "compact_errors", "compact_retries_total", "compact_escalations_total",
    "degraded_seconds_total", "rebuild_bg_count")


def stayed_on_device(scanner, rebuilds: int, what: str) -> None:
    """Fail unless every read and merge since the mirror's first publish was
    served on the device: no failure absorbed by a retry, no degraded
    window, no rebuild from the store beyond ``rebuilds``."""
    moved = {k: getattr(scanner, k) for k in OFF_DEVICE_COUNTERS
             if getattr(scanner, k)}
    if scanner.full_rebuild_total != rebuilds:
        moved["full_rebuild_total"] = scanner.full_rebuild_total - rebuilds
    if moved or scanner._mirror_state != "serving":
        raise AssertionError(f"{what}: part of the path left the device: "
                             f"{moved}, mirror {scanner._mirror_state}")
    log(f"{what}: no merge or compaction error, retry, escalation, degraded "
        f"second or rebuild from the store")


NS = (b"/registry/pods/ns05/", b"/registry/pods/ns050")
PODS = (b"/registry/pods/", b"/registry/pods0")


def request_batch(top: int) -> list:
    """The ``list_batch`` of the main path: 8 queries, 2 of them Counts."""
    old = top // 2
    return [
        ("list", b"/registry/pods/ns01/", b"/registry/pods/ns010", 0, 0),
        ("list", b"/registry/pods/ns02/", b"/registry/pods/ns020", old, 0),
        ("count", b"/registry/pods/", b"/registry/pods0", 0),
        ("list", b"/events/ns03/", b"/events/ns030", 0, 0),
        ("list", b"/registry/pods/ns31/pod-0001", b"/registry/pods/ns31/pod-0005", 0, 0),
        ("count", b"/events/", b"/events0", old),
        ("list", b"/registry/pods/ns07/", b"/registry/pods/ns070", top // 3, 0),
        ("list", b"/registry/pods/ns09/pod-", b"", 0, 0),
    ]


def serve_requests(backend, oracle, top: int, what: str,
                   reps: int = 3) -> dict:
    """The main path's request set, ``reps`` times each, then three writes
    and the reads through the delta overlay; every response against the
    host scanner ``oracle`` over the same store. K1 and K2 must launch.
    Returns the latencies by request kind, the launches and the transfer."""
    if backend.current_revision() != top:
        raise AssertionError(f"{what}: backend did not recover the top "
                             f"revision")
    lat: dict[str, list[float]] = {}

    def timed(kind, fn):
        t = time.perf_counter()
        out = fn()
        lat.setdefault(kind, []).append(time.perf_counter() - t)
        return out

    old = top // 2
    batch = request_batch(top)
    TRANSFER_METER.bytes = TRANSFER_METER.pulls = 0
    scan_kernels.reset_launch_counts()
    for _ in range(reps):
        r_ns = timed("range_namespace", lambda: backend.list_(*NS))
        r_all = timed("range_all_pods", lambda: backend.list_(*PODS))
        r_cnt = timed("count", lambda: backend.count(*PODS))
        r_old = timed("range_old_revision",
                      lambda: backend.list_(*NS, revision=old))
        r_batch = timed("list_batch_8", lambda: backend.list_batch(batch))
    # writes, then reads through the delta overlay
    k_new = b"/registry/pods/ns05/pod-new"
    backend.create(k_new, b"fresh")
    k_upd = next(kv for kv in r_ns.kvs)
    backend.update(k_upd.key, b"updated", k_upd.revision)
    backend.delete(r_ns.kvs[1].key)
    for _ in range(reps):
        r_ovl = timed("range_overlay", lambda: backend.list_(*NS))
        c_ovl = timed("count_overlay", lambda: backend.count(*PODS))
    launches = {"scan_mask": scan_kernels.visibility_mask_batch.launches,
                "scan_mask_q": scan_kernels.visibility_mask_batch_q.launches}
    moved = TRANSFER_METER.snapshot()

    head = backend.current_revision()
    same_kvs(r_ns.kvs, oracle.range_(*NS, top)[0], f"{what}: namespace range")
    same_kvs(r_all.kvs, oracle.range_(*PODS, top)[0], f"{what}: pods range")
    if r_cnt[0] != oracle.count(*PODS, top):
        raise AssertionError(f"{what}: count differs from the host scanner")
    same_kvs(r_old.kvs, oracle.range_(*NS, old)[0],
             f"{what}: old-revision range")
    check_batch(batch, r_batch, oracle, top)
    same_kvs(r_ovl.kvs, oracle.range_(*NS, head)[0], f"{what}: overlay range")
    if c_ovl[0] != oracle.count(*PODS, head):
        raise AssertionError(f"{what}: overlay count differs from the host "
                             f"scanner")
    log(f"{what}: every response equals the host scanner "
        f"(pods range {len(r_all.kvs)} kvs, count {r_cnt[0]}, "
        f"overlay count {c_ovl[0]})")
    for kind, ts in lat.items():
        log(f"{what}: p50 {kind}: {statistics.median(ts) * 1e3:.3f} ms "
            f"over {len(ts)} requests")
    log(f"{what}: launches K1 {launches['scan_mask']}, "
        f"K2 {launches['scan_mask_q']}; device->host {moved[0]} bytes "
        f"in {moved[1]} pulls")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{what}: a kernel of the path never launched: "
                             f"{launches}")
    return {"lat": lat, "launches": launches, "batch": batch, "head": head}


def serve_phase(backend, store, top: int, dev) -> tuple[dict, dict]:
    """(c): the read path against the host scanner over the same store."""
    oracle = Scanner(store.untracked(), get_compact_revision=lambda _s: 0)
    try:
        t0 = time.perf_counter()
        backend.scanner.publish()
        rebuilds = backend.scanner.full_rebuild_total
        m = backend.scanner._mirror
        log(f"mirror published in {time.perf_counter() - t0:.1f} s: "
            f"{m.rows} rows, capacity {m.keys_host.shape[1]}, "
            f"{m.keys_host.shape[2]} chunks/key, encoded={m.encoding is not None}")
        served = serve_requests(backend, oracle, top, "main path")
        launches, batch, head = (served["launches"], served["batch"],
                                 served["head"])

        # where one Range's time goes, stage by stage (host clock)
        scanner = backend.scanner
        mirror = scanner._mirror
        for label, (s, e) in (("namespace", NS), ("all pods", PODS)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mask, counts = scanner._dev_mask(mirror, s, e, head)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total, idx = scanner._dev_visible_indices(
                mask, counts, mirror.keys_host.shape[1])
            t2 = time.perf_counter()
            scanner._materialize_visible(mirror, idx, {})
            t3 = time.perf_counter()
            log(f"stages [{label} range, {total} rows]: bounds+K1 "
                f"{(t1 - t0) * 1e3:.3f} ms, counts+J1+pull "
                f"{(t2 - t1) * 1e3:.3f} ms, host materialize "
                f"{(t3 - t2) * 1e3:.3f} ms")

        # both kernels against the plain version at the mirror's own shape
        cases = {}
        cols = (mirror.keys_dev, mirror.revs_dev, mirror.tomb_dev,
                mirror.n_valid_dev)
        p, c, n = mirror.keys_dev.shape
        for name, specs in (
                ("scan_mask", [(*NS, head)]),
                ("scan_mask_q", [(q[1], q[2], q[3] or head) for q in batch])):
            q_args = query_tensors(mirror.encoding, mirror.key_width, specs, dev)
            case = scan_case(name, *cols, *q_args)
            err = case.check()
            m = case.measure(reps=50)
            m.update(max_abs_err=err,
                     blocks=block_census(cols[0], cols[3], *q_args[:3]))
            log(describe(name, f"main path mirror, P={p}, C={c}, N={n}, "
                         f"Q={len(specs)}", m))
            cases[name] = m
        nv0 = int(mirror.n_valid[0])
        mid = nv0 // 2 // scan.BLOCK_OWNED * scan.BLOCK_OWNED
        rows = sorted({r for r in (254, 255, 256, 510, mid + 254, mid + 255,
                                   mid + 256, mid + 510) if 0 < r < nv0})
        edges = check_edges(cols, mirror.encoding, mirror.key_width,
                            edge_specs(lambda r: mirror.user_key(0, r), rows,
                                       nv0, head), dev)
        for name in ("scan_mask", "scan_mask_q"):
            cases[name]["max_abs_err"] = max(cases[name]["max_abs_err"],
                                             edges[name])
        log(f"kernels scan_mask, scan_mask_q [main path mirror, "
            f"{edges['queries']} edge queries at rows {rows}]: bit-identical "
            f"to the plain version; (query, block) pairs outside/inside/"
            f"straddling {edges['blocks']}")
        # J1 (mask -> index block) beside its one-call yardstick
        mask, counts = scan_case(
            "scan_mask", mirror.keys_dev, mirror.revs_dev, mirror.tomb_dev,
            mirror.n_valid_dev, *query_tensors(
                mirror.encoding, mirror.key_width, [(*PODS, head)],
                dev)).kernel()
        size = 1
        while size < int(counts.max()):
            size *= 2
        j1 = time_ms(lambda: _part_indices_of_mask(mask, size), 20)
        nz = time_ms(lambda: torch.nonzero(mask), 20)
        log(f"J1 index compaction [{tuple(mask.shape)}, {int(counts.sum())} "
            f"visible, size {size}]: {j1} ms (torch.nonzero {nz} ms)")
        stayed_on_device(scanner, rebuilds, "serve")
        return launches, cases
    finally:
        oracle.close()


def compact_recording(backend, rev: int):
    """``Backend.compact`` with the CompactStats of each border pair kept
    (the Backend drops them) → (revision, [stats], wall seconds)."""
    seen = []
    orig = backend.scanner.compact

    def keep(start, end, r):
        seen.append(orig(start, end, r))
        return seen[-1]

    backend.scanner.compact = keep
    try:
        t0 = time.perf_counter()
        done = backend.compact(rev)
        wall = time.perf_counter() - t0
    finally:
        del backend.scanner.compact
    return done, seen, wall


def victim_totals(stats) -> tuple[int, ...]:
    return tuple(sum(getattr(s, f) for s in stats) for f in VICTIM_FIELDS)


def same_store(a, b) -> int:
    """Both stores hold the same live rows, in order; returns the count."""
    n = 0
    for x, y in itertools.zip_longest(a.iter(b"", b""), b.iter(b"", b"")):
        if x != y:
            raise AssertionError(f"store dumps differ at row {n}: "
                                 f"{x and x[0]!r} vs {y and y[0]!r}")
        n += 1
    return n


def compact_phase(backend, store, top: int, n_keys: int, dev,
                  twin_factory=None, what: str = "compact",
                  measure_reps: int = 50) -> dict:
    """(e): Backend.compact on the main path against the host scanner's
    compaction of a twin store: ``twin_factory()`` (an engine of the same
    kind as the store's inner one; memkv without engine TTL by default),
    filled from a dump of the store. An engine with TTL of its own expires
    no row through the compaction history, so the TTL victims are required
    only of one without."""
    scanner = backend.scanner
    inner = store.untracked()
    twin_factory = twin_factory or (
        lambda: new_storage("memkv", ttl_supported=False))
    # a pending delta: a few hundred writes after the last read, some of
    # them new versions of /events/ keys that would otherwise expire
    pend: dict[bytes, int] = {}
    for i in range(240):
        k = b"/registry/pods/ns%02d/pending-%04d" % (i % 32, i)
        pend[k] = backend.create(k, b"pending-%d" % i)
    for i, k in enumerate(list(pend)[:60]):
        pend[k] = backend.update(k, b"pending-upd-%d" % i, pend[k])
    for k in list(pend)[60:100]:
        backend.delete(k, pend.pop(k))
    for i in range(0, 400, 40):
        ev = backend.get(b"/events/ns%02d/ev-%06d" % (i % 20, i))
        backend.update(ev.key, b"event-again", ev.revision)
    n_pending = len(scanner._delta)
    if n_pending < 300:
        raise AssertionError(f"only {n_pending} rows pending in the delta")

    compact_rev = top      # every loaded row; every write above stays above
    ttl_rev = n_keys // 8  # about half the /events/ singletons
    aged = time.time() - 2 * EVENTS_TTL_SECONDS

    t0 = time.perf_counter()
    twin = twin_factory()
    rows = inner.iter(b"", b"")
    while True:
        chunk = list(itertools.islice(rows, 1024))
        if not chunk:
            break
        bw = twin.begin_batch_write()
        for k, v in chunk:
            bw.put(k, v)
        bw.commit()
    twin_backend = Backend(twin, BackendConfig())
    log(f"{what}: twin {type(twin).__name__} filled from a dump in "
        f"{time.perf_counter() - t0:.1f} s; {n_pending} rows pending")
    oracle = Scanner(inner, get_compact_revision=lambda _s: 0)
    try:
        for b in (backend, twin_backend):
            b.scanner.compact_history.log(ttl_rev, now=aged)

        # the mirror and borders K3 marked on the main path, kept to hold K3
        # against the plain version afterwards on the same inputs
        marked = []
        mark = scanner._victim_mask

        def mark_recording(*args):
            marked.append(args)
            return mark(*args)

        rebuilds = scanner.full_rebuild_total
        scan_kernels.reset_launch_counts()
        compact_kernels.reset_launch_counts()
        scanner._victim_mask = mark_recording
        try:
            done, dev_stats, dev_wall = compact_recording(backend, compact_rev)
        finally:
            del scanner._victim_mask
        launches = compact_kernels.victim_mask_batch.launches
        host_done, host_stats, host_wall = compact_recording(twin_backend,
                                                             compact_rev)

        for s in dev_stats:
            log(f"{what} [device, {s.mirror_path}]: scanned {s.scanned}, "
                f"survivors {s.survivor_rows}, dirty partitions "
                f"{s.dirty_partitions}, phases " + ", ".join(
                    f"{k} {v} s" for k, v in s.phase_seconds.items()))
        log(f"{what}: device path {dev_wall} s, host scanner on the twin "
            f"{host_wall} s; victims (versions, tombstones, rev records, "
            f"ttl) device {victim_totals(dev_stats)}, host "
            f"{victim_totals(host_stats)}; K3 launches {launches}")
        if done != compact_rev or host_done != compact_rev:
            raise AssertionError(f"compacted to {done}/{host_done}, "
                                 f"not {compact_rev}")
        if victim_totals(dev_stats) != victim_totals(host_stats):
            raise AssertionError("CompactStats victim fields differ")
        if victim_totals(dev_stats)[3] <= 0 and not inner.support_ttl():
            raise AssertionError("no /events/ row expired by TTL")
        n_rows = same_store(inner, twin)
        counts = ((inner.version_count(), twin.version_count())
                  if hasattr(inner, "version_count") else ("none", "none"))
        if counts[0] != counts[1]:
            raise AssertionError(f"version_count differs: {counts}")
        if scanner.full_rebuild_total != rebuilds:
            raise AssertionError("compaction rebuilt the mirror from the store")
        if {s.mirror_path for s in dev_stats} != {"stored_incremental"}:
            raise AssertionError("mirror path not stored_incremental")
        if len(scanner._delta) or scanner._mirror_state != "serving":
            raise AssertionError("pending delta not merged, or not serving")
        if launches <= 0:
            raise AssertionError("K3 never launched on the main path")
        log(f"{what}: store dumps equal ({n_rows} rows), version_count "
            f"{counts[0]} on both (none: the engine does not count them)")

        # every read after compaction against the host scanner
        head = backend.current_revision()
        ranges = [(b"/registry/pods/ns05/", b"/registry/pods/ns050"),
                  (b"/registry/pods/", b"/registry/pods0"),
                  (b"/events/", b"/events0"),
                  (b"/registry/pods/ns07/pending-", b"/registry/pods/ns07/pending.")]
        for rev in (0, compact_rev):
            for s, e in ranges:
                same_kvs(backend.list_(s, e, revision=rev).kvs,
                         oracle.range_(s, e, rev or head)[0],
                         f"post-compact range {s!r} at {rev}")
                if backend.count(s, e, revision=rev)[0] != oracle.count(
                        s, e, rev or head):
                    raise AssertionError(f"post-compact count {s!r} at {rev}")
        batch = [("list", s, e, rev, 0) for s, e in ranges[:3]
                 for rev in (0, compact_rev)] + [
            ("count", b"/registry/pods/", b"/registry/pods0", compact_rev),
            ("count", b"/events/", b"/events0", 0)]
        check_batch(batch, backend.list_batch(batch), oracle, head)
        log(f"{what}: every Range, Count and list_batch after compaction "
            "equals the host scanner")

        # K3 against the plain version on the main path's own inputs
        args = scanner._victim_args(*marked[0])
        m = victim_checks(args, measure_reps=measure_reps)
        p, c, n = args[0].shape
        if measure_reps:
            log(describe("victim_mask", f"main path mirror, P={p}, C={c}, "
                         f"N={n}, {m['victims']} victims", m))
        else:
            log(f"{what}: kernel victim_mask [P={p}, C={c}, N={n}, "
                f"{m['victims']} victims]: mask and counts bit-identical to "
                f"the plain version")
        stayed_on_device(scanner, rebuilds, what)
        return {"launches": launches, "case": m, "wall_s": dev_wall,
                "host_wall_s": host_wall,
                "phase_seconds": [dict(s.phase_seconds) for s in dev_stats]}
    finally:
        oracle.close()
        twin_backend.close()
        twin.close()


# ------------------------------------------------------------------ phase f
FANOUT_KINDS = (b"pods", b"leases", b"endpoints", b"configmaps")
FANOUT_NAMESPACES = [b"ns-%03d" % i for i in range(40)]


def fanout_population(n_watchers: int, n_broad: int, rng) -> list:
    """Watcher specs ``[(wid, start, end, min_rev)]`` shaped like
    ``bench.py``'s fan-out population (``_fanout_population``,
    bench.py:161-186): kind/namespace prefix ranges (the informer shape),
    about 2% single-key watches whose end is ``key + b"\\0"``, ``min_rev``
    0-255, and ``n_broad`` unbounded watches over the whole registry. The
    broad cohort makes the hub's interval index dense, which routes every
    block to the matcher."""
    specs = []
    for w in range(n_watchers - n_broad):
        ns = FANOUT_NAMESPACES[rng.randint(len(FANOUT_NAMESPACES))]
        kind = FANOUT_KINDS[rng.randint(len(FANOUT_KINDS))]
        if rng.rand() < 0.02:
            key = b"/registry/%s/%s/obj-%05d" % (kind, ns, rng.randint(4096))
            specs.append((w, key, key + b"\x00", int(rng.randint(0, 256))))
        else:
            start = b"/registry/%s/%s/" % (kind, ns)
            end = start[:-1] + bytes([start[-1] + 1])
            specs.append((w, start, end, int(rng.randint(0, 256))))
    for b in range(n_broad):
        specs.append((n_watchers - n_broad + b, b"/registry/", b"", 0))
    return specs


def fanout_key(rng) -> bytes:
    return b"/registry/%s/%s/obj-%05d" % (
        FANOUT_KINDS[rng.randint(len(FANOUT_KINDS))],
        FANOUT_NAMESPACES[rng.randint(len(FANOUT_NAMESPACES))],
        rng.randint(4096))


def fanout_events(n_events: int, rev0: int, rng) -> list:
    """Events of ``bench.py``'s ``_fanout_events`` (bench.py:189-204)."""
    return [WatchEvent(revision=rev0 + i, key=fanout_key(rng), value=b"v")
            for i in range(n_events)]


def fanout_bound_ms(w: int, n_ev: int, c: int, out_bytes: int
                    ) -> tuple[float, str]:
    """The compare bound of the chunk-compare design (kept so that its
    rows stay comparable): the live events (keys, revision) and the
    watcher table (two bound rows, flag, min_rev) read once, the outputs
    (``out_bytes``) written once, over the memory rate; or the compares,
    two lexicographic compares of C chunks and one revision compare per
    (watcher, live event) pair, over the vector rate. Rank space does less
    work than this."""
    return _bound(n_ev * (4 * c + 8) + w * (8 * c + 9) + out_bytes,
                  w * n_ev * (2 * c + 1))


def fanout_least_bound_ms(w: int, n_ev: int, c: int, n_u: int,
                          out_bytes: int) -> tuple[float, str]:
    """Least time for one fan-out call in rank space: the live events
    (keys, revision), the table's rank index (rows of ``U``, each slot's
    two ranks) and its flag and min_rev read once, the outputs
    (``out_bytes``) written once, over the memory rate; or 3 compares per
    (watcher, live event) pair plus the rank searches, log2(n_u) steps of
    C chunk compares per live event, over the vector rate."""
    steps = max(n_u, 1).bit_length()
    return _bound(n_ev * (4 * c + 8) + n_u * 4 * c + w * 17 + out_bytes,
                  3 * w * n_ev + n_ev * steps * c)


def share(m: dict) -> float | None:
    """The bound's share of the device time (at most 1)."""
    if m.get("device_ms"):
        return m["bound_ms"] / m["device_ms"]
    return None


def dispatch_case(ev, n_ev: int, cols, size: int, index) -> Case:
    """K4 on one packed block with the table's rank index: (counts, idx)
    against the plain version by chunk compares, which the emulation of
    K4's kernels in rank space must equal too."""
    args = (*ev, n_ev, *cols, size)
    w, c = cols[0].shape
    n_u = index.rows.shape[0]
    return Case("fanout_dispatch",
                lambda: fanout_kernels.fanout_dispatch(*args, index=index),
                lambda: fanout.fanout_dispatch_plain(*args),
                lambda: fanout_least_bound_ms(w, n_ev, c, n_u,
                                              4 * w + 4 * size),
                lambda: fanout_bound_ms(w, n_ev, c, 4 * w + 4 * size),
                ("fanout_rank_kernel", "fanout_match_kernel"),
                lambda: fanout.fanout_dispatch_ranked(*args, index=index))


def mask_case(ev, n_ev: int, cols, index) -> Case:
    """K5 on one packed block with the table's rank index: the E-major
    mask against the plain version by chunk compares (rows past n_ev
    False), which the plain version in rank space must equal too."""
    args = (*ev, n_ev, *cols)
    w, c = cols[0].shape
    e = ev[0].shape[0]
    n_u = index.rows.shape[0]

    def plain():
        m = fanout.fanout_mask_range(*ev, *cols)
        m[n_ev:] = False
        return m

    return Case("fanout_mask_range",
                lambda: fanout_kernels.fanout_mask_range(*args, index=index),
                plain,
                lambda: fanout_least_bound_ms(w, n_ev, c, n_u, e * w),
                lambda: fanout_bound_ms(w, n_ev, c, e * w),
                ("fanout_rank_kernel", "fanout_mask_kernel"),
                lambda: fanout.fanout_mask_rank_plain(*args, index=index))


def packed_block(specs, events, dev, width=None):
    """A matcher's table synced to ``specs`` and ``events`` packed at its
    width → (matcher, (keys, revs) on dev, the table's device columns,
    its rank index, slot → wid)."""
    m = DeviceFanout(width=width, device=dev)
    m.table.sync(specs, version=1)
    ek, er, _epad = m._pack_events(events)
    ws, we, wu, wr, index, wids, _v = m.table.ranked_view()
    return m, (ek, er), (ws, we, wu, wr), index, wids


def fanout_checks(case: Case, reps: int) -> dict:
    """``case`` against its plain version (raises where they differ), then
    measured with ``reps`` (0: not measured); the launches of its wrapper
    over the whole check are counted."""
    fanout_kernels.reset_launch_counts()
    err = case.check()
    m = case.measure(reps) if reps else {}
    wrapper = getattr(fanout_kernels, case.name)
    m.update(max_abs_err=err, launches=wrapper.launches)
    if "ms" in m:
        m["share"] = share(m)
        if m["share"] is not None and m["share"] > 1:
            raise AssertionError(f"{case.name}: a share of "
                                 f"{m['share']} of its bound")
    return m


def describe_fanout(what: str, m: dict) -> str:
    timed = (f"{m['ms']} ms per call back to back, device {m['device_ms']} "
             f"ms ({m['device_records']} kernel records per call), one call "
             f"L2-cold {m['cold_ms']} ms (plain {m['plain_ms']} ms, bound "
             f"{m['bound_ms']} ms by {m['bound_by']}, share {m['share']}; "
             f"compare bound {m['bound_full_ms']} ms), "
             if "ms" in m else "")
    return (f"kernel {what}: {timed}launches {m['launches']}, max_abs_err "
            f"{m['max_abs_err']}")


def pairs_of(counts, idx, wids, epad: int) -> set:
    """(wid, event) pairs of one K4 result."""
    total = int(counts.sum())
    flat = idx[:total].cpu().numpy().astype(np.int64)
    return {(int(wids[f // epad]), int(f % epad)) for f in flat}


def oracle_pairs(events, specs) -> set:
    mask = match_oracle(events, specs)
    return {(specs[j][0], i) for i, j in zip(*np.nonzero(mask))}


#: watchers of a kernel case held against match_oracle (all of them in a
#: smaller case): the oracle is brute force in Python
ORACLE_WATCHERS = 256


def check_oracle(case: Case, events, specs, wids, epad: int, seed: int) -> int:
    """K4's or K5's result on ``case`` against ``match_oracle`` for every
    watcher of ``specs`` or a seeded sample of ``ORACLE_WATCHERS`` of them,
    over every event (raises where they differ); the pairs compared."""
    rng = np.random.RandomState(seed)
    pick = (specs if len(specs) <= ORACLE_WATCHERS else
            [specs[i] for i in rng.choice(len(specs), ORACLE_WATCHERS,
                                          replace=False)])
    want = oracle_pairs(events, pick)
    keep = {wid for wid, *_r in pick}
    got = case.kernel()
    if case.name == "fanout_dispatch":
        pairs = pairs_of(got[0], got[1], wids, epad)
    else:
        slot_of = {int(wid): s for s, wid in enumerate(wids)}
        cols = torch.tensor([slot_of[wid] for wid in sorted(keep)])
        sub = got[:len(events)].cpu()[:, cols].numpy()
        pairs = {(sorted(keep)[j], i) for i, j in zip(*np.nonzero(sub))}
    got_pairs = {p for p in pairs if p[0] in keep}
    if got_pairs != want:
        raise AssertionError(f"{case.name}: {len(got_pairs ^ want)} pairs "
                             f"differ from match_oracle")
    return len(pick) * len(events)


def rank_index_ms(cols, index, reps: int) -> float:
    """The rank index's rebuild from the table's bound rows (what a change
    of the watcher set costs), time per build; it must equal ``index``."""
    again = fanout.rank_index_plain(cols[0], cols[1])
    if not all(torch.equal(a, b) for a, b in zip(again, index)):
        raise AssertionError("a rebuilt rank index differs")
    return time_ms(lambda: fanout.rank_index_plain(cols[0], cols[1]), reps)


def check_index_rows(table, what: str) -> None:
    """The table's rank index names each slot's own bound rows, in rows
    that are sorted and distinct (raises otherwise)."""
    ws, we, _wu, _wr, (rows, rs, re), _wids, _v = table.ranked_view()
    ok = (torch.equal(rows[rs.long()], ws) and torch.equal(rows[re.long()], we)
          and bool(fanout._rows_less(rows[:-1], rows[1:]).all()))
    if not ok:
        raise AssertionError(f"{what}: the rank index does not fit the table")


#: a watcher-set change of each kind the table's publication handles apart
CHURN_KINDS = ("same range", "new key", "min_rev")


def index_churn(m, specs, reps: int, rng) -> tuple[dict, list]:
    """The table's publication after one watcher-set change, ``reps`` times
    of each kind: a watcher re-established on the same range (in the slot
    it left, so no index work), one replaced by a single-key watch of a new
    key (the rank kernel, one pull, two rows into the index), a ``min_rev``
    change (no index work). Host ms of ``ranked_view()`` (to a
    device sync) and of the index update in it, median; the specs after."""
    table = m.table
    live = list(specs)
    wid = max(w for w, *_r in live) + 1
    version = 1000
    out = {}
    for kind in CHURN_KINDS:
        updates = table.stats()["index_updates"]
        pub, idx = [], []
        for _ in range(reps):
            old, s, e, r = live.pop(rng.randint(len(live)))
            if kind == "same range":
                live.append((wid, s, e, r))
            elif kind == "new key":
                key = b"/registry/pods/churn/obj-%07d" % wid
                live.append((wid, key, key + b"\x00", r))
            else:
                live.append((old, s, e, r + 1))
            wid += 1
            version += 1
            table.sync(live, version)
            before = table.stats()["index_s"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            table.ranked_view()
            torch.cuda.synchronize()
            pub.append(time.perf_counter() - t)
            idx.append(table.stats()["index_s"] - before)
        made = table.stats()["index_updates"] - updates
        if made != (reps if kind == "new key" else 0):
            raise AssertionError(f"{kind}: {made} index updates in {reps} "
                                 f"publications")
        out[kind] = {"publish_ms": statistics.median(pub) * 1e3,
                     "index_ms": statistics.median(idx) * 1e3}
    check_index_rows(table, "after churn")
    out["index_rows"] = table.stats()["index_rows"]
    return out, live


def edge_block(rng):
    """Phase (f)(iii): specs and events of the match rule's edges on a
    population of 600 (i)-shaped watchers, with 700 more to be freed."""
    base = b"/registry/pods/ns-001/obj-00007"
    specs = fanout_population(1300, 30, rng)
    wid = 2000
    edges = [
        (base, base + b"9", 0),                   # an event key == start
        (b"/registry/pods/", base, 0),            # an event key == end
        (base, base + b"\x00", 0),                # NUL-bound single key
        (base + b"\x00", b"", 0),                 # strictly after base
        (b"/registry/", b"", 501),                # rev == min_rev
        (b"/registry/", b"", 502),                # rev == min_rev - 1
    ]
    specs += [(wid + i, s, e, r) for i, (s, e, r) in enumerate(edges)]
    events = fanout_events(93, 400, rng)
    events += [WatchEvent(revision=501, key=base),
               WatchEvent(revision=502, key=base + b"0"),
               WatchEvent(revision=503, key=base + b"9")]
    return specs, events


def fanout_kernel_phase(dev, n_w: int, n_e: int, big_w: int, big_e: int,
                        seed: int, deep_e: int = 40_000) -> dict:
    """Phase (f) kernel cases (i)-(vi): K4 and K5 against the plain
    versions, bit for bit, and against ``match_oracle``."""
    rng = np.random.RandomState(seed)
    out = {}

    # (i) the bench shape
    specs = fanout_population(n_w, n_w // 100, rng)
    events = fanout_events(n_e, 1, rng)
    m, ev, cols, index, wids = packed_block(specs, events, dev)
    w, c = cols[0].shape
    counts, _ = fanout.fanout_dispatch_plain(*ev, n_e, *cols, 1)
    total = int(counts.sum())
    size = fanout.pow2_at_least(total, 128)
    case = dispatch_case(ev, n_e, cols, size, index)
    res = fanout_checks(case, 50)
    res.update(pairs=total, shape=(w, n_e, c), n_u=index.rows.shape[0],
               oracle_pairs=check_oracle(case, events, specs, wids,
                                         ev[0].shape[0], seed),
               index_ms=rank_index_ms(cols, index, 20))
    res["churn"], churned = index_churn(m, specs, 20, rng)
    ccols = m.table.ranked_view()
    ccase = dispatch_case(ev, n_e, ccols[:4], size, ccols[4])
    fanout_checks(ccase, 0)
    res["churn"]["oracle_pairs"] = check_oracle(
        ccase, events, churned, ccols[5], ev[0].shape[0], seed)
    out[("fanout_dispatch", "i")] = res
    log(describe_fanout(f"fanout_dispatch [(i) {n_w} watchers, {n_w // 100} "
                        f"broad, W={w}, E={n_e}, C={c}, n_u={res['n_u']}, "
                        f"{total} pairs, size {size}]", res))
    log(f"(i): rank index rebuilt in {res['index_ms']} ms (W={w}); "
        f"{res['oracle_pairs']} pairs equal to match_oracle; publication "
        f"after one watcher-set change (host ms, median of 20, the index "
        f"update in it) {res['churn']}: K4 after the churn bit-identical to "
        f"the plain versions, {res['churn']['oracle_pairs']} pairs equal to "
        f"match_oracle")
    # (iv) K5 at EVENT_BATCH and at the full block, on the legacy matcher's
    # own table (W padded to a power of two, 128-byte keys)
    legacy = fanout.FanoutMatcher(device=dev)
    lcols = legacy._watcher_table(specs, version=1)
    lwids = np.full(lcols[0].shape[0], -1, np.int64)
    lwids[:len(specs)] = [wid for wid, *_r in specs]
    for n_ev in (300, n_e):
        lev = legacy_block(events[:n_ev], dev)
        case = mask_case(lev, n_ev, lcols, legacy._index)
        res = fanout_checks(case, 20)
        lw, lc = lcols[0].shape
        res.update(shape=(lw, lev[0].shape[0], lc),
                   oracle_pairs=check_oracle(case, events[:n_ev], specs,
                                             lwids, lev[0].shape[0], seed))
        out[("fanout_mask_range", f"iv {n_ev}")] = res
        log(describe_fanout(f"fanout_mask_range [(iv) {n_w} watchers, "
                            f"W={lw}, E={lev[0].shape[0]}, n_ev={n_ev}, "
                            f"C={lc}, n_u={legacy._index.rows.shape[0]}]",
                            res))
    del m, ev, cols, index

    # (ii) ten times the watchers, eight times the events
    specs = fanout_population(big_w, big_w // 100, rng)
    events = fanout_events(big_e, 1, rng)
    t0 = time.perf_counter()
    m, ev, cols, index, wids = packed_block(specs, events, dev)
    packed_s = time.perf_counter() - t0
    w, c = cols[0].shape
    counts, _ = fanout.fanout_dispatch_plain(*ev, big_e, *cols, 1)
    total = int(counts.sum())
    size = fanout.pow2_at_least(total, 128)
    case = dispatch_case(ev, big_e, cols, size, index)
    res = fanout_checks(case, 10)
    res.update(pairs=total, shape=(w, big_e, c), n_u=index.rows.shape[0],
               oracle_pairs=check_oracle(case, events, specs, wids,
                                         ev[0].shape[0], seed),
               index_ms=rank_index_ms(cols, index, 10))
    res["churn"], _churned = index_churn(m, specs, 10, rng)
    ccols = m.table.ranked_view()
    fanout_checks(dispatch_case(ev, big_e, ccols[:4], size, ccols[4]), 0)
    del ccols
    out[("fanout_dispatch", "ii")] = res
    log(describe_fanout(f"fanout_dispatch [(ii) {big_w} watchers, "
                        f"{big_w // 100} broad, W={w}, E={big_e}, C={c}, "
                        f"n_u={res['n_u']}, {total} pairs, size {size}; "
                        f"table packed in {packed_s:.1f} s]", res))
    log(f"(ii): rank index rebuilt in {res['index_ms']} ms (W={w}); "
        f"{res['oracle_pairs']} pairs equal to match_oracle; publication "
        f"after one watcher-set change (host ms, median of 10) "
        f"{res['churn']}: K4 after the churn bit-identical to the plain "
        f"versions")
    del m, ev, cols, index, counts
    torch.cuda.empty_cache()

    # (iii) edge cases, also held against the raw-bytes oracle
    specs, events = edge_block(rng)
    m, ev, cols, index, wids = packed_block(specs, events, dev)
    kept = specs[700:]
    updates = m.table.stats()["index_updates"]
    m.table.sync(kept, version=2)   # frees 700 slots (dirty-row publish)
    cols_kept = m.table.ranked_view()
    cols, index, wids = cols_kept[:4], cols_kept[4], cols_kept[5]
    if int((wids < 0).sum()) < 700:
        raise AssertionError("churn sync freed no slots")
    if m.table.stats()["index_updates"] != updates + 1:
        raise AssertionError("the churn sync did not update the rank index")
    check_index_rows(m.table, "(iii)")
    epad = ev[0].shape[0]
    n_ev = len(events)
    counts, idx = fanout.fanout_dispatch_plain(*ev, n_ev, *cols, 1 << 16)
    total = int(counts.sum())
    if epad <= n_ev or pairs_of(counts, idx, wids, epad) != oracle_pairs(
            events, kept):
        raise AssertionError("(iii): plain dispatch differs from match_oracle")
    for what, size in (("truncated", total // 3), ("exact", total),
                       ("above", 2 * total)):
        res = fanout_checks(dispatch_case(ev, n_ev, cols, size, index), 0)
        out[("fanout_dispatch", f"iii {what}")] = res
    case = mask_case(ev, n_ev, cols, index)
    res = fanout_checks(case, 0)
    res.update(oracle_pairs=check_oracle(case, events, kept, wids, epad, seed))
    out[("fanout_mask_range", "iii")] = res
    log(f"kernels fanout_dispatch, fanout_mask_range [(iii) edges: "
        f"{len(kept)} live of {len(wids)} slots after churn (rank index "
        f"updated), E={epad}, n_ev={n_ev}, {total} pairs; sizes {total // 3}, "
        f"{total}, {2 * total}]: bit-identical to the plain versions, which "
        f"equal match_oracle")
    long_key = b"/registry/pods/" + b"x" * 185
    events = events + [WatchEvent(revision=600, key=long_key)]
    m, ev, cols, index, wids = packed_block(kept, events, dev)
    c = cols[0].shape[1]
    if c != 64:
        raise AssertionError(f"a 200-byte key packed at C={c}, not 64")
    counts, idx = fanout.fanout_dispatch_plain(*ev, len(events), *cols, 1 << 16)
    if pairs_of(counts, idx, wids, ev[0].shape[0]) != oracle_pairs(events,
                                                                  kept):
        raise AssertionError("(iii) C=64: plain dispatch differs from "
                             "match_oracle")
    out[("fanout_dispatch", "iii C=64")] = fanout_checks(
        dispatch_case(ev, len(events), cols, int(counts.sum()), index), 0)
    out[("fanout_mask_range", "iii C=64")] = fanout_checks(
        mask_case(ev, len(events), cols, index), 0)
    log(f"kernels fanout_dispatch, fanout_mask_range [(iii) a 200-byte key, "
        f"C={c}]: bit-identical to the plain versions, which equal "
        f"match_oracle")
    # a pinned 16-byte width (C = 4), and a (ii)-long block
    specs, events = narrow_block(n_w, big_e, rng)
    m, ev, cols, index, wids = packed_block(specs, events, dev, width=16)
    c = cols[0].shape[1]
    counts, _ = fanout.fanout_dispatch_plain(*ev, big_e, *cols, 1)
    total = int(counts.sum())
    out[("fanout_dispatch", "iii C=4")] = fanout_checks(dispatch_case(
        ev, big_e, cols, fanout.pow2_at_least(total, 128), index), 0)
    out[("fanout_mask_range", "iii C=4")] = fanout_checks(
        mask_case(ev, big_e, cols, index), 0)
    log(f"kernels fanout_dispatch, fanout_mask_range [(iii) pinned width 16 "
        f"bytes, C={c}, W={cols[0].shape[0]}, E={big_e}, {total} pairs]: "
        f"bit-identical to the plain versions")

    # (v) W = 64: two blocks of slots, and a block of deep_e events (E past
    # 16,384 on the card: no ballot buffer, the event tiles loop)
    out.update(deep_case(dev, "v", 64, deep_e, rng, seed))
    # (vi) a capacity whose int32 flat index allows a block past 16,384
    # events (10,240 slots: 131,072), at half that depth
    out.update(deep_case(dev, "vi", n_w, max(deep_e // 2, 1), rng, seed))
    return out


def deep_case(dev, what: str, n_w: int, n_e: int, rng, seed: int) -> dict:
    """K4 and K5 on one block of ``n_e`` events against ``n_w`` watchers of
    the (i) shape: bit-identical to the plain versions and to
    ``match_oracle`` (a sample of the watchers)."""
    specs = fanout_population(n_w, max(n_w // 100, 1), rng)
    events = fanout_events(n_e, 1, rng)
    m, ev, cols, index, wids = packed_block(specs, events, dev)
    w, c = cols[0].shape
    epad = ev[0].shape[0]
    if epad > max_block_events(m.table.stats()["capacity"]):
        raise AssertionError(f"({what}): E={epad} past the flat index")
    counts, _ = fanout.fanout_dispatch_plain(*ev, n_e, *cols, 1)
    total = int(counts.sum())
    case = dispatch_case(ev, n_e, cols, fanout.pow2_at_least(total, 128),
                         index)
    res = fanout_checks(case, 0)
    res.update(oracle_pairs=check_oracle(case, events, specs, wids, epad,
                                         seed))
    mcase = mask_case(ev, n_e, cols, index)
    mres = fanout_checks(mcase, 0)
    log(f"kernels fanout_dispatch, fanout_mask_range [({what}) {n_w} "
        f"watchers, W={w}, E={epad}, n_ev={n_e}, C={c}, {total} pairs, "
        f"max_block_events {max_block_events(m.table.stats()['capacity'])}]: "
        f"bit-identical to the plain versions; {res['oracle_pairs']} pairs "
        f"equal to match_oracle")
    del m, ev, cols, index, case, mcase
    torch.cuda.empty_cache()
    return {("fanout_dispatch", what): res, ("fanout_mask_range", what): mres}


def narrow_block(n_watchers: int, n_events: int, rng):
    """(i)-shaped specs and events whose keys fit a 16-byte packed width:
    ``/p/nNN/oNNNN`` under 40 namespace prefixes, 2% single-key watches
    (NUL-bound end), 1% unbounded over ``/p/``, ``min_rev`` 0-255."""
    specs = []
    for w in range(n_watchers):
        ns = b"/p/n%02d/" % rng.randint(40)
        roll = rng.rand()
        if roll < 0.01:
            specs.append((w, b"/p/", b"", 0))
        elif roll < 0.03:
            key = ns + b"o%04d" % rng.randint(4096)
            specs.append((w, key, key + b"\x00", int(rng.randint(0, 256))))
        else:
            specs.append((w, ns, ns[:-1] + bytes([ns[-1] + 1]),
                          int(rng.randint(0, 256))))
    events = [WatchEvent(revision=1 + i, key=b"/p/n%02d/o%04d" % (
        rng.randint(40), rng.randint(4096)), value=b"v")
        for i in range(n_events)]
    return specs, events


def legacy_block(events, dev):
    """Events packed as the legacy matcher packs them: 128-byte keys, E
    padded to a power of two of at least 8."""
    epad = fanout.pow2_at_least(len(events), 8)
    keys = [e.key for e in events] + [b""] * (epad - len(events))
    revs = [e.revision for e in events] + [0] * (epad - len(events))
    ek, _ = keyops.pack_keys(keys, keyops.KEY_WIDTH)
    return (torch.from_numpy(flip_sign(ek)).to(dev),
            torch.from_numpy(fanout.revisions(revs)).to(dev))


class HubRecorder:
    """Metrics sink for the hub and the tracer: the commit → queue lag of
    every fan-out, the slow-consumer drops, and the seconds of each
    tracer stage."""

    def __init__(self):
        self.lag: list[float] = []
        self.dropped = 0
        self.stage_s: dict[str, float] = {}

    def emit_histogram(self, name, value, **tags):
        if name == "kb.watch.lag.seconds":
            self.lag.append(value)
        elif "stage" in tags:
            self.stage_s[tags["stage"]] = self.stage_s.get(tags["stage"],
                                                           0.0) + value

    def emit_counter(self, name, value=1, **tags):
        if name == "kb.watch.dropped":
            self.dropped += value

    def emit_gauge(self, *a, **k):
        pass

    def register_gauge_fn(self, *a, **k):
        pass

    def unregister_gauge_fn(self, *a, **k):
        pass


class NotifyingQueue(queue.Queue):
    """A subscriber queue (``queue.Queue``, bounded, so the hub's
    slow-consumer drop applies unchanged) that also posts itself on its
    consumer's ready list when an item is put: a consumer thread then
    drains only the queues that hold items, and holds the interpreter lock
    for time in proportion to the deliveries, not to the watchers."""

    def __init__(self, maxsize: int, ready: collections.deque):
        super().__init__(maxsize)
        self.ready = ready

    def _put(self, item):
        super()._put(item)
        self.ready.append(self)


def write_load(backend, thread: int, n_ops: int, seed: int) -> list:
    """One writer's creates, updates and deletes of kube-shaped keys in its
    own key space (object ids = thread mod 16, so writers never collide);
    returns the revisions it wrote."""
    rng = random.Random(seed * 1000 + thread)
    live: dict[bytes, int] = {}
    revs = []
    for _ in range(n_ops):
        roll = rng.random()
        if live and roll < 0.3:
            k = rng.choice(list(live))
            live[k] = backend.update(k, b"upd-%d" % rng.randrange(1 << 20),
                                     live[k])
            revs.append(live[k])
        elif live and roll < 0.45:
            k = rng.choice(list(live))
            revs.append(backend.delete(k, live.pop(k))[0])
        else:
            while True:
                k = b"/registry/%s/%s/obj-%05d" % (
                    rng.choice(FANOUT_KINDS), rng.choice(FANOUT_NAMESPACES),
                    16 * rng.randrange(256) + thread % 16)
                if k not in live:
                    break
            live[k] = backend.create(k, b"new-%d" % rng.randrange(1 << 20))
            revs.append(live[k])
    return revs


#: client-go's reflector re-establishes an informer's watch every 5 to 10
#: minutes (tools/cache/reflector.go: minWatchTimeout = 5 min, each watch
#: request's timeout minWatchTimeout x (1 + rand)): 450 s apart on average
REWATCH_MEAN_S = 450.0


def watch_drive(backend, n_watchers: int, n_broad: int, n_writes: int,
                n_writers: int, seed: int,
                rewatch_s: float = REWATCH_MEAN_S, writer=write_load,
                settle=None) -> dict:
    """(f) end to end: register watchers, drain them from consumer threads
    while writer threads write, and hold every watcher's events against
    ``match_oracle`` over the hub's full event stream.

    Watcher churn, while the writers write: re-establishments at the rate
    of ``n_watchers`` informers re-watching every ``rewatch_s`` seconds on
    average, each one the oldest of a cohort of a hundredth as
    many extra watchers unwatched and a new one registered from the next
    revision on a range of the same generator. A churned watcher's events
    must be the first of the oracle's from its start revision on (its
    unwatch may cut them short, never skip one). ``writer(backend, thread,
    n_ops, seed)`` writes one thread's share and returns the revisions of
    its acknowledged writes; ``settle()``, when given, runs after the
    writers and before the consumers stop, for writes that come later (the
    retry FIFO's rewrites)."""
    hub = backend.watcher_hub
    rng = np.random.RandomState(seed)
    churn_rng = np.random.RandomState(seed + 1)
    head = backend.current_revision()
    n_consumers = 4
    readies = [collections.deque() for _ in range(n_consumers)]
    got: dict[int, list[int]] = {}      # by id(queue)
    poisoned: set[int] = set()          # ids of queues that got None

    def watch(s, e, start_rev, i):
        ready = readies[i % n_consumers]

        def factory(maxsize):
            q = NotifyingQueue(maxsize, ready)
            got[id(q)] = []  # before the hub can put anything
            return q

        for attempt in range(50):
            try:
                return backend.watch_range(s, e, start_rev,
                                           queue_factory=factory)
            except StorageError:
                # an injected read fault (chaos): a client watches again
                if attempt == 49:
                    raise
                time.sleep(0.01)

    registered = []
    for i, (_w, s, e, r) in enumerate(fanout_population(n_watchers, n_broad,
                                                        rng)):
        # a fifth start a few hundred revisions ahead: min_rev filters
        registered.append(watch(s, e, head + 1 + 2 * r if i % 5 == 0 else 0,
                                i))
    with hub._lock:
        specs = [(wid, *hub._filters[wid]) for wid, _q in registered]

    churned: list[tuple] = []           # (wid, queue, start, end, from rev)
    cohort: collections.deque = collections.deque()

    def rewatch():
        _w, s, e, _r = fanout_population(1, 0, churn_rng)[0]
        rev = backend.current_revision() + 1
        wid, q = watch(s, e, rev, len(churned))
        churned.append((wid, q, s, e, rev))
        cohort.append(wid)

    for _ in range(max(n_watchers // 100, 1)):
        rewatch()
    table = getattr(hub._fanout_matcher, "table", None)
    table0 = dict(table.stats()) if table is not None else {}

    rec = HubRecorder()
    hub.set_metrics(rec)
    TRACER.configure(metrics=rec)
    streamed: list[list] = []
    stream_s = [0.0]
    orig_stream = hub.stream

    def recording(batch):
        # recorded once its events are in the queues: the consumers' last
        # sweep, after the last write is recorded, then finds all of them
        t = time.perf_counter()
        orig_stream(batch)
        stream_s[0] += time.perf_counter() - t
        streamed.append(list(batch))

    hub.stream = recording
    done = threading.Event()
    writing = threading.Event()

    def consume(ready):
        # each queue posts to one consumer only, so its items are taken in
        # order by one thread
        while True:
            try:
                q = ready.popleft()
            except IndexError:
                # every put happened before done was set: a ready list read
                # empty after seeing done stays empty
                if done.is_set() and not ready:
                    return
                time.sleep(0.002)
                continue
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    poisoned.add(id(q))
                elif not isinstance(item, ProgressMarker):
                    got[id(q)].extend(e.revision for e in item)

    def churn():
        period = rewatch_s / n_watchers
        t = time.perf_counter()
        while not writing.wait(max(0.0, t + period - time.perf_counter())):
            t += period
            backend.unwatch(cohort.popleft())
            rewatch()

    consumers = [threading.Thread(target=consume, args=(ready,))
                 for ready in readies]
    churner = threading.Thread(target=churn)
    for t in consumers + [churner]:
        t.start()
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(n_writers) as pool:
            futs = [pool.submit(writer, backend, t, n_writes // n_writers,
                                seed) for t in range(n_writers)]
            written = sorted(r for f in futs for r in f.result())
        writing.set()
        churner.join(timeout=60)
        if settle is not None:
            settle()
        deadline = time.monotonic() + 60
        # every dealt revision through the ring into the hub: the last
        # write's event and any later one (a retry's rewrite) streamed
        while (not streamed or streamed[-1][-1].revision < written[-1]
               or backend.flushed_revision() < backend.current_revision()):
            if time.monotonic() > deadline:
                raise AssertionError("the hub never streamed the last write")
            time.sleep(0.01)
        wall = time.perf_counter() - t0
    finally:
        writing.set()
        done.set()
        for t in consumers:
            t.join(timeout=60)
        del hub.stream
        hub.set_metrics(None)
        TRACER.metrics = None
    if any(t.is_alive() for t in consumers + [churner]):
        raise AssertionError("a consumer or churn thread did not stop")

    events = [e for b in streamed for e in b]
    revs = np.array([e.revision for e in events], dtype=np.int64)
    if (np.diff(revs) <= 0).any():
        raise AssertionError("the hub streamed events out of revision order")
    if set(written) - set(revs.tolist()):
        raise AssertionError("a write never reached the hub")
    dropped = [wid for wid, q in registered if id(q) in poisoned]
    if dropped or rec.dropped or hub.watcher_count() < len(registered):
        raise AssertionError(f"watchers dropped: {len(dropped)} poisoned, "
                             f"{rec.dropped} counted")
    t1 = time.perf_counter()
    ranges = sorted({(s, e) for _w, s, e, _r in specs}
                    | {(s, e) for _w, _q, s, e, _r in churned})
    col = {r: j for j, r in enumerate(ranges)}
    mask = match_oracle(events, [(j, s, e, 0) for j, (s, e) in
                                 enumerate(ranges)])
    delivered = 0
    for (wid, s, e, min_rev), (_wid, q) in zip(specs, registered):
        want = revs[mask[:, col[(s, e)]] & (revs >= min_rev)]
        if got[id(q)] != want.tolist():
            raise AssertionError(f"watcher {wid} [{s!r}, {e!r}) min_rev "
                                 f"{min_rev}: {len(got[id(q)])} events, the "
                                 f"oracle {len(want)}")
        delivered += len(want)
    churn_delivered = 0
    for wid, q, s, e, rev in churned:
        have = got[id(q)]
        want = revs[mask[:, col[(s, e)]] & (revs >= rev)][:len(have)]
        if have != want.tolist():
            raise AssertionError(f"churned watcher {wid} [{s!r}, {e!r}) from "
                                 f"{rev}: {len(have)} events, not the "
                                 f"oracle's first")
        churn_delivered += len(have)
    for wid, _q in registered:
        backend.unwatch(wid)
    for wid in cohort:
        backend.unwatch(wid)
    sizes = np.array([len(b) for b in streamed])
    table1 = table.stats() if table is not None else {}
    index = {k: table1.get(k, 0) - table0.get(k, 0)
             for k in ("index_builds", "index_updates", "index_s")}
    return {"biggest": max(streamed, key=len), "watchers": len(specs),
            "writes": len(written), "events": len(events),
            "delivered": delivered, "wall_s": wall,
            "oracle_s": time.perf_counter() - t1, "blocks": len(streamed),
            "stream_s": stream_s[0],
            "rewatches": len(churned) - max(n_watchers // 100, 1),
            "churn_delivered": churn_delivered, "index": index,
            "index_ms_per_block": index["index_s"] * 1e3 / len(streamed),
            "block_sizes": np.percentile(sizes, [0, 50, 90, 99, 100]).tolist(),
            "lag_p50_ms": statistics.median(rec.lag) * 1e3 if rec.lag else None,
            "stage_s": dict(rec.stage_s)}


def watch_phase(backend, dev, n_watchers: int, n_writes: int,
                n_writers: int, n_broad: int, seed: int) -> dict:
    """(f) end to end through the main Backend's DeviceFanout (K4), then
    through a second Backend whose hub holds the legacy matcher (K5)."""
    matcher = backend.watcher_hub._fanout_matcher
    if not isinstance(matcher, DeviceFanout) or not backend._hub_blocks:
        raise AssertionError("the Backend's hub has no block matcher")
    fanout_kernels.reset_launch_counts()
    for k in matcher.stats:
        matcher.stats[k] = 0
    res = watch_drive(backend, n_watchers, n_broad, n_writes, n_writers, seed)
    launches = {"fanout_dispatch": fanout_kernels.fanout_dispatch.launches}
    res["matcher"] = dict(matcher.stats)
    log(f"watch [DeviceFanout]: {res['watchers']} watchers, {res['writes']} "
        f"writes, {res['events']} events in {res['blocks']} blocks (events "
        f"per block min/p50/p90/p99/max {res['block_sizes']}), "
        f"{res['delivered']} deliveries in {res['wall_s']:.3f} s = "
        f"{res['delivered'] / res['wall_s']:.0f} events/s delivered, every "
        f"watcher equal to match_oracle (checked in {res['oracle_s']:.1f} s), "
        f"none dropped; matcher {res['matcher']}; K4 launches "
        f"{launches['fanout_dispatch']}; WatcherHub.stream {res['stream_s']:.3f} "
        f"s in all, of which stage seconds {res['stage_s']}; host lag p50 "
        f"(commit to queue) {res['lag_p50_ms']} ms; {res['rewatches']} "
        f"re-watches (one per {REWATCH_MEAN_S} s per watcher), churned "
        f"watchers' "
        f"{res['churn_delivered']} deliveries equal to the oracle's first; "
        f"rank index {res['index']} = {res['index_ms_per_block']} ms per "
        f"block")
    if min(res["matcher"]["blocks"], res["matcher"]["dispatches"],
           launches["fanout_dispatch"]) <= 0:
        raise AssertionError(f"the watch path never reached K4: "
                             f"{res['matcher']}, {launches}")
    # K4 against the plain version on the main path's largest block, packed
    # as the matcher packed it, against the table it matched
    block = res.pop("biggest")
    ev = matcher._pack_events(block)[:2]
    view = matcher.table.ranked_view()
    cols, index = view[:4], view[4]
    w, c = cols[0].shape
    cases = {"fanout_dispatch": fanout_checks(
        dispatch_case(ev, len(block), cols, matcher._idx_size, index), 50)}
    log(describe_fanout(f"fanout_dispatch [main path's largest block, W={w}, "
                        f"E={ev[0].shape[0]}, n_ev={len(block)}, C={c}, size "
                        f"{matcher._idx_size}]", cases["fanout_dispatch"]))

    store = new_storage("memkv")
    legacy = Backend(store, BackendConfig(
        fanout_matcher=fanout.FanoutMatcher(device=dev)))
    try:
        fanout_kernels.reset_launch_counts()
        small = watch_drive(legacy, max(n_watchers // 10, 400),
                            max(n_broad, 70), max(n_writes // 10, 200),
                            max(n_writers // 2, 2), seed + 1)
        launches["fanout_mask_range"] = fanout_kernels.fanout_mask_range.launches
        block = small.pop("biggest")
        lmatcher = legacy.watcher_hub._fanout_matcher
        lev = legacy_block(block, dev)
        cases["fanout_mask_range"] = fanout_checks(
            mask_case(lev, len(block), lmatcher._cached, lmatcher._index), 20)
        lcols = lmatcher._cached
        w, c = lcols[0].shape
        log(describe_fanout(f"fanout_mask_range [legacy path's largest "
                            f"block, W={w}, E={lev[0].shape[0]}, n_ev="
                            f"{len(block)}, C={c}]",
                            cases["fanout_mask_range"]))
    finally:
        legacy.close()
        store.close()
    log(f"watch [FanoutMatcher]: {small['watchers']} watchers, "
        f"{small['writes']} writes in {small['blocks']} blocks, "
        f"{small['delivered']} deliveries, every watcher equal to "
        f"match_oracle, none dropped; K5 launches "
        f"{launches['fanout_mask_range']}")
    if launches["fanout_mask_range"] <= 0:
        raise AssertionError("the legacy watch path never reached K5")
    res.update(launches=launches, cases=cases)
    return res


def routing_crossover(dev, n_watchers: int, seed: int) -> list:
    """One block at ``n_watchers`` watchers of the (i) shape without the
    broad cohort, so the hub's interval index serves it, for E in {1, 8,
    64, 512}, host clock, median of 9: ``WatcherHub.stream`` of a hub
    without a matcher (the index route), and what the hub's K4 route does
    in its place (the spec tuples, ``DeviceFanout.deliver`` and the queue
    puts; the map copies before them are the same on both routes), with
    ``deliver`` alone beside it."""
    rng = np.random.RandomState(seed)
    specs = fanout_population(n_watchers, 0, rng)
    matcher = DeviceFanout(device=dev)
    hub = WatcherHub()
    queues = {}
    for _w, s, e, r in specs:
        wid, q = hub.add_watcher(s, e, r)
        queues[wid] = q
    with hub._lock:
        version = hub._version
        filters = dict(hub._filters)

    def via_k4(batch):
        live = [(wid, *filters[wid]) for wid in queues]
        for wid, evs in matcher.deliver(batch, live, version=version).items():
            queues[wid].put_nowait(evs)

    def median_ms(fn, batch) -> float:
        ts = []
        for _ in range(10):
            t = time.perf_counter()
            fn(batch)
            ts.append(time.perf_counter() - t)
        for q in queues.values():
            while not q.empty():
                q.get_nowait()
        return statistics.median(ts[1:]) * 1e3

    live = [(wid, *filters[wid]) for wid in queues]
    rows = []
    try:
        for n_e in (1, 8, 64, 512):
            batch = fanout_events(n_e, 1000, rng)
            row = {"events": n_e, "index": median_ms(hub.stream, batch),
                   "K4": median_ms(via_k4, batch),
                   "deliver": median_ms(lambda b: matcher.deliver(
                       b, live, version=version), batch)}
            rows.append(row)
            log(f"routing crossover [{n_watchers} watchers, E={n_e}]: K4 "
                f"route {row['K4']:.3f} ms (DeviceFanout.deliver alone "
                f"{row['deliver']:.3f} ms), interval index {row['index']:.3f} "
                f"ms per block (host clock, median of 9)")
    finally:
        hub.close()
    if matcher.stats["blocks"] <= 0:
        raise AssertionError("the crossover's K4 route never reached K4")
    return rows


def fanout_phase(backend, dev, args) -> dict:
    """(f): the kernel cases, the watch path end to end, the crossover."""
    cases = fanout_kernel_phase(dev, args.watchers, args.block_events,
                                args.big_watchers, args.big_events, args.seed,
                                args.deep_events)
    watch = watch_phase(backend, dev, args.watchers, args.writes,
                        args.writers, args.watchers // 100, args.seed)
    crossover = routing_crossover(dev, args.watchers, args.seed)
    return {"cases": cases, "watch": watch, "crossover": crossover}


# ------------------------------------------------------------ phases g, h
ROOT = Path(__file__).resolve().parent
NATIVE_DIR = ROOT / "native"
KBSTORED = NATIVE_DIR / "kvrpc" / "kbstored"
#: what phase (g) builds: the engine's library and the storage daemon, not
#: the HTTP/2 front, which links nghttp2 and OpenSSL
NATIVE_TARGETS = ("libkbstore.so", "kvrpc/kbstored")
#: the CLI's defaults for the deployed engines (kubebrain_tpu/cli.py):
#: ``--native-partitions`` 4 (line 74) and ``--storage-pool`` 8 (line 41)
NATIVE_PARTITIONS = 4
REMOTE_POOL = 8
#: the checked columns of a mirror
MIRROR_HOST_COLUMNS = ("keys_host", "lens_host", "revs_host", "tomb_host",
                       "ttl_host", "n_valid")
MIRROR_DEVICE_COLUMNS = ("keys_dev", "revs_dev", "tomb_dev", "ttl_dev",
                         "n_valid_dev")


class NativeBuild:
    """``make -C native`` of :data:`NATIVE_TARGETS`, started at once;
    :meth:`wait` fails the run when make fails or a target is missing, and
    returns the seconds."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            ["make", "-j2", "-C", str(NATIVE_DIR), *NATIVE_TARGETS],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def wait(self) -> float:
        _out, err = self.proc.communicate()
        if self.proc.returncode != 0:
            raise AssertionError(f"make -C native failed:\n{err[-4000:]}")
        for target in NATIVE_TARGETS:
            if not (NATIVE_DIR / target).exists():
                raise AssertionError(f"make -C native built no {target}")
        return time.perf_counter() - self.t0


def data_dir(name: str) -> Path:
    """A fresh directory for ``name`` under the checkout's ``build/``."""
    d = ROOT / "build" / "smoke" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


class Kbstored:
    """A ``kbstored <port> [dir]`` process on a free port of localhost."""

    def __init__(self, directory: Path | None = None):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        args = [str(KBSTORED), str(self.port)]
        if directory is not None:
            args.append(str(directory))
        self.proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)
        if b"READY" not in self.proc.stdout.readline():
            self.close()
            raise AssertionError(f"kbstored did not start: {args}")
        self.address = f"127.0.0.1:{self.port}"

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def mirror_differences(a, b) -> list[str]:
    """The columns in which two mirrors differ (host, device, the value
    arenas, the snapshot)."""
    diff = [c for c in MIRROR_HOST_COLUMNS
            if not np.array_equal(getattr(a, c), getattr(b, c))]
    diff += [c for c in MIRROR_DEVICE_COLUMNS
             if not torch.equal(getattr(a, c), getattr(b, c))]
    if len(a.val_arena) != len(b.val_arena) or not all(
            np.array_equal(x, y) and np.array_equal(xo, yo)
            for x, y, xo, yo in zip(a.val_arena, b.val_arena, a.val_offsets,
                                    b.val_offsets)):
        diff.append("values")
    if (a.snapshot_ts, a.max_rev, a.encoding is None) != (
            b.snapshot_ts, b.max_rev, b.encoding is None):
        diff.append("snapshot")
    return diff


class _WithoutExport:
    """An engine with its bulk export hidden, so a mirror build takes the
    per-row path."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "export_mvcc":
            raise AttributeError(name)
        return getattr(self._inner, name)


def boot(store, what: str, config: BackendConfig | None = None) -> tuple:
    """A Backend over ``store`` and the mirror's first publish, which must
    take the engine's bulk export. Returns (backend, boot seconds)."""
    t0 = time.perf_counter()
    backend = Backend(store, config or BackendConfig())
    backend.scanner.publish()
    seconds = time.perf_counter() - t0
    builds = dict(backend.scanner.mirror_builds)
    m = backend.scanner._mirror
    log(f"{what}: Backend up and mirror published in {seconds:.3f} s: "
        f"{m.rows} rows in {m.partitions} partition(s), encoded="
        f"{m.encoding is not None}; builds by path {builds}")
    if builds != {"export": 1, "rows": 0}:
        backend.close()
        raise AssertionError(f"{what}: the mirror was not built by the "
                             f"engine's bulk export: {builds}")
    return backend, seconds


def per_row_build(store, scanner, what: str) -> float:
    """One mirror build from the same store on the per-row path, held
    column for column against the published (exported) mirror; returns
    its seconds."""
    inner = store._inner.exclusive_client()
    t0 = time.perf_counter()
    lo, hi = coder.internal_range(b"", b"")
    inner.export_mvcc(lo, hi, scanner._mirror.snapshot_ts, scanner._kw,
                      coder.MAGIC, TOMBSTONE)
    export_s = time.perf_counter() - t0
    store.untracked = lambda: _WithoutExport(inner)
    try:
        t0 = time.perf_counter()
        m = scanner._build_mirror_from_store()
        seconds = time.perf_counter() - t0
    finally:
        del store.untracked
    if scanner.mirror_builds["rows"] != 1:
        raise AssertionError(f"{what}: the per-row build took another path")
    diff = mirror_differences(m, scanner._mirror)
    if diff:
        raise AssertionError(f"{what}: the per-row mirror differs from the "
                             f"exported one in {diff}")
    log(f"{what}: a per-row build of the same store took {seconds:.3f} s and "
        f"equals the exported mirror column for column; the export call "
        f"alone {export_s:.3f} s")
    return seconds


RESTART_RANGES = (NS, PODS, (b"/events/", b"/events0"),
                  (b"/registry/pods/ns07/pending-",
                   b"/registry/pods/ns07/pending."))


def response_set(backend, revs) -> list:
    """Every Range, Count and ``list_batch`` answer of the restart check at
    the revisions ``revs``, as comparable tuples."""
    out = []
    for rev in revs:
        for s, e in RESTART_RANGES:
            res = backend.list_(s, e, revision=rev)
            out.append((s, e, rev, [(kv.key, kv.value, kv.revision)
                                    for kv in res.kvs],
                        backend.count(s, e, revision=rev)[0]))
    batch = [("list", s, e, rev, 0) for s, e in RESTART_RANGES
             for rev in revs] + [("count", *PODS, rev) for rev in revs]
    for q, res in zip(batch, backend.list_batch(batch)):
        if isinstance(res, BaseException):
            raise res
        out.append((q, res[0] if q[0] == "count" else
                    [(kv.key, kv.value, kv.revision) for kv in res.kvs]))
    return out


def deployed_phase(store, what: str, rows, top: int, n_keys: int, dev,
                   twin_factory) -> dict:
    """(g1)/(g2) up to the restart: load, boot by export, a per-row build
    beside it, the request set against the host scanner, and compaction
    against the host scanner's on a twin of the same engine kind. Returns
    the backend (open) and the numbers."""
    load_s = load_rows(store.untracked(), rows, top)
    log(f"{what}: {n_keys} user keys, {len(rows)} store rows loaded through "
        f"the untracked {type(store._inner).__name__} in {load_s:.1f} s = "
        f"{len(rows) / load_s:.0f} rows/s")
    backend, boot_s = boot(store, what)
    try:
        rows_s = per_row_build(store, backend.scanner, what)
        oracle = Scanner(store.untracked(), get_compact_revision=lambda _s: 0)
        try:
            served = serve_requests(backend, oracle, top, what)
        finally:
            oracle.close()
        compacted = compact_phase(backend, store, top, n_keys, dev,
                                  twin_factory=twin_factory, what=what,
                                  measure_reps=0)
    except BaseException:
        backend.close()
        raise
    return {"backend": backend, "load_s": load_s, "boot_s": boot_s,
            "per_row_build_s": rows_s, "served": served,
            "compacted": compacted}


def summary(res: dict) -> dict:
    """The numbers of a (g) run worth keeping, as one JSON-able dict."""
    lat = res["served"]["lat"]
    c = res["compacted"]
    return {"load_s": res["load_s"], "boot_s": res["boot_s"],
            "per_row_build_s": res["per_row_build_s"],
            "p50_ms": {k: statistics.median(v) * 1e3 for k, v in lat.items()},
            "launches": {**res["served"]["launches"],
                         "victim_mask": c["launches"]},
            "compact_s": c["wall_s"], "host_compact_s": c["host_wall_s"],
            "compact_phase_s": c["phase_seconds"],
            **{k: v for k, v in res.items() if k.startswith("restart")}}


def native_phase(rows, top: int, n_keys: int, dev) -> dict:
    """(g1): ``cuda`` over ``native`` in the README's single-node shape, on
    a data dir with fsync off, then a restart on the same dir."""
    d = data_dir("native")
    open_store = lambda: new_storage(
        "cuda", inner="native", device=dev, data_dir=str(d), fsync=False,
        inner_partitions=NATIVE_PARTITIONS)
    store = open_store()
    try:
        res = deployed_phase(
            store, "native", rows, top, n_keys, dev,
            lambda: new_storage("native", partitions=NATIVE_PARTITIONS))
        backend = res.pop("backend")
        try:
            revs = (0, top)
            before = response_set(backend, revs)
            head = backend.current_revision()
        finally:
            backend.close()
    finally:
        store.close()
    t0 = time.perf_counter()
    store = open_store()
    reopen_s = time.perf_counter() - t0
    try:
        backend, boot_s = boot(store, "native restart")
        try:
            if backend.current_revision() != head:
                raise AssertionError("native restart: revision "
                                     f"{backend.current_revision()}, not "
                                     f"{head}")
            after = response_set(backend, (head, top))
        finally:
            backend.close()
    finally:
        store.close()
        shutil.rmtree(d, ignore_errors=True)
    if after != [_at(r, head) for r in before]:
        raise AssertionError("native restart: a response differs from the "
                             "one before the restart")
    log(f"native restart: engine reopened (WAL and snapshot) in "
        f"{reopen_s:.3f} s, Backend and mirror by export in {boot_s:.3f} s; "
        f"all {len(after)} responses at revisions {head} and {top} equal "
        f"those before the restart")
    res.update(restart_reopen_s=reopen_s, restart_boot_s=boot_s)
    return summary(res)


def _at(resp: tuple, head: int) -> tuple:
    """A response taken at revision 0 (the head) named by the head."""
    if len(resp) == 2:
        q, ans = resp
        return ((*q[:3], q[3] or head, *q[4:]), ans)
    s, e, rev, kvs, count = resp
    return (s, e, rev or head, kvs, count)


def remote_phase(rows, top: int, n_keys: int, dev) -> dict:
    """(g2): ``cuda`` over ``remote``, a ``kbstored`` on a data dir, the
    compaction's twin on a second, in-memory ``kbstored``."""
    d = data_dir("kbstored")
    daemon = Kbstored(d)
    twin_daemon = Kbstored()
    twins = []

    def twin_factory():
        twins.append(new_storage("remote", address=twin_daemon.address,
                                 pool=REMOTE_POOL))
        return twins[-1]

    try:
        store = new_storage("cuda", inner="remote", device=dev,
                            address=daemon.address, pool=REMOTE_POOL)
        try:
            res = deployed_phase(store, "remote", rows, top, n_keys, dev,
                                 twin_factory)
            res.pop("backend").close()
        finally:
            store.close()
    finally:
        daemon.close()
        twin_daemon.close()
        shutil.rmtree(d, ignore_errors=True)
    return summary(res)


def deployed_phases(args, dev) -> dict:
    """(g): (g1) and (g2) on the kube dataset of (c), ``--remote-keys``
    deep for (g2); the native targets were built with the kernels."""
    t0 = time.perf_counter()
    rows, top = kube_dataset(args.keys, args.seed)
    log(f"kube dataset regenerated in {time.perf_counter() - t0:.1f} s")
    out = {"native": native_phase(rows, top, args.keys, dev)}
    if args.remote_keys != args.keys:
        del rows
        rows, top = kube_dataset(args.remote_keys, args.seed)
    out["remote"] = remote_phase(rows, top, args.remote_keys, dev)
    for name, res in out.items():
        log(f"(g) {name}: {json.dumps(res)}")
    return out


class ChaosLedger:
    """What the chaos writers were told, per key: the acknowledged state
    (value and revision; None once deleted), the values of writes that
    failed definitely, and, for a key an uncertain write left unknown, the
    values it may hold (None: absent)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.acked: dict[bytes, tuple | None] = {}
        self.failed: dict[bytes, set] = {}
        self.uncertain: dict[bytes, set] = {}
        self.counts: collections.Counter = collections.Counter()


def chaos_writer(ledger: ChaosLedger, deadline: float):
    """A :func:`watch_drive` writer that writes until ``deadline``
    (monotonic clock) and keeps going through injected faults: creates,
    updates and deletes in its own key space, each outcome recorded in
    ``ledger``; a key an uncertain write touched is left alone after."""

    def write(backend, thread: int, n_ops: int, seed: int) -> list:
        rng = random.Random(seed * 1000 + thread + 17)
        live: dict[bytes, int] = {}
        lost: set[bytes] = set()
        revs = []
        seq = 0
        while time.monotonic() < deadline and len(revs) < n_ops:
            seq += 1
            value = b"chaos-%d-%d" % (thread, seq)
            roll = rng.random()
            if live and roll < 0.3:
                kind, k = "update", rng.choice(list(live))
            elif live and roll < 0.45:
                kind, k = "delete", rng.choice(list(live))
            else:
                kind = "create"
                while True:
                    k = b"/registry/%s/%s/obj-%05d" % (
                        rng.choice(FANOUT_KINDS), rng.choice(FANOUT_NAMESPACES),
                        16 * rng.randrange(256) + thread % 16)
                    if k not in live and k not in lost:
                        break
            with ledger.lock:
                prev = ledger.acked.get(k)
            try:
                if kind == "create":
                    rev = live[k] = backend.create(k, value)
                    state = (value, rev)
                elif kind == "update":
                    rev = live[k] = backend.update(k, value, live[k])
                    state = (value, rev)
                else:
                    rev = backend.delete(k, live.pop(k))[0]
                    state = None
            except UncertainResultError:
                live.pop(k, None)
                lost.add(k)
                with ledger.lock:
                    ledger.uncertain[k] = {prev[0] if prev else None,
                                           None if kind == "delete" else value}
                    ledger.counts["uncertain"] += 1
                continue
            except StorageError:
                if kind == "delete":
                    live[k] = prev[1]
                with ledger.lock:
                    ledger.failed.setdefault(k, set()).add(value)
                    ledger.counts["failed"] += 1
                continue
            revs.append(rev)
            with ledger.lock:
                ledger.acked[k] = state
                ledger.counts["acked"] += 1
        return revs

    return write


def check_ledger(backend, ledger: ChaosLedger) -> dict:
    """Every acknowledged write reads back, no definitely failed write is
    present, and every key an uncertain write touched holds one of the
    values it may."""
    def current(k):
        try:
            kv = backend.get(k)
            return kv.value, kv.revision
        except KeyNotFoundError:
            return None

    lost = 0
    for k, state in ledger.acked.items():
        if k not in ledger.uncertain and current(k) != state:
            lost += 1
    if lost:
        raise AssertionError(f"chaos: {lost} acknowledged writes do not read "
                             f"back")
    present = [k for k, vals in ledger.failed.items()
               if (current(k) or (None,))[0] in vals]
    if present:
        raise AssertionError(f"chaos: {len(present)} definitely failed "
                             f"writes are present")
    wrong = [k for k, vals in ledger.uncertain.items()
             if (current(k) or (None,))[0] not in vals]
    if wrong:
        raise AssertionError(f"chaos: {len(wrong)} keys of uncertain writes "
                             f"hold a value no write gave them")
    return dict(ledger.counts)


def head_batch(top: int) -> list:
    """:func:`request_batch` with every query at the head revision (the
    chaos phase compacts past the others)."""
    return [(*q[:3], 0, *q[4:]) for q in request_batch(top)]


def chaos_reads(backend, stop: threading.Event, top: int, counts) -> None:
    """Range, Count and ``list_batch`` between the writers' writes until
    ``stop``; a read failed by an injected fault is counted, not raised."""
    batch = head_batch(top)
    while not stop.is_set():
        for fn in (lambda: backend.list_(*NS), lambda: backend.count(*PODS),
                   lambda: backend.list_batch(batch)):
            try:
                res = fn()
                if isinstance(res, list):
                    for r in res:
                        if isinstance(r, StorageError):
                            counts["read_errors"] += 1
                        elif isinstance(r, BaseException):
                            raise r
                counts["reads"] += 1
            except StorageError:
                counts["read_errors"] += 1


def wait_serving(scanner, what: str, timeout: float = 120.0) -> float:
    """Poll until the mirror serves again (a degraded read kicks the
    rebuild); returns the seconds waited."""
    t0 = time.monotonic()
    while True:
        with scanner._mlock:
            serving = (scanner._mirror_state == "serving"
                       and not scanner._force_rebuild)
        if serving:
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: the mirror never left quarantine "
                                 f"({scanner._mirror_state})")
        scanner._degraded()
        time.sleep(0.05)


def resolve_retries(backend, what: str, timeout: float = 60.0) -> int:
    """Drain the retry FIFO by read-back; returns how many it held."""
    held = len(backend.retry)
    deadline = time.monotonic() + timeout
    while len(backend.retry):
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: {len(backend.retry)} uncertain "
                                 f"writes never resolved")
        backend.retry.process_ready(now=time.monotonic() + 3600.0)
        time.sleep(0.01)
    return held


def chaos_run(preset: str, args, dev) -> dict:
    """(h) for one preset: ``cuda`` over native with the inner engine
    wrapped by ``FaultyStorage`` through ``inner_wrap``, the plane armed
    over a watch drive with readers and one compaction; then, after the
    horizon, the ledger, the retry FIFO, the mirror's recovery, every
    response against the host scanner and K1-K3 launching again."""
    what = f"chaos [{preset}]"
    plane = FaultPlane(generate(preset, args.seed, args.chaos_horizon))
    d = data_dir(f"chaos-{preset}")
    store = new_storage("cuda", inner="native", device=dev, data_dir=str(d),
                        fsync=False, inner_partitions=NATIVE_PARTITIONS,
                        merge_threshold=args.chaos_merge_threshold,
                        inner_wrap=lambda s: FaultyStorage(s, plane))
    backend = None
    try:
        rows, top = kube_dataset(args.chaos_keys, args.seed)
        load_rows(store.untracked(), rows, top)
        del rows
        backend, _boot = boot(store, what, BackendConfig(
            fanout_matcher=DeviceFanout(device=dev)))
        scanner = backend.scanner
        scanner.set_fault_plane(plane)
        plane.bind_hub(backend.watcher_hub)
        ledger = ChaosLedger()
        reads: collections.Counter = collections.Counter()
        stop = threading.Event()
        reader = threading.Thread(target=chaos_reads,
                                  args=(backend, stop, top, reads))
        compactions: list = []

        def compact_midway():
            # one client compaction inside the horizon (the merge preset's
            # compaction-failure window covers most of it)
            time.sleep(args.chaos_horizon / 2)
            try:
                compactions.append(backend.compact(
                    backend.current_revision() - 50))
            except StorageError as e:
                compactions.append(e)

        compactor = threading.Thread(target=compact_midway)
        settled = {}

        def settle():
            # past the horizon, readers and the compaction stopped, the
            # retry FIFO drained: its rewrites reach the watchers too
            time.sleep(max(0.0, deadline - time.monotonic()))
            stop.set()
            reader.join(timeout=120)
            compactor.join(timeout=300)
            settled["horizon_s"] = time.monotonic() - t0
            settled["held"] = resolve_retries(backend, what)

        plane.arm()
        t0 = time.monotonic()
        deadline = t0 + args.chaos_horizon
        reader.start()
        compactor.start()
        try:
            drive = watch_drive(backend, args.chaos_watchers, 70,
                                10 ** 9, args.writers, args.seed,
                                writer=chaos_writer(ledger, deadline),
                                settle=settle)
        finally:
            stop.set()
            reader.join(timeout=120)
            compactor.join(timeout=300)
        if reader.is_alive() or compactor.is_alive():
            raise AssertionError(f"{what}: a reader or the compaction did "
                                 f"not stop")
        horizon_s, held = settled["horizon_s"], settled["held"]
        recover_s = wait_serving(scanner, what)
        outcomes = check_ledger(backend, ledger)
        injected = plane.snapshot()
        log(f"{what}: horizon {horizon_s:.1f} s, injected {injected}; "
            f"writes {outcomes}; reads {dict(reads)}; compaction midway "
            f"{compactions}; quarantines {scanner._poison_epoch}, degraded "
            f"{scanner.degraded_seconds_total:.3f} s, full rebuilds "
            f"{scanner.full_rebuild_total}, background rebuilds "
            f"{scanner.rebuild_bg_count}, merge errors "
            f"{scanner.merge_bg_errors}, compaction errors "
            f"{scanner.compact_errors}; {held} uncertain writes resolved "
            f"through the retry FIFO; serving again {recover_s:.3f} s after "
            f"the drive; every acknowledged write reads back, no definitely "
            f"failed write is present; watch drive: {drive['watchers']} "
            f"watchers, {drive['events']} events, {drive['delivered']} "
            f"deliveries, every watcher equal to match_oracle, none dropped")
        if not injected or not outcomes.get("acked"):
            raise AssertionError(f"{what}: nothing was injected or "
                                 f"acknowledged")
        if preset == "storage" and scanner._poison_epoch <= 0:
            raise AssertionError(f"{what}: no uncertain write quarantined "
                                 f"the mirror")
        # after recovery: the request set against the host scanner, then a
        # compaction, with K1-K3 launching
        scan_kernels.reset_launch_counts()
        compact_kernels.reset_launch_counts()
        oracle = Scanner(store.untracked(), get_compact_revision=lambda _s: 0)
        try:
            head = backend.current_revision()
            for s, e in RESTART_RANGES + (
                    (b"/registry/", b"/registry0"),):
                same_kvs(backend.list_(s, e).kvs, oracle.range_(s, e, head)[0],
                         f"{what}: range {s!r}")
                if backend.count(s, e)[0] != oracle.count(s, e, head):
                    raise AssertionError(f"{what}: count {s!r} differs")
            batch = head_batch(top)
            check_batch(batch, backend.list_batch(batch), oracle, head)
            done = backend.compact(head)
            same_kvs(backend.list_(b"/registry/", b"/registry0").kvs,
                     oracle.range_(b"/registry/", b"/registry0",
                                   backend.current_revision())[0],
                     f"{what}: post-compaction range")
        finally:
            oracle.close()
        launches = {"scan_mask": scan_kernels.visibility_mask_batch.launches,
                    "scan_mask_q": scan_kernels.visibility_mask_batch_q.launches,
                    "victim_mask": compact_kernels.victim_mask_batch.launches}
        log(f"{what}: after recovery every response equals the host scanner, "
            f"compacted to {done}; launches {launches}")
        if min(launches.values()) <= 0 or scanner._mirror_state != "serving":
            raise AssertionError(f"{what}: after recovery a kernel did not "
                                 f"launch or the mirror is not serving: "
                                 f"{launches}, {scanner._mirror_state}")
        return {"injected": injected, "writes": outcomes, "reads": dict(reads),
                "quarantines": scanner._poison_epoch,
                "degraded_s": scanner.degraded_seconds_total,
                "full_rebuilds": scanner.full_rebuild_total,
                "background_rebuilds": scanner.rebuild_bg_count,
                "retry_resolved": held, "recover_s": recover_s,
                "launches_after": launches}
    finally:
        plane.close()
        if backend is not None:
            backend.close()
        store.close()
        shutil.rmtree(d, ignore_errors=True)


def chaos_phase(args, dev) -> dict:
    """(h): the chaos run under the ``storage`` preset, then ``merge``."""
    fanout_kernels.reset_launch_counts()
    out = {}
    for preset in ("storage", "merge"):
        out[preset] = chaos_run(preset, args, dev)
    out["fanout_dispatch"] = fanout_kernels.fanout_dispatch.launches
    if out["fanout_dispatch"] <= 0:
        raise AssertionError("chaos: the watch drive never reached K4")
    log(f"(h): {json.dumps(out)}")
    return out


AB_CHILD = """
import importlib.util, json, sys
tree, script = sys.argv[1:3]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke_ab", script)
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps(smoke.ab_drive(*(int(a) for a in sys.argv[3:]))))
"""


def ab_drive(watchers: int, writes: int, writers: int, seed: int) -> dict:
    """One watch drive (:func:`watch_drive`) on an empty store through the
    ``kubebrain_tpu_torch`` that is first on the path, on the card."""
    _build.build_all()
    store = new_storage("cuda", inner="memkv")
    backend = Backend(store, BackendConfig(fanout_matcher=DeviceFanout()))
    try:
        res = watch_drive(backend, watchers, watchers // 100, writes, writers,
                          seed)
    finally:
        backend.close()
        store.close()
    res.pop("biggest")
    res["events_per_s"] = res["delivered"] / res["wall_s"]
    return res


def watch_ab(args) -> int:
    """``--watch-ab DIR``: the watch drive alone, through the package of
    checkout DIR and through this one in turns (DIR, this, this, DIR), each
    in a process of its own on the card; one JSON line per run."""
    here = str(Path(__file__).resolve().parent)
    for tree in (args.watch_ab, here, here, args.watch_ab):
        tree = str(Path(tree).resolve())
        out = subprocess.run(
            [sys.executable, "-c", AB_CHILD, tree, str(Path(__file__).resolve()),
             str(args.watchers), str(args.writes), str(args.writers),
             str(args.seed)],
            cwd=tree, capture_output=True, text=True, timeout=3000)
        if out.returncode != 0:
            print(f"chip_smoke: the watch drive in {tree} failed:\n"
                  f"{out.stdout[-4000:]}{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        log(json.dumps({"tree": tree, **json.loads(
            out.stdout.strip().splitlines()[-1])}))
    log(nvidia_smi())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--kernel-keys", type=int, default=200_000)
    ap.add_argument("--kernel-revs", type=int, default=100)
    ap.add_argument("--watchers", type=int, default=10_000)
    ap.add_argument("--block-events", type=int, default=512)
    ap.add_argument("--big-watchers", type=int, default=100_000)
    ap.add_argument("--big-events", type=int, default=4096)
    ap.add_argument("--deep-events", type=int, default=40_000)
    ap.add_argument("--writes", type=int, default=10_000)
    ap.add_argument("--writers", type=int, default=16)
    ap.add_argument("--remote-keys", type=int, default=250_000,
                    help="user keys of (g2): its load and compaction go "
                         "over TCP one request at a time")
    ap.add_argument("--chaos-keys", type=int, default=100_000)
    ap.add_argument("--chaos-watchers", type=int, default=1000)
    ap.add_argument("--chaos-horizon", type=float, default=20.0)
    ap.add_argument("--chaos-merge-threshold", type=int, default=256)
    ap.add_argument("--watch-ab", metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.watch_ab:
        return watch_ab(args)

    dev = resolve_device()

    seconds = {}
    t0 = time.perf_counter()
    native = NativeBuild()  # g++ beside nvcc
    try:
        _build.build_all()
        log(f"build: kernels {time.perf_counter() - t0:.1f} s")
    finally:
        native_s = native.wait()
    log(f"build: make -C native {' '.join(NATIVE_TARGETS)} {native_s:.1f} s")
    seconds["a"] = time.perf_counter() - t0
    for name, text in _build.BUILD_LOG.items():
        log(f"ptxas [{name}]:\n{text.strip()}")
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    layouts = bench_layouts(args.kernel_keys)
    bench = kernel_phase(layouts, args.kernel_revs, dev)
    victim_bench = victim_phase(layouts, args.kernel_revs, dev)
    del layouts
    seconds["b, d"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store, top = load_store(args.keys, args.seed, dev)
    backend = Backend(store, BackendConfig(
        fanout_matcher=DeviceFanout(device=dev)))
    try:
        launches, main_cases = serve_phase(backend, store, top, dev)
        seconds["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compacted = compact_phase(backend, store, top, args.keys, dev)
        seconds["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fanned = fanout_phase(backend, dev, args)
        seconds["f"] = time.perf_counter() - t0
    finally:
        backend.close()
        store.close()
    t0 = time.perf_counter()
    deployed = deployed_phases(args, dev)
    seconds["g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chaos = chaos_phase(args, dev)
    seconds["h"] = time.perf_counter() - t0
    log(f"phase seconds: {json.dumps(seconds)}")
    launches["victim_mask"] = compacted["launches"]
    main_cases["victim_mask"] = compacted["case"]
    # the launches of the deployed engines' and the chaos phases' paths
    for res in deployed.values():
        for name, n in res["launches"].items():
            launches[name] += n
    for res in (chaos["storage"], chaos["merge"]):
        for name, n in res["launches_after"].items():
            launches[name] += n
    launches.update(fanned["watch"]["launches"])
    launches["fanout_dispatch"] += chaos["fanout_dispatch"]
    main_cases.update(fanned["watch"]["cases"])
    errs = {name: [v["max_abs_err"] for (n, _l), v in bench.items() if n == name]
            for name in ("scan_mask", "scan_mask_q")}
    errs["victim_mask"] = [v["max_abs_err"] for v in victim_bench.values()]
    for name in ("fanout_dispatch", "fanout_mask_range"):
        errs[name] = [v["max_abs_err"] for (n, _c), v in
                      fanned["cases"].items() if n == name]

    kernels = []
    for name in SOURCES:
        m = main_cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max([m["max_abs_err"]] + errs[name]),
            "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "bound_full_ms": m["bound_full_ms"],
            "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
