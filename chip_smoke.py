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
(n) the device programs no serving path calls (ROADMAP item 11: plain
    PyTorch, no kernel), right after (c) on its mirror, each partition one
    block: ``count_visible`` and ``visible_mask`` for each query of (c)'s
    request batch, equal to K1's counts and mask bit for bit;
    ``visible_indices`` of each mask, equal to J1's indices;
    ``point_lookup`` of ``PROGRAM_LOOKUPS`` (1,000) dataset keys drawn with
    ``--seed`` and ``PROGRAM_ABSENT`` (16) absent ones, at the top revision
    and half of it, equal to the host store's latest version (revision,
    tombstone; the row holding it; row 0's fields where nothing is found);
    ``compact_block`` with K3's victim mask at (e)'s compaction revision
    (count = N - victims, rows equal to its run on a CPU copy);
    ``fanout_mask`` on (f)'s population of ``PROGRAM_WATCHERS`` (10,000, 100
    broad) written as prefixes x a ``PROGRAM_EVENTS`` (512) block, equal to
    its CPU run, and to K5's mask on the watchers whose range is their
    prefix. Each program's time (CUDA events) is printed with the card's
    name and power limit. Its kernel launches are not the path's.
(l) the device mesh, right after (n) in its process: two slots, on two
    cards where the machine has them, else two slots of ``cuda:0`` (which
    run back to back on its stream: no speed is read from them). (l1) a
    second ``CudaKvStorage`` with 4 partitions over the two slots on (c)'s
    host store (1M keys, a 2.0M-row mirror): (c)'s request batch in one
    ``scan_batch`` (K2 once per slot), each query alone (K1 once per slot;
    the bytes it pulls at most the counts plus P·pow2(its largest
    partition's rows)·8) and (c)'s edge queries as Counts, every answer
    equal to (c)'s scanner's; K1/K2 held against the plain version on
    every shard with the edge queries. (l2) a seeded store of
    ``MESH_KEYS`` (100,000) kube keys on one slot and over the two, then
    ``MESH_OPS`` (2,000) creates, updates, deletes and recreates on both,
    a Range and a Count every tenth op equal, the sharded overlay live; a
    forced merge re-uploads only the slots holding a dirty partition (and
    keeps one), and so does a write to the other slot. (l3) (f)'s
    population of ``--watchers`` (1% broad) on a ``DeviceFanout`` over the
    two slots and a one-slot one, a 15-event block and (i)'s 10,000 × 512:
    the same pairs in the same order, equal to ``match_oracle`` on 256
    watchers; the legacy matcher (K5) likewise. (l4) J6 (``parallel/
    step.py``) over a (2, 2) mesh on (l2)'s mirror and (l3)'s table, equal
    to the wrappers on the gathered columns. Then (l2)'s stores compact at
    one revision: equal stores and victims, K3 once per slot. Every kernel
    must launch under (l)'s owner.
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
    (g) and (h) share no state with the other phases: a second process
    runs them, started after (d), while this one runs (c), (n), (l), (e)
    and (f), and a third (i), (j) and (k); their lines come as they are
    printed.
(i) scheduled serving over native: (c)'s dataset loaded into native's
    data dir, which is then closed and booted by the port's CLI:
    ``kubebrain_tpu_torch.cli.build_backend`` with ``CLI_FLAGS`` (``cuda``
    over native in (g1)'s shape, ``--tpu-fanout``, ``--single-node``, the
    scheduler's and the leases' settings at the CLI's defaults) and a
    recording sink of the script's own as its ``metrics``; then the
    mirror's first publish, by export. (i1) 32 namespace
    readers (16 requests each: a Range and a Count at the load's head, a
    Range at an older revision, a page of 500 at the head) and two all-pods
    clients, through a scheduler at ``batch`` 1 and then through the one
    the CLI built (``--sched-batch``, 8), every response equal to the same
    requests run one by one on the Backend first (a shed request is
    submitted again and counted); the CLI's scheduler must launch K2 with
    more than one query a launch. (i2) beside the batch-8 run, 8 writers, ``--sched-writes`` in
    all, create/update (against the create's revision)/delete chains with a
    read-your-writes check every 50th operation: write groups form, every
    acknowledged revision is unique and is watched once, in order, and the
    prefix's Range equals the writers' ledger. (i3) ``--leases`` leases of
    5 seconds with 100 Event keys each, half kept alive from
    the SYSTEM lane, under a watch drive of 1,000 watchers
    on ``/registry/events/`` namespaces (70 broad): the expired leases' keys
    leave Count (K1) and Range, every watcher equals ``match_oracle`` (K4),
    and the lease checkpoints move no quarantine and no rebuild; then more
    leases expire with the reaper stopped, native restarts through the CLI
    again (the keepalive client attached as soon as ``build_backend``
    returns, before the reaper's first tick), the kept leases
    rehydrate with their keys, the expired ones are reaped at boot, the kept
    ones are revoked and a compaction at the head (K3) changes no answer.
    The sink's lease counters and gauges must equal the registry's, and its
    merge rows the scanners'.
(j) a follower on the card, beside the leader the (i3) restart leaves
    standing: ``cli.build_backend`` with ``FOLLOWER_FLAGS`` (``--role
    follower``, ``cuda`` over memkv, ``--tpu-fanout``, ``--leader-info``
    at :class:`LeaderStatus`, a stdlib HTTP ``/status`` of the leader
    Backend), bootstrapped by ``ReplicaApplier.apply_bootstrap`` from one
    leader ``list_`` of the whole keyspace at its head, then fed by
    :class:`ReplicationFeed` (one leader watch of the whole keyspace,
    wire-shaped events into ``apply_wire_events``, progress marks from
    ``flushed_revision``; it stands in for the replication stream, which
    needs ``grpcio``). Beside 8 leader writers (``--sched-writes`` ops of
    pods through the leader's scheduler): 32 namespace readers on the
    follower's scheduler (Range, Count and a page of 500 at explicit
    revisions at or below the watermark, a Range at the bootstrap
    revision, serializable head Ranges), each answer equal to the leader's
    at the revision read; at least 100 fenced Counts, each at or above the
    leader revision read before it; 1,000 follower-local watchers on the
    pod namespaces (70 broad), each equal to ``match_oracle``, the
    follower's hub stream equal to the leader's events. Then a leader
    compaction at the head, which the follower adopts from ``/status``:
    reads below it refused as compacted on both sides, above it equal. No
    serializable read may be refused as stale while the watermark lag is
    inside the bound, no off-device counter of the follower may move, and
    the follower's own K1, K2, K3 and K4 must launch.
(k) the cluster replay, after (j) in its process: the port's workload
    runner (``kubebrain_tpu_torch.workload``) replays
    ``WorkloadSpec.for_cluster(REPLAY_NODES, seed=--seed)``, ``make
    bench-cluster``'s default shape (1,000 nodes, 100 namespaces, 4,000
    preloaded pods of 256-4,096 bytes, 1,000 controllers with a watch
    each, 1,000 node leases, 30 s simulated at time scale 5, open loop:
    pod churn, paged lists, aligned relist storms, keepalives, two
    compactions), twice, each time on a fresh native store booted by
    ``cli.build_backend`` with ``CLI_FLAGS``: (k1) unchanged, then (k2)
    beside the fewest whole-``/registry/pods/`` watchers that make the
    hub's interval index dense (60 at 1,000 nodes, computed by
    :func:`replay_broad`), so that its blocks reach K4, which (k1) never
    runs. The one cut: the runner's transport is in process
    (:class:`InProcessTransport`: Range, Count and Txn through the
    scheduler the etcd services share, keepalives on its SYSTEM lane,
    watches on ``Backend.watch_range``, the scrape rendered from the
    script's sink), since the card's machine has no ``grpcio``. A checker
    thread reads back keys written in the last second. Each run fails
    unless the schedule regenerates to its sha256, every acknowledged pod
    write is at its revision in a final scan with no definite-failure key
    and no ghost, the ``lincheck`` history of every pod write and point
    read is linearizable, every watch equals ``match_oracle`` from its
    start revision with none cancelled, no kept lease expired, a
    compaction completed without a rebuild from the store, the report's
    correctness bounds hold (query batches formed), K1-K3 ((k2): K1-K4)
    launched under (k)'s owner and no off-device counter moved. Its
    latency and shed bounds are printed, not held.

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

Output, last three lines: the kernels JSON (with each kernel's launches on
the follower of (j), in the replay of (k) and on the mesh of (l) beside
the total), the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.

``--watch-ab DIR`` runs only the watch drive on an empty store, through
the package of checkout DIR and through this one in turns (DIR, this,
this, DIR), each in a process of its own: one JSON line per run, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
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

from kubebrain_tpu_torch import _build, cli, coder
from kubebrain_tpu_torch.backend import Backend, BackendConfig, CompactedError
from kubebrain_tpu_torch.backend.errors import (
    CASRevisionMismatchError,
    FutureRevisionError,
    KeyExistsError,
    WatchExpiredError,
)
from kubebrain_tpu_torch.backend.common import (
    LAST_REV_KEY,
    TOMBSTONE,
    Verb,
    WatchEvent,
)
from kubebrain_tpu_torch.backend.scanner import EVENTS_TTL_SECONDS, Scanner
from kubebrain_tpu_torch.backend.watcherhub import (
    ProgressMarker,
    WatcherHub,
    _RangeIndex,
)
from kubebrain_tpu_torch.device import TRANSFER_METER, _pow2_bucket, resolve_device
from kubebrain_tpu_torch.faults import FaultPlane, FaultyStorage, generate
from kubebrain_tpu_torch.fanout import DeviceFanout, match_oracle
from kubebrain_tpu_torch.fanout.dispatch import max_block_events
from kubebrain_tpu_torch.lease.registry import LeaseNotFoundError
from kubebrain_tpu_torch.lincheck import History
from kubebrain_tpu_torch.metrics import Metrics
from kubebrain_tpu_torch.ops import compact, compact_kernels, fanout, fanout_kernels
from kubebrain_tpu_torch.ops import scan, scan_kernels
from kubebrain_tpu_torch.ops import keys as keyops
from kubebrain_tpu_torch.ops import launch_owner
from kubebrain_tpu_torch.ops.scan import flip_sign
from kubebrain_tpu_torch.parallel.mesh import Mesh
from kubebrain_tpu_torch.parallel.step import make_data_plane_step
from kubebrain_tpu_torch.replica import (
    ReplicaApplier,
    ReplicaRefusedError,
    StaleReplicaError,
)
from kubebrain_tpu_torch.sched import (
    Lane,
    SchedOverloadError,
    SchedResultTimeoutError,
    ensure_scheduler,
)
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.errors import (
    KeyNotFoundError,
    StorageError,
    UncertainResultError,
)
from kubebrain_tpu_torch.storage.cuda.encode import build_encoding
from kubebrain_tpu_torch.trace import STAGE_METRIC, TRACER
from kubebrain_tpu_torch.workload import WorkloadSpec, generator, slo
from kubebrain_tpu_torch.workload.runner import WorkloadRunner
from kubebrain_tpu_torch.storage.cuda.engine import (
    CudaKvStorage,
    _part_indices_of_mask,
    bound_rows,
    query_tensors,
)

#: the card of every store this script builds itself: the engine's default
#: (one slot per visible card) is driven through the CLI in (i)-(k), and a
#: mesh of two cards only in (l)
CARD = "cuda:0"
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
        (sh,) = mirror.shards  # (c)'s store is on one card (CARD)
        cols = (sh.keys, sh.revs, sh.tomb, sh.n_valid)
        p, c, n = sh.keys.shape
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
            "scan_mask", *cols, *query_tensors(
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
        args = scanner._victim_args(*marked[0])[0]  # one slot
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


# ------------------------------------------------------------------ phase n
#: (n): keys of the dataset looked up one by one, and keys it lacks
PROGRAM_LOOKUPS = 1000
PROGRAM_ABSENT = 16
#: (n): (f)'s population written as prefixes, and the block they match
PROGRAM_WATCHERS = 10_000
PROGRAM_BROAD = 100
PROGRAM_EVENTS = 512


def dataset_keys(n_keys: int) -> list[bytes]:
    """The user keys of :func:`kube_dataset` (``n_keys``), in its order."""
    n_events = n_keys // 4
    return ([b"/events/ns%02d/ev-%06d" % (i % 20, i) for i in range(n_events)]
            + [b"/registry/pods/ns%02d/pod-%06d" % (i % 32, i)
               for i in range(n_keys - n_events)])


def probe_row(mirror, key: bytes, dev) -> torch.Tensor:
    """``key`` as one flipped int32[C] row in the mirror's compare domain
    (encoded like its stored keys where the mirror is encoded)."""
    u8 = np.zeros((1, mirror.raw_key_width), np.uint8)
    u8[0, : len(key)] = np.frombuffer(key, np.uint8)
    if mirror.encoding is not None:
        u8, _ = mirror.encoding.encode_keys(u8, np.array([len(key)]))
    return flipped(keyops.bytes_to_chunks(u8)[0], dev)


def store_answer(inner, key: bytes, read_rev: int) -> tuple:
    """The latest version of ``key`` at or below ``read_rev`` in the host
    store: (found, revision, tombstone)."""
    lo, hi = coder.internal_range(key, key + b"\0")
    best = None
    for ikey, value in inner.iter(lo, hi):
        ukey, rev = coder.decode(ikey)
        if ukey == key and 0 < rev <= read_rev and (best is None
                                                    or rev > best[0]):
            best = (rev, value == TOMBSTONE)
    return (False, None, None) if best is None else (True, *best)


def program_line(name: str, what: str, ms: float, smi: str) -> None:
    log(f"program {name} [{what}]: {ms} ms per call (CUDA events, calls "
        f"back to back), plain PyTorch, no kernel; card {smi}")


def programs_phase(backend, store, top: int, n_keys: int, seed: int, dev,
                   smi: str, n_lookups: int = PROGRAM_LOOKUPS,
                   n_watchers: int = PROGRAM_WATCHERS,
                   n_broad: int = PROGRAM_BROAD,
                   n_events: int = PROGRAM_EVENTS) -> dict:
    """(n): the device programs no serving path calls (``ops/scan.py``
    ``count_visible``, ``visible_mask``, ``visible_indices``,
    ``point_lookup``; ``ops/compact.py::compact_block``;
    ``ops/fanout.py::fanout_mask``) on (c)'s mirror, each partition one
    block, held against the kernels of the path and the host store.
    Raises at the first mismatch; returns each program's time (ms)."""
    scanner = backend.scanner
    mirror = scanner._mirror
    (sh,) = mirror.shards  # (c)'s store is on one card (CARD)
    keys_t, revs, tomb, nv = sh.keys, sh.revs, sh.tomb, sh.n_valid
    p_n, c, n = keys_t.shape
    out = {}

    # count_visible / visible_mask per (c) query and partition against K1,
    # visible_indices against J1 on K1's mask
    def block_args(spec, p: int = 0) -> tuple:
        """One query's arguments of the one-block programs, partition p."""
        q = query_tensors(mirror.encoding, mirror.key_width, [spec], dev)
        return (keys_t[p], revs[p], tomb[p], nv[p], *[t[0] for t in q])

    queries = [(q[1], q[2], (q[3] or top)) for q in request_batch(top)]
    for spec in queries:
        starts, ends, unb, rrevs = query_tensors(
            mirror.encoding, mirror.key_width, [spec], dev)
        k1_mask, k1_counts = scan_kernels.visibility_mask_batch(
            keys_t, revs, tomb, nv, starts[0], ends[0], unb, rrevs)
        size = fanout.pow2_at_least(max(1, int(k1_counts.max())))
        j1 = _part_indices_of_mask(k1_mask, size)
        for p in range(p_n):
            args = block_args(spec, p)
            mask = scan.visible_mask(*args)
            if not torch.equal(mask, k1_mask[p]):
                raise AssertionError(f"(n) visible_mask differs from K1 on "
                                     f"{spec[:2]} partition {p}")
            if int(scan.count_visible(*args)) != int(k1_counts[p]):
                raise AssertionError(f"(n) count_visible differs from K1 on "
                                     f"{spec[:2]} partition {p}")
            if not torch.equal(scan.visible_indices(mask, size),
                               j1[p].to(torch.int64)):
                raise AssertionError(f"(n) visible_indices differs from J1 "
                                     f"on {spec[:2]} partition {p}")
    ns_args, pods_args = block_args((*NS, top)), block_args((*PODS, top))
    pods_mask = scan.visible_mask(*pods_args)
    pods_size = fanout.pow2_at_least(max(1, int(pods_mask.sum())))
    out["count_visible"] = time_ms(lambda: scan.count_visible(*ns_args), 20)
    out["visible_mask"] = time_ms(lambda: scan.visible_mask(*pods_args), 20)
    out["visible_indices"] = time_ms(
        lambda: scan.visible_indices(pods_mask, pods_size), 20)
    shape = f"C={c}, N={n}, {int(mirror.n_valid[0])} valid"
    program_line("count_visible", f"{shape}, one namespace",
                 out["count_visible"], smi)
    program_line("visible_mask", f"{shape}, all pods", out["visible_mask"],
                 smi)
    program_line("visible_indices", f"N={n}, {int(pods_mask.sum())} set, size "
                 f"{pods_size}", out["visible_indices"], smi)
    log(f"(n) count_visible, visible_mask: equal to K1 on {len(queries)} "
        f"queries x {p_n} partitions; visible_indices equal to J1")

    # point_lookup: drawn keys and absent ones against the host store
    inner = store.untracked()
    rng = random.Random(seed)
    present = rng.sample(dataset_keys(n_keys), min(n_lookups, n_keys))
    absent = [k[:-1] + b"x" for k in present[:PROGRAM_ABSENT]]
    found_n = tomb_n = 0
    for i, key in enumerate(present + absent):
        read_rev = top if i % 2 == 0 else top // 2
        want = store_answer(inner, key, read_rev)
        row_key = probe_row(mirror, key, dev)
        hits = []
        for p in range(p_n):
            found, rev, row, tb = scan.point_lookup(
                keys_t[p], revs[p], tomb[p], nv[p], row_key, read_rev)
            if bool(found):
                hits.append((p, int(rev), int(row), bool(tb)))
            elif (int(row), int(rev), bool(tb)) != (
                    0, int(mirror.revs_host[p, 0]),
                    bool(mirror.tomb_host[p, 0])):
                raise AssertionError(f"(n) point_lookup's not-found answer "
                                     f"for {key!r} is not row 0's")
        got = ((False, None, None) if not hits
               else (True, hits[0][1], hits[0][3]))
        if len(hits) > 1 or got != want:
            raise AssertionError(f"(n) point_lookup of {key!r} at {read_rev}: "
                                 f"{hits} where the host store has {want}")
        if hits:
            p, rev, row, _tb = hits[0]
            if (mirror.user_key(p, row) != key
                    or int(mirror.revs_host[p, row]) != rev):
                raise AssertionError(f"(n) point_lookup of {key!r}: row "
                                     f"{row} holds another version")
            found_n += 1
            tomb_n += want[2]
        elif i < len(present) and read_rev == top:
            raise AssertionError(f"(n) {key!r} not found at the top")
    one = probe_row(mirror, present[0], dev)
    out["point_lookup"] = time_ms(lambda: scan.point_lookup(
        keys_t[0], revs[0], tomb[0], nv[0], one, top), 20)
    program_line("point_lookup", f"{shape}, one key", out["point_lookup"], smi)
    log(f"(n) point_lookup: {len(present)} keys and {len(absent)} absent "
        f"ones equal to the host store ({found_n} found, {tomb_n} of them "
        f"tombstones)")

    # compact_block on K3's victim mask at (e)'s compaction revision
    (k3_args,) = scanner._victim_args(mirror, b"", b"", top, n_keys // 8)
    k3_mask, k3_counts = compact_kernels.victim_mask_batch(*k3_args)
    for p in range(p_n):
        got = compact.compact_block(keys_t[p], revs[p], tomb[p], k3_mask[p])
        kept = int(got[3])
        if kept != n - int(k3_counts[p]):
            raise AssertionError(f"(n) compact_block kept {kept} rows of {n} "
                                 f"with {int(k3_counts[p])} victims")
        keep = ~k3_mask[p]
        last = torch.full((n - kept,), n - 1, dtype=torch.int64, device=dev)
        for g, col in zip(got[:3], (keys_t[p], revs[p], tomb[p])):
            if not (torch.equal(g[..., :kept], col[..., keep])
                    and torch.equal(g[..., kept:],
                                    col.index_select(-1, last))):
                raise AssertionError(f"(n) compact_block's rows are not the "
                                     f"unmasked ones in order, then row N-1, "
                                     f"partition {p}")
        want = compact.compact_block(keys_t[p].cpu(), revs[p].cpu(),
                                     tomb[p].cpu(), k3_mask[p].cpu())
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"(n) compact_block on {dev} differs from "
                                 f"its CPU run, partition {p}")
    out["compact_block"] = time_ms(lambda: compact.compact_block(
        keys_t[0], revs[0], tomb[0], k3_mask[0]), 10)
    program_line("compact_block", f"{shape}, {int(k3_counts[0])} victims",
                 out["compact_block"], smi)

    # fanout_mask on (f)'s population as prefixes, against its CPU run and
    # K5 where a watcher's prefix is its range
    frng = np.random.RandomState(seed)
    specs = fanout_population(n_watchers, n_broad, frng)
    events = fanout_events(n_events, 1, frng)
    matcher, ev, cols, index, wids = packed_block(specs, events, dev)
    width = matcher.table.width
    pc, pm = fanout.prefix_rows(*keyops.chunk_prefix_masks(
        [s for _w, s, _e, _r in specs], width))
    min_revs = torch.tensor([r for *_x, r in specs], dtype=torch.int64)
    prefix = (torch.from_numpy(pc).to(dev), torch.from_numpy(pm).to(dev),
              min_revs.to(dev))
    got = fanout.fanout_mask(*ev, *prefix)
    want = fanout.fanout_mask(ev[0].cpu(), ev[1].cpu(),
                              *[t.cpu() for t in prefix])
    if not torch.equal(got.cpu(), want):
        raise AssertionError("(n) fanout_mask on the card differs from its "
                             "CPU run")
    k5 = fanout_kernels.fanout_mask_range(*ev, n_events, *cols, index=index)
    slot_of = {int(w): s for s, w in enumerate(wids) if w >= 0}
    same = [w for w, s, e, _r in specs if e == coder.prefix_end(s)]
    w_idx = torch.tensor(same, dtype=torch.int64, device=dev)
    s_idx = torch.tensor([slot_of[w] for w in same], dtype=torch.int64,
                         device=dev)
    if not torch.equal(got[:n_events].index_select(1, w_idx),
                       k5[:n_events].index_select(1, s_idx)):
        raise AssertionError("(n) fanout_mask differs from K5 where a prefix "
                             "is the watcher's range")
    out["fanout_mask"] = time_ms(lambda: fanout.fanout_mask(*ev, *prefix), 10)
    program_line("fanout_mask", f"{n_watchers} prefixes x {n_events} events, "
                 f"C={width // 4}", out["fanout_mask"], smi)
    log(f"(n) fanout_mask: equal to its CPU run, and to K5 on {len(same)} "
        f"of {len(specs)} watchers whose prefix is their range "
        f"({int(got.sum())} deliveries)")
    return out


# ------------------------------------------------------------------ phase l
#: the launches of (l)'s sharded engines, matchers and J6 are counted under
#: this owner (``ops/launch_owner.py``)
MESH_OWNER = "mesh"
#: (l)'s mirror partitions: two per slot
MESH_PARTITIONS = 4
#: (l2): kube keys of the store built on one slot and over two (the size
#: of (h)), and the writes on both sides
MESH_KEYS = 100_000
MESH_OPS = 2_000


def mesh_slots(dev) -> tuple[list, str]:
    """(l)'s two slots: two cards where the machine has them, else two
    slots of one device (run back to back on its stream)."""
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)], "two cards"
    one = torch.device("cuda", 0) if dev.type == "cuda" else dev
    return [one, one], f"two slots of one device ({one})"


def same_answer(got, want, what: str) -> None:
    """A scan answer, ``(kvs, more)`` or a count, equal to ``want``."""
    for x in (got, want):
        if isinstance(x, BaseException):
            raise x
    if isinstance(want, int):
        if got != want:
            raise AssertionError(f"{what}: count {got} against {want}")
        return
    same_kvs(got[0], want[0], what)
    if got[1] != want[1]:
        raise AssertionError(f"{what}: more {got[1]} against {want[1]}")


def partition_counts(mirror, kvs) -> list[int]:
    """The rows of sorted ``kvs`` in each partition of ``mirror``."""
    keys = [kv.key for kv in kvs]
    cuts = [0] + [bisect.bisect_left(keys, fk)
                  for fk in mirror.partition_first_keys()[1:]] + [len(keys)]
    return [b - a for a, b in zip(cuts, cuts[1:])]


def pull_bound(mirror, kvs) -> int:
    """(l1)'s transfer bound of one Range over ``mirror``: the counts, 4
    bytes a partition, and P·pow2(its largest partition's rows)·8."""
    p, n = mirror.partitions, mirror.keys_host.shape[1]
    return 4 * p + p * _pow2_bucket(max(partition_counts(mirror, kvs)), n) * 8


def mesh_reads(backend, store, top: int, slots) -> dict:
    """(l1): a second ``CudaKvStorage`` with ``MESH_PARTITIONS`` partitions
    over the two slots, on (c)'s host store; (c)'s request batch in one
    ``scan_batch`` (K2 once per slot), each of its queries alone (K1 once
    per slot, the pulled bytes held to :func:`pull_bound`) and the edge
    queries as Counts, every answer equal to (c)'s scanner's at the same
    revision; K1 and K2 held against the plain version on each shard with
    the edge queries. The scanner is closed after, and the host store
    stays (c)'s."""
    ref = backend.scanner
    t0 = time.perf_counter()
    sharded = CudaKvStorage(store.untracked(), mesh=slots,
                            partitions=MESH_PARTITIONS)
    sc = sharded.make_scanner(get_compact_revision=lambda _s: 0)
    sc.launch_owner = MESH_OWNER
    try:
        sc.publish()
        built = time.perf_counter() - t0
        m = sc._mirror
        if len(m.shards) != len(slots) or m.partitions != MESH_PARTITIONS:
            raise AssertionError(f"(l1): {len(m.shards)} shards, "
                                 f"{m.partitions} partitions")
        log(f"(l1) sharded mirror over {len(slots)} slots, P="
            f"{m.partitions}, N={m.keys_host.shape[1]}, {m.rows} rows "
            f"(partitions {m.n_valid.tolist()}), published in {built:.1f} s")
        head = backend.current_revision()
        queries = [("range", q[1], q[2], q[3] or head, q[4]) if q[0] == "list"
                   else ("count", q[1], q[2], q[3] or head)
                   for q in request_batch(top)]
        # rows/s: the rows the sharded engine's Ranges returned over the
        # seconds of its batch and its Ranges alone (Counts not timed)
        t0 = time.perf_counter()
        got = sc.scan_batch(queries)
        served = time.perf_counter() - t0
        want = ref.scan_batch(queries)
        rows = 0
        for q, g, w in zip(queries, got, want):
            same_answer(g, w, f"(l1) batched {q[0]} {q[1]!r}")
            rows += 0 if q[0] == "count" else len(g[0])
        worst = 0.0
        for q, w in zip(queries, want):
            b0 = TRANSFER_METER.snapshot()[0]
            t1 = time.perf_counter()
            g = (sc.count(*q[1:4]) if q[0] == "count"
                 else sc.range_(*q[1:5]))
            if q[0] == "range":
                served += time.perf_counter() - t1
            cost = TRANSFER_METER.snapshot()[0] - b0
            same_answer(g, w, f"(l1) {q[0]} {q[1]!r}")
            bound = (4 * m.partitions if q[0] == "count"
                     else pull_bound(m, w[0]))
            if cost > bound:
                raise AssertionError(f"(l1) {q[0]} {q[1]!r}: pulled {cost} "
                                     f"bytes, bound {bound}")
            if q[0] == "range":
                worst = max(worst, cost / bound)
                rows += len(g[0])
        n_edges = 0
        for p in (0, m.partitions - 1):
            nv = int(m.n_valid[p])
            mid = nv // 2 // scan.BLOCK_OWNED * scan.BLOCK_OWNED
            at = sorted({r for r in (254, 255, 256, 510, mid + 254, mid + 255,
                                     mid + 256) if 0 < r < nv})
            specs = edge_specs(lambda r, p=p: m.user_key(p, r), at, nv, head)
            for s, e, r in specs:
                same_answer(sc.count(s, e, r), ref.count(s, e, r),
                            f"(l1) edge count {s!r}..{e!r}")
            for sh in m.shards:
                cols = (sh.keys, sh.revs, sh.tomb, sh.n_valid)
                check_edges(cols, m.encoding, m.key_width, specs, sh.device)
            n_edges += len(specs)
        log(f"(l1) every answer equals (c)'s: {len(queries)} queries batched "
            f"and alone, {n_edges} edge Counts; K1/K2 on every shard "
            f"bit-identical to the plain version on the edge queries; a "
            f"Range pulled at most {worst:.3f} of its bound")
        stayed_on_device(sc, 1, "(l1)")
        return {"serve_s": served, "rows": rows, "rows_per_s": rows / served}
    finally:
        sc.close()


def mesh_store(slots, seed: int, n_keys: int, n_ops: int) -> tuple:
    """(l2), first half: a seeded store of ``n_keys`` kube keys built
    twice, on one slot and over the two slots, then ``n_ops`` seeded
    creates, updates, deletes and recreates of pods in the last namespaces
    on both, a Range and a Count every tenth op equal on both; the sharded
    side keeps its overlay live (the one-slot side merges as it goes).
    Then the sharded side merges: a slot is re-uploaded only if it holds a
    dirty partition, and at least one is kept; one more write, to the first
    partition, re-uploads the other slot alone. Returns the two Backends
    and the publish counts."""
    rows, top = kube_dataset(n_keys, seed)
    stores = [new_storage("cuda", inner="memkv", device=slots[0],
                          ttl_supported=False),
              new_storage("cuda", inner="memkv", mesh=slots,
                          partitions=MESH_PARTITIONS, ttl_supported=False)]
    for st in stores:
        load_rows(st.untracked(), rows, top)
    plain, sharded = (Backend(st, BackendConfig()) for st in stores)
    sharded.scanner.launch_owner = MESH_OWNER
    sharded.scanner._merge_threshold = 10 ** 9  # the overlay stays live
    plain.scanner._merge_threshold = 256
    for b in (plain, sharded):
        b.scanner.publish()
    rng = random.Random(seed)
    live: dict[bytes, int] = {}
    reads = 0
    for i in range(n_ops):
        ns = rng.randrange(28, 32)
        k = b"/registry/pods/ns%02d/mesh-%04d" % (ns, rng.randrange(500))
        op = rng.random()
        action = ("create" if k not in live else "recreate" if op < 0.3
                  else "update" if op < 0.8 else "delete")
        revs = set()
        for b in (plain, sharded):
            if action == "create":
                r = b.create(k, b"c%d" % i)
            elif action == "recreate":
                b.delete(k)
                r = b.create(k, b"r%d" % i)
            elif action == "update":
                r = b.update(k, b"u%d" % i, live[k])
            else:
                r, _ = b.delete(k)
            revs.add(r)
        if len(revs) != 1:
            raise AssertionError(f"(l2) op {i}: revisions {revs}")
        if action == "delete":
            live.pop(k)
        else:
            live[k] = r
        if i % 10 == 9:
            span = (b"/registry/pods/ns%02d/" % ns, b"/registry/pods/ns%02d0" % ns)
            same_kvs(sharded.list_(*span).kvs, plain.list_(*span).kvs,
                     f"(l2) range after op {i}")
            if sharded.count(*span)[0] != plain.count(*span)[0]:
                raise AssertionError(f"(l2) count after op {i}")
            reads += 2
    sc = sharded.scanner
    if not len(sc._delta):
        raise AssertionError("(l2) the sharded overlay is not live")
    uploads = []
    for write in (None, b"/events/ns00/ev-mesh"):
        if write is not None:
            sharded.create(write, b"e")
            plain.create(write, b"e")
        before = sc._mirror
        firsts = before.partition_first_keys()
        dirty = {max(bisect.bisect_right(firsts, uk) - 1, 0)
                 for uk, _r, _v in sc._delta.rows()}
        per_slot = before.partitions // len(before.shards)
        sc.publish()
        after = sc._mirror
        kept = [i for i, (a, b) in enumerate(zip(before.shards, after.shards))
                if a is b]
        want = [i for i in range(len(after.shards))
                if not dirty & set(range(i * per_slot, (i + 1) * per_slot))]
        if kept != want or not kept:
            raise AssertionError(f"(l2) slots kept {kept}, dirty partitions "
                                 f"{sorted(dirty)}: want {want} kept")
        uploads.append(len(after.shards) - len(kept))
    log(f"(l2) {n_keys} keys, {n_ops} ops, {reads} reads equal on one "
        f"slot and over two with the overlay live; slots re-uploaded per "
        f"publish {uploads} of {len(slots)} (only the dirty ones)")
    return plain, sharded, uploads


def mesh_compaction(plain, sharded, what: str = "(l2)"
                    ) -> collections.Counter:
    """(l2), second half: both compact at one revision; the stores must be
    equal, the victims too, the sharded mirror stay on its incremental
    path, and K3 run once per slot of each border pair's pass. ``what``
    names the check in its messages. Returns the launches counted under
    ``MESH_OWNER`` meanwhile."""
    rev = plain.current_revision()
    owned = launch_owner.take(MESH_OWNER)
    done_s, seen_s, wall_s = compact_recording(sharded, rev)
    during = launch_owner.take(MESH_OWNER)
    k3 = during.get("victim_mask", 0)
    done_p, seen_p, wall_p = compact_recording(plain, rev)
    slots = len(sharded.scanner._mirror.shards)
    if done_s != rev or done_p != rev:
        raise AssertionError(f"{what} compacted to {done_s}/{done_p}, not "
                             f"{rev}")
    if victim_totals(seen_s) != victim_totals(seen_p):
        raise AssertionError(f"{what} victims {victim_totals(seen_s)} against "
                             f"{victim_totals(seen_p)}")
    if {s.mirror_path for s in seen_s} != {"stored_incremental"}:
        raise AssertionError(f"{what} sharded mirror path not "
                             f"stored_incremental")
    if k3 != slots * len(seen_s):
        raise AssertionError(f"{what} K3 launched {k3} times for {len(seen_s)} "
                             f"passes over {slots} slots")
    n = same_store(plain.store.untracked(), sharded.store.untracked())
    for span in ((b"/registry/pods/", b"/registry/pods0"),
                 (b"/events/", b"/events0")):
        same_kvs(sharded.list_(*span).kvs, plain.list_(*span).kvs,
                 f"{what} post-compact range {span[0]!r}")
    log(f"{what} compaction at {rev}: stores equal ({n} rows), victims "
        f"{victim_totals(seen_s)} on both, K3 {k3} launches ({slots} slots x "
        f"{len(seen_s)} passes); sharded {wall_s:.2f} s, one slot "
        f"{wall_p:.2f} s")
    owned = collections.Counter(owned)
    owned.update(during)
    return owned


def mesh_fanout(slots, seed: int, n_watchers: int, n_events: int) -> tuple:
    """(l3): (f)'s population of ``n_watchers`` (1% broad) on a
    ``DeviceFanout`` over the two slots and on a one-slot one, over a block
    of the main path's size (15 events) and case (i) (``n_events``): the
    pairs equal element for element and equal to ``match_oracle`` on a
    seeded sample of watchers; then the legacy matcher (K5) over the two
    slots against its one-slot self and the oracle. Returns the sharded
    matcher and (i)'s block."""
    rng = np.random.RandomState(seed)
    specs = fanout_population(n_watchers, n_watchers // 100, rng)
    plain = DeviceFanout(device=slots[0])
    sharded = DeviceFanout(mesh=slots)
    sharded.launch_owner = MESH_OWNER
    pairs = 0
    blocks = [("main-path block", fanout_events(15, 1000, rng)),
              ("(i)", fanout_events(n_events, 2000, rng))]
    sample = [specs[i] for i in rng.choice(
        len(specs), min(ORACLE_WATCHERS, len(specs)), replace=False)]
    keep = {wid for wid, *_r in sample}
    for what, events in blocks:
        want = plain._match(events, specs, 1)
        got = sharded._match(events, specs, 1)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"(l3) {what}: the sharded pairs differ from "
                                 f"the one-slot table's")
        mine = {(int(got[2][s]), int(e)) for s, e in zip(*got[:2])
                if int(got[2][s]) in keep}
        if mine != oracle_pairs(events, sample):
            raise AssertionError(f"(l3) {what}: pairs differ from "
                                 f"match_oracle")
        pairs += len(got[0])
    legacy = [fanout.FanoutMatcher(device=slots[0]),
              fanout.FanoutMatcher(mesh=slots)]
    legacy[1].launch_owner = MESH_OWNER
    events = blocks[0][1]
    masks = [m(events, specs, version=1) for m in legacy]
    col_of = {wid: j for j, (wid, *_r) in enumerate(specs)}
    cols = [col_of[wid] for wid, *_r in sample]
    if not (masks[0] == masks[1]).all() or not (
            masks[1][:, cols] == match_oracle(events, sample)).all():
        raise AssertionError("(l3) the legacy matcher over two slots differs")
    st = sharded.table.stats()
    log(f"(l3) {n_watchers} watchers (table {st['capacity']} slots over "
        f"{st['devices']}, sharded={st['sharded']}): {pairs} pairs over "
        f"{len(blocks)} blocks equal to the one-slot table's, in order, and "
        f"to match_oracle on {len(sample)} watchers; the legacy matcher's "
        f"masks too")
    return sharded, blocks[1][1]


def mesh_step(mirror, matcher, events, slots) -> None:
    """(l4): J6 (``parallel/step.py``) on (l2)'s sharded mirror columns and
    (l3)'s sharded watcher table, a ``/registry/pods/`` scan at the head,
    the victims at half the head, the fan-out mask of (i)'s block; equal to
    the wrappers' results on the same columns gathered onto one slot."""
    s0, s1 = slots
    mesh = Mesh(np.array([[s0, s1], [s1, s0]], dtype=object), ("part", "wat"))
    s_row, e_row, unb = bound_rows(mirror.encoding, mirror.key_width, *PODS)
    start = torch.from_numpy(flip_sign(s_row))
    end = torch.from_numpy(flip_sign(e_row))
    head, half = mirror.max_rev, mirror.max_rev // 2
    shards, _wids, _v = matcher.table.shard_views()
    ek, er, _epad = matcher._pack_events(events)
    cols = [[getattr(sh, c) for sh in mirror.shards]
            for c in ("keys", "revs", "tomb", "ttl", "n_valid")]
    table = [[sh[i] for sh in shards] for i in range(1, 5)]
    with launch_owner.owned_by(MESH_OWNER):
        vis, total, victims, fmask = make_data_plane_step(mesh)(
            *cols, start, end, unb, head, half, 0, *table, ek, er,
            len(events))
    one = [torch.cat([t.to(s0) for t in ts]) for ts in cols]
    whole = [torch.cat([t.to(s0) for t in ts]) for ts in table]
    m1, c1 = scan_kernels.visibility_mask_batch(
        *one[:3], one[4], start.to(s0), end.to(s0),
        torch.tensor([int(unb)], dtype=torch.int32, device=s0),
        torch.tensor([head], dtype=torch.int64, device=s0))
    v1, _n = compact_kernels.victim_mask_batch(
        *one, start.to(s0), end.to(s0), unb, half, 0)
    f1 = fanout_kernels.fanout_mask_range(ek.to(s0), er.to(s0), len(events),
                                          *whole)
    if not (torch.equal(vis, m1) and total == int(c1.sum())
            and torch.equal(victims, v1) and torch.equal(fmask, f1)):
        raise AssertionError("(l4) J6 differs from the one-slot wrappers")
    log(f"(l4) J6 over a (2, 2) mesh: {total} visible rows, "
        f"{int(victims.sum())} victims, {int(fmask.sum())} fan-out matches, "
        f"equal to the wrappers on the gathered columns")


def mesh_phase(backend, store, top: int, args, dev, n_keys: int = MESH_KEYS,
               n_ops: int = MESH_OPS) -> dict:
    """(l): the device mesh on the card. The launches of its sharded
    engines, matchers and J6 are counted under ``MESH_OWNER`` and each
    kernel must launch there."""
    slots, what = mesh_slots(dev)
    log(f"(l) mesh: {what}, {MESH_PARTITIONS} partitions")
    t_l = time.perf_counter()
    launch_owner.take(MESH_OWNER)
    seconds = {}
    t0 = time.perf_counter()
    reads = mesh_reads(backend, store, top, slots)
    seconds["l1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain, sharded, uploads = mesh_store(slots, args.seed, n_keys, n_ops)
    owned = collections.Counter()
    try:
        seconds["l2 writes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        matcher, block = mesh_fanout(slots, args.seed, args.watchers,
                                     args.block_events)
        seconds["l3"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_step(sharded.scanner._mirror, matcher, block, slots)
        seconds["l4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        owned.update(mesh_compaction(plain, sharded))
        seconds["l2 compaction"] = time.perf_counter() - t0
        stayed_on_device(sharded.scanner, 1, "(l2)")
    finally:
        for b in (plain, sharded):
            b.close()
            b.store.close()
    owned.update(launch_owner.take(MESH_OWNER))
    total = time.perf_counter() - t_l
    launches = {name: owned.get(name, 0) for name in SOURCES}
    log(f"(l) seconds: {json.dumps(seconds)}; {total:.1f} s in all")
    log(f"(l) rows/s: {reads['rows_per_s']:.1f} ({reads['rows']} rows "
        f"returned by (l1)'s Ranges in {reads['serve_s']:.3f} s, batched and "
        f"alone, by the sharded engine)")
    log(f"(l) publishes: slots re-uploaded {uploads}; launches under "
        f"'{MESH_OWNER}' {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"(l): a kernel never launched on the mesh: "
                             f"{launches}")
    return {"launches": launches, "seconds": total, "what": what}


# ------------------------------------------------------------------ phase f
FANOUT_KINDS = (b"pods", b"leases", b"endpoints", b"configmaps")
FANOUT_NAMESPACES = [b"ns-%03d" % i for i in range(40)]


def fanout_population(n_watchers: int, n_broad: int, rng,
                      kinds=FANOUT_KINDS,
                      namespaces=FANOUT_NAMESPACES) -> list:
    """Watcher specs ``[(wid, start, end, min_rev)]`` shaped like
    ``bench.py``'s fan-out population (``_fanout_population``,
    bench.py:161-186): kind/namespace prefix ranges (the informer shape),
    about 2% single-key watches whose end is ``key + b"\\0"``, ``min_rev``
    0-255, and ``n_broad`` unbounded watches over the whole registry. The
    broad cohort makes the hub's interval index dense, which routes every
    block to the matcher. ``kinds`` are the resources watched, in
    ``namespaces``."""
    specs = []
    for w in range(n_watchers - n_broad):
        ns = namespaces[rng.randint(len(namespaces))]
        kind = kinds[rng.randint(len(kinds))]
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


def one_slot_view(table) -> tuple:
    """A one-slot table's published ``(starts, ends, unbounded, min_rev,
    index, wids, version)``, from ``WatcherTable.shard_views``."""
    (shard,), wids, version = table.shard_views()
    return (*shard[1:], wids, version)


def packed_block(specs, events, dev, width=None):
    """A matcher's table synced to ``specs`` and ``events`` packed at its
    width → (matcher, (keys, revs) on dev, the table's device columns,
    its rank index, slot → wid)."""
    m = DeviceFanout(width=width, device=dev)
    m.table.sync(specs, version=1)
    ek, er, _epad = m._pack_events(events)
    ws, we, wu, wr, index, wids, _v = one_slot_view(m.table)
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
    ws, we, _wu, _wr, (rows, rs, re), _wids, _v = one_slot_view(table)
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
    change (no index work). Host ms of ``shard_views()`` (to a
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
            one_slot_view(table)
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
    ccols = one_slot_view(m.table)
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
    (lcols, lindex), = legacy._watcher_table(specs, version=1)  # one slot
    lwids = np.full(lcols[0].shape[0], -1, np.int64)
    lwids[:len(specs)] = [wid for wid, *_r in specs]
    for n_ev in (300, n_e):
        lev = legacy_block(events[:n_ev], dev)
        case = mask_case(lev, n_ev, lcols, lindex)
        res = fanout_checks(case, 20)
        lw, lc = lcols[0].shape
        res.update(shape=(lw, lev[0].shape[0], lc),
                   oracle_pairs=check_oracle(case, events[:n_ev], specs,
                                             lwids, lev[0].shape[0], seed))
        out[("fanout_mask_range", f"iv {n_ev}")] = res
        log(describe_fanout(f"fanout_mask_range [(iv) {n_w} watchers, "
                            f"W={lw}, E={lev[0].shape[0]}, n_ev={n_ev}, "
                            f"C={lc}, n_u={lindex.rows.shape[0]}]",
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
    ccols = one_slot_view(m.table)
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
    cols_kept = one_slot_view(m.table)
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


class RecordingMetrics(Metrics):
    """The script's metrics sink: counters summed and histogram samples
    kept by (name, tags), scrape-time gauges held and sampled on demand.
    Phase (i) passes one wherever the CLI passes its ``metrics``; the watch
    drive reads the hub's lag and drops and the tracer's stages from one."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: collections.Counter = collections.Counter()
        self.histograms: dict = collections.defaultdict(list)
        self.gauges: dict = {}
        self.gauge_fns: dict = {}

    @staticmethod
    def _key(name, tags):
        return name, tuple(sorted((k, str(v)) for k, v in tags.items()))

    def emit_counter(self, name, value=1, **tags):
        with self.lock:
            self.counters[self._key(name, tags)] += value

    def emit_gauge(self, name, value, **tags):
        with self.lock:
            self.gauges[self._key(name, tags)] = value

    def emit_histogram(self, name, value, **tags):
        with self.lock:
            self.histograms[self._key(name, tags)].append(value)

    def register_gauge_fn(self, name, fn, **tags):
        with self.lock:
            self.gauge_fns[self._key(name, tags)] = fn

    def unregister_gauge_fn(self, name, **tags):
        with self.lock:
            self.gauge_fns.pop(self._key(name, tags), None)

    def counter(self, name: str) -> float:
        """The counter ``name``, summed over its tags."""
        with self.lock:
            return sum(v for (n, _t), v in self.counters.items() if n == name)

    def mark(self) -> dict:
        """The samples held so far in each series, for ``since``."""
        with self.lock:
            return {key: len(vs) for key, vs in self.histograms.items()}

    def samples(self, name: str, since: dict | None = None, **tags) -> list:
        """The samples of the histogram ``name`` in its series that carry
        ``tags``, those after the :meth:`mark` ``since`` when given."""
        want = set(self._key(name, tags)[1])
        since = since or {}
        with self.lock:
            return [v for key, vs in self.histograms.items()
                    if key[0] == name and want <= set(key[1])
                    for v in vs[since.get(key, 0):]]

    def sums_by(self, name: str, tag: str, since: dict | None = None) -> dict:
        """The samples of the histogram ``name`` after ``since``, summed by
        the value of their ``tag``."""
        since = since or {}
        out: dict = {}
        with self.lock:
            for key, vs in self.histograms.items():
                value = dict(key[1]).get(tag)
                if key[0] == name and value is not None:
                    out[value] = out.get(value, 0.0) + sum(
                        vs[since.get(key, 0):])
        return out

    def gauge(self, name: str, **tags) -> float:
        with self.lock:
            fn = self.gauge_fns[self._key(name, tags)]
        return float(fn())


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
                settle=None, kinds=FANOUT_KINDS, sink=None,
                namespaces=FANOUT_NAMESPACES) -> dict:
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
    retry FIFO's rewrites). ``kinds`` are the watched resources, in
    ``namespaces``; ``sink``,
    when given, is the :class:`RecordingMetrics` the hub and the tracer
    emit into throughout (and keep after the drive), else a new one. The
    result holds the hub's event stream (``streamed``)."""
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
    for i, (_w, s, e, r) in enumerate(fanout_population(
            n_watchers, n_broad, rng, kinds, namespaces)):
        # a fifth start a few hundred revisions ahead: min_rev filters
        registered.append(watch(s, e, head + 1 + 2 * r if i % 5 == 0 else 0,
                                i))
    with hub._lock:
        specs = [(wid, *hub._filters[wid]) for wid, _q in registered]

    churned: list[tuple] = []           # (wid, queue, start, end, from rev)
    cohort: collections.deque = collections.deque()

    def rewatch():
        _w, s, e, _r = fanout_population(1, 0, churn_rng, kinds,
                                         namespaces)[0]
        rev = backend.current_revision() + 1
        wid, q = watch(s, e, rev, len(churned))
        churned.append((wid, q, s, e, rev))
        cohort.append(wid)

    for _ in range(max(n_watchers // 100, 1)):
        rewatch()
    table = getattr(hub._fanout_matcher, "table", None)
    table0 = dict(table.stats()) if table is not None else {}

    rec = sink if sink is not None else RecordingMetrics()
    mark, dropped0 = rec.mark(), rec.counter("kb.watch.dropped")
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
        hub.set_metrics(sink)
        TRACER.metrics = sink
    if any(t.is_alive() for t in consumers + [churner]):
        raise AssertionError("a consumer or churn thread did not stop")

    events = [e for b in streamed for e in b]
    revs = np.array([e.revision for e in events], dtype=np.int64)
    if (np.diff(revs) <= 0).any():
        raise AssertionError("the hub streamed events out of revision order")
    if set(written) - set(revs.tolist()):
        raise AssertionError("a write never reached the hub")
    dropped = [wid for wid, q in registered if id(q) in poisoned]
    counted = rec.counter("kb.watch.dropped") - dropped0
    if dropped or counted or hub.watcher_count() < len(registered):
        raise AssertionError(f"watchers dropped: {len(dropped)} poisoned, "
                             f"{counted} counted")
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
    lag = rec.samples("kb.watch.lag.seconds", mark)
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
            "lag_p50_ms": statistics.median(lag) * 1e3 if lag else None,
            "stage_s": rec.sums_by(STAGE_METRIC, "stage", mark),
            "streamed": events}


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
    view = one_slot_view(matcher.table)
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
        (lcols, lindex), = lmatcher._shards  # one slot
        cases["fanout_mask_range"] = fanout_checks(
            mask_case(lev, len(block), lcols, lindex), 20)
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
MIRROR_DEVICE_COLUMNS = ("keys", "revs", "tomb", "ttl", "n_valid")


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
             if len(a.shards) != len(b.shards) or not all(
                 torch.equal(getattr(x, c), getattr(y, c))
                 for x, y in zip(a.shards, b.shards))]
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
    return backend, publish_by_export(backend, what, t0)


def publish_by_export(backend, what: str, t0: float) -> float:
    """The mirror's first publish, which must take the engine's bulk
    export (the Backend is closed if it did not); returns the seconds
    since ``t0``."""
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
    return seconds


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


def response_set(backend, revs, spans=RESTART_RANGES) -> list:
    """Every Range and Count of ``spans`` (the restart check's by default)
    and one ``list_batch`` of them at the revisions ``revs``, as comparable
    tuples."""
    out = []
    for rev in revs:
        for s, e in spans:
            res = backend.list_(s, e, revision=rev)
            out.append((s, e, rev, [(kv.key, kv.value, kv.revision)
                                    for kv in res.kvs],
                        backend.count(s, e, revision=rev)[0]))
    batch = [("list", s, e, rev, 0) for s, e in spans
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


SIDE_CHILD = """
import importlib.util, json, sys, types
spec = importlib.util.spec_from_file_location("chip_smoke_side", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
out = getattr(smoke, sys.argv[4])(
    types.SimpleNamespace(**json.loads(sys.argv[2])))
with open(sys.argv[3], "w") as f:
    json.dump(out, f)
"""


class SidePhases:
    """Phases in a process of their own on the same card, started at
    construction: ``phases(args)``, a function of this script, by default
    (g) and (h) (:func:`side_phases`); :func:`sched_phases` runs (i) and
    (j). They share no state with the other phases, and the host bounds
    them all. Its lines go to this process's output as they are printed;
    :meth:`result` waits for it and returns what ``phases`` returned (the
    seconds and the kernel launches of its phases)."""

    def __init__(self, args, phases: str = "side_phases",
                 what: str = "phases (g) and (h)"):
        self.what = what
        self.out = ROOT / "build" / "smoke" / f"{phases}.json"
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.out.unlink(missing_ok=True)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SIDE_CHILD, str(Path(__file__).resolve()),
             json.dumps(vars(args)), str(self.out), phases], cwd=ROOT)

    def result(self) -> dict:
        rc = self.proc.wait()
        if rc != 0:
            raise AssertionError(f"{self.what} failed in their process "
                                 f"(exit {rc})")
        return json.loads(self.out.read_text())

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def side_phases(args) -> dict:
    """(g) and (h), in the process :class:`SidePhases` starts."""
    dev = resolve_device(CARD)
    seconds = {}
    t0 = time.perf_counter()
    deployed = deployed_phases(args, dev)
    seconds["g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chaos = chaos_phase(args, dev)
    seconds["h"] = time.perf_counter() - t0
    launches = collections.Counter()
    for res in deployed.values():
        launches.update(res["launches"])
    for res in (chaos["storage"], chaos["merge"]):
        launches.update(res["launches_after"])
    launches["fanout_dispatch"] += chaos["fanout_dispatch"]
    return {"seconds": seconds, "launches": dict(launches)}


def sched_phases(args) -> dict:
    """(i), (j) and (k), in the process a :class:`SidePhases` starts."""
    dev = resolve_device(CARD)
    t0 = time.perf_counter()
    served = sched_phase(args, dev)
    j = served["follower"]["seconds"]
    t1 = time.perf_counter()
    replayed = replay_phase(args, dev)
    launches = collections.Counter(served["launches"])
    launches.update(replayed["launches"])
    return {"seconds": {"i": t1 - t0 - j, "j": j,
                        "k": time.perf_counter() - t1},
            "launches": dict(launches),
            "follower_launches": served["follower"]["follower_launches"],
            "replay_launches": replayed["owner_launches"]}


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


def chaos_reads(backend, stop: threading.Event, top: int, counts,
                errors: list) -> None:
    """Range, Count and ``list_batch`` at the head between the writers'
    writes until ``stop``; a read failed by an injected fault is counted,
    not raised. Any other error goes to ``errors`` and ends the reads."""
    batch = head_batch(top)
    try:
        while not stop.is_set():
            for fn in (lambda: backend.list_(*NS),
                       lambda: backend.count(*PODS),
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
    except BaseException as e:  # raised by chaos_run after the join
        errors.append(e)


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
        read_errors: list = []
        stop = threading.Event()
        reader = threading.Thread(target=chaos_reads,
                                  args=(backend, stop, top, reads,
                                        read_errors))
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
        if read_errors:
            raise read_errors[0]
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


# ------------------------------------------------------------------ phase i
#: phase (i)'s flags to the port's CLI, ``--data-dir`` and ``--device``
#: apart: ``cuda`` over native in (g1)'s shape, the block fan-out matcher
#: (K4), one node (its identity given, so no interface is probed), and
#: the request scheduler's and the lease subsystem's settings at the
#: CLI's defaults, stated so that the phase runs what it assumes
CLI_FLAGS = ("--storage", "cuda", "--inner-storage", "native",
             "--native-partitions", str(NATIVE_PARTITIONS), "--tpu-fanout",
             "--single-node", "--identity", "127.0.0.1:2380",
             "--sched-depth", "4", "--sched-queue-limit", "1024",
             "--sched-shed-ms", "5000", "--sched-batch", "8",
             "--sched-write-batch", "8", "--lease-reap-interval", "1",
             "--lease-checkpoint-interval", "5")
#: client-go's pager page size (tools/pager/pager.go ``defaultPageSize``)
PAGE_SIZE = 500
#: the dataset's pod namespaces (:func:`kube_dataset`): one reader each
POD_NAMESPACES = [b"/registry/pods/ns%02d/" % i for i in range(32)]
POD_NAMESPACE_NAMES = [b"ns%02d" % i for i in range(32)]
#: rounds of a reader's four request kinds: 16 requests per reader
READ_ROUNDS = 4
READ_KINDS = ("range", "count", "range_old", "page", "all_pods")
WRITER_THREADS = 8
WRITE_PREFIX = b"/registry/configmaps/"
#: kube-apiserver reuses one Event lease for the writes of
#: --lease-reuse-duration-seconds (60 s): here 100 Events per lease
KEYS_PER_LEASE = 100
#: an Event lease's TTL: kube-apiserver's --event-ttl (1 h), cut to 5 s
LEASE_TTL_S = 5.0
#: the watchers of (i3)'s watch drive on /registry/events/ namespaces
EVENT_WATCHERS = 1000
EVENTS = (b"/registry/events/", b"/registry/events0")
#: resubmissions of one shed request before the phase fails
SHED_RETRIES = 50


def until_admitted(fn, sheds: collections.Counter, what: str):
    """``fn()``, submitted again each time the scheduler sheds it: a shed
    request was never dealt a revision, and kube-apiserver's etcd client
    retries the ``ResourceExhausted`` it maps to. ``sheds[what]`` counts
    the sheds."""
    for _ in range(SHED_RETRIES):
        try:
            return fn()
        except SchedResultTimeoutError:
            raise  # dispatched, outcome unknown: not a shed
        except SchedOverloadError:
            sheds[what] += 1
    raise AssertionError(f"{what}: shed {SHED_RETRIES} times in a row")


def take_launches() -> dict:
    """Every kernel wrapper's launches since the counts were last set to
    0; sets them to 0."""
    out = {"scan_mask": scan_kernels.visibility_mask_batch.launches,
           "scan_mask_q": scan_kernels.visibility_mask_batch_q.launches,
           "victim_mask": compact_kernels.victim_mask_batch.launches,
           "fanout_dispatch": fanout_kernels.fanout_dispatch.launches,
           "fanout_mask_range": fanout_kernels.fanout_mask_range.launches}
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()
    return out


def cli_args(d: Path, dev) -> argparse.Namespace:
    """Phase (i)'s flags, parsed by the port's CLI: ``CLI_FLAGS`` over the
    native data dir ``d`` on ``dev``."""
    return cli.build_parser().parse_args(
        [*CLI_FLAGS, "--data-dir", str(d), "--device", dev.type])


def cli_boot(args, sink, what: str, on_lease=None) -> tuple:
    """A Backend booted as the port's CLI boots one:
    ``cli.build_backend(args, metrics=sink)`` opens the engine on the data
    dir and wires the Backend (the tracer, the fan-out matcher, the hub,
    the retry queue, the scanner's gauges and emissions, the request
    scheduler, the peers, the lease registry and reaper, which rehydrates
    the lease table and ticks from then on); ``on_lease(backend)`` runs as
    soon as it returns, then the mirror's first publish, by the engine's
    export. Returns (backend, store, seconds of ``build_backend``, seconds
    of the publish)."""
    t0 = time.perf_counter()
    backend, store, _peers = cli.build_backend(args, metrics=sink)
    wired_s = time.perf_counter() - t0
    try:
        if on_lease is not None:
            on_lease(backend)
        publish_s = publish_by_export(backend, what, time.perf_counter())
    except BaseException:
        backend.close()
        store.close()
        raise
    return backend, store, wired_s, publish_s


def read_requests(top: int) -> dict:
    """(i1)'s requests by client: each pod namespace's reader issues, in
    turn, a Range at ``top``, a Count at ``top``, a Range at an older
    revision and a ``PAGE_SIZE`` page at ``top``, ``READ_ROUNDS`` times;
    two more clients one all-pods Range at ``top`` each."""
    old = top // 2
    out = {}
    for i, ns in enumerate(POD_NAMESPACES):
        s, e = ns, coder.prefix_end(ns)
        out[f"reader-{i:02d}"] = [
            ("range", (s, e, top, 0)), ("count", (s, e, top)),
            ("range_old", (s, e, old, 0)),
            ("page", (s, e, top, PAGE_SIZE))] * READ_ROUNDS
    for j in range(2):
        out[f"all-pods-{j}"] = [("all_pods", (*PODS, top, 0))]
    return out


def read_via(target, kind: str, args: tuple, client: str | None = None):
    """One (i1) request through the scheduler (``client`` given) or on the
    Backend itself."""
    kw = {} if client is None else {"client": client}
    if kind == "count":
        return target.count(*args, **kw)
    return target.list_(*args, **kw)


class WriteLedger:
    """What the (i2) writers were told: every acknowledged (revision, verb,
    key), each key's acknowledged state ((value, revision), or None once
    deleted) and the read-your-writes checks made."""

    def __init__(self):
        self.lock = threading.Lock()
        self.acked: list[tuple[int, int, bytes]] = []
        self.state: dict[bytes, tuple | None] = {}
        self.ryw = 0


def config_writer(sched, t: int, n_ops: int, ledger: WriteLedger,
                  sheds: collections.Counter) -> None:
    """One (i2) writer, a scheduler client of its own: creates under its
    own prefix, each followed by an update against the revision the create
    returned, every third key then deleted against the update's; every
    50th operation reads its last key at revision 0 through the scheduler,
    which must show the write. A shed write is submitted again."""
    client = f"writer-{t}"
    ops = 0

    def acked(rev, verb, key, state):
        nonlocal ops
        ops += 1
        with ledger.lock:
            ledger.acked.append((rev, verb, key))
            ledger.state[key] = state
        if ops % 50:
            return
        res = until_admitted(
            lambda: sched.list_(key, key + b"\0", 0, 0, client=client),
            sheds, "read_your_writes")
        got = [(kv.key, kv.value, kv.revision) for kv in res.kvs]
        want = [] if state is None else [(key, *state)]
        if got != want:
            raise AssertionError(f"(i2) {client}: read-your-writes of {key!r} "
                                 f"gave {got}, not {want}")
        with ledger.lock:
            ledger.ryw += 1

    i = 0
    while ops < n_ops:
        key = WRITE_PREFIX + b"ns-w%d/cm-%05d" % (t, i)
        value = b"created-%d-%d" % (t, i)
        rev = until_admitted(lambda: sched.create(key, value, client=client),
                             sheds, "create")
        acked(rev, Verb.CREATE, key, (value, rev))
        if ops < n_ops:
            value = b"updated-%d-%d" % (t, i)
            rev = until_admitted(
                lambda: sched.update(key, value, rev, client=client), sheds,
                "update")
            acked(rev, Verb.PUT, key, (value, rev))
        if i % 3 == 2 and ops < n_ops:
            rev = until_admitted(
                lambda: sched.delete(key, rev, client=client), sheds,
                "delete")[0]
            acked(rev, Verb.DELETE, key, None)
        i += 1


class WatchCollector:
    """One watch on ``prefix`` drained by a thread of its own into
    ``events`` as (revision, verb, key)."""

    def __init__(self, backend, prefix: bytes):
        self.backend = backend
        self.wid, self.q = backend.watch(prefix)
        self.events: list[tuple[int, int, bytes]] = []
        self.dropped = False
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._drain)
        self.thread.start()

    def _drain(self):
        while not self.stop.is_set() or not self.q.empty():
            try:
                item = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is None:
                self.dropped = True
                return
            if not isinstance(item, ProgressMarker):
                self.events.extend((e.revision, e.verb, e.key) for e in item)

    def close(self, want: int, timeout: float = 60.0) -> list:
        """Wait for ``want`` events, then stop; returns the events."""
        deadline = time.monotonic() + timeout
        while len(self.events) < want and not self.dropped \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        self.stop.set()
        self.thread.join(timeout=30)
        self.backend.unwatch(self.wid)
        if self.thread.is_alive() or self.dropped:
            raise AssertionError("the (i2) watch was dropped or never stopped")
        return self.events


def check_writes(backend, sched, sink, ledger: WriteLedger, events: list,
                 wsizes: list, wall: float) -> dict:
    """(i2)'s checks: write groups formed and were all counted, every
    acknowledged revision is unique and was watched once, in revision
    order, and the prefix's Range equals the ledger."""
    revs = [r for r, _v, _k in ledger.acked]
    if len(set(revs)) != len(revs):
        raise AssertionError("(i2) an acknowledged revision was given twice")
    if events != sorted(ledger.acked):
        raise AssertionError(f"(i2) the watch got {len(events)} events, not "
                             f"the {len(revs)} acknowledged writes once each "
                             f"in revision order")
    if sched.write_batched <= 0 or not wsizes or \
            sum(wsizes) - len(wsizes) != sched.write_batched:
        raise AssertionError(f"(i2) write groups: {sched.write_batched} ops "
                             f"rode a group, histogram {len(wsizes)} groups "
                             f"of {sum(wsizes)} ops")
    want = [(k, *st) for k, st in sorted(ledger.state.items()) if st]
    got = [(kv.key, kv.value, kv.revision) for kv in backend.list_(
        WRITE_PREFIX, coder.prefix_end(WRITE_PREFIX)).kvs]
    if got != want:
        raise AssertionError(f"(i2) the final Range of {WRITE_PREFIX!r} has "
                             f"{len(got)} keys, the ledger {len(want)}")
    return {"ops": len(revs), "wall_s": wall, "ops_per_s": len(revs) / wall,
            "groups": len(wsizes), "group_mean": statistics.mean(wsizes),
            "group_max": max(wsizes), "write_batched": sched.write_batched,
            "read_your_writes": ledger.ryw, "live_keys": len(want)}


def read_run(backend, sink, sched, batch: int, oracle: dict, requests: dict,
             writes: int = 0) -> dict:
    """One (i1) run through ``sched``, a scheduler that batches ``batch``
    reads: each client's requests from a thread of its own, all
    started together, every response held against ``oracle`` (a shed
    request is submitted again, its latency counted from the first
    submission); with ``writes``, (i2)'s writers beside the readers.
    Returns the run's numbers."""
    what = f"(i1) batch={batch}"
    sc = backend.scanner
    qs: list[int] = []
    orig = sc._dev_mask_batch

    def counted(mirror, specs):
        # the queries of each K2 launch (scan_batch's device queries)
        qs.append(len(specs))
        return orig(mirror, specs)

    sizes0 = len(sink.samples("kb.sched.batch.size"))
    wsizes0 = len(sink.samples("kb.sched.write.batch.size"))
    lat = {kind: [] for kind in READ_KINDS}
    wrong: list = []
    errors: list = []
    sheds: collections.Counter = collections.Counter()
    ledger = WriteLedger()
    write_wall: list[float] = []
    n_writers = WRITER_THREADS if writes else 0
    start = threading.Barrier(len(requests) + n_writers + 1)

    def reader(client, reqs):
        try:
            start.wait()
            for kind, args in reqs:
                t = time.perf_counter()
                res = until_admitted(
                    lambda: read_via(sched, kind, args, client), sheds, kind)
                lat[kind].append(time.perf_counter() - t)
                if res != oracle[(kind, args)]:
                    wrong.append((client, kind, args))
        except BaseException as e:  # raised on the main thread below
            errors.append(e)

    def writer(t):
        try:
            start.wait()
            t0 = time.perf_counter()
            config_writer(sched, t, writes // n_writers, ledger, sheds)
            write_wall.append(time.perf_counter() - t0)
        except BaseException as e:  # raised on the main thread below
            errors.append(e)

    watch = WatchCollector(backend, WRITE_PREFIX) if writes else None
    threads = [threading.Thread(target=reader, args=item)
               for item in requests.items()]
    threads += [threading.Thread(target=writer, args=(t,))
                for t in range(n_writers)]
    take_launches()
    sc._dev_mask_batch = counted
    try:
        for th in threads:
            th.start()
        start.wait(timeout=60)
        t0 = time.perf_counter()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
    finally:
        del sc._dev_mask_batch
        events = watch.close(len(ledger.acked)) if watch is not None else []
    launches = take_launches()
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"{what}: a client never finished")
    if errors:
        raise errors[0]
    if wrong:
        raise AssertionError(f"{what}: {len(wrong)} scheduled responses "
                             f"differ from the unscheduled oracle, the first "
                             f"{wrong[0][:2]}")
    if sum(sheds.values()) != sum(sched.shed_counts.values()):
        raise AssertionError(f"{what}: the clients saw {dict(sheds)} sheds, "
                             f"the scheduler counted {sched.shed_counts}")
    sizes = sink.samples("kb.sched.batch.size")[sizes0:]
    if sum(sizes) - len(sizes) != sched.batched:
        raise AssertionError(f"{what}: {sched.batched} reads rode a batch, "
                             f"the histogram {len(sizes)} batches of "
                             f"{sum(sizes)}")
    if len(qs) != launches["scan_mask_q"]:
        raise AssertionError(f"{what}: {len(qs)} batched scans but "
                             f"{launches['scan_mask_q']} K2 launches")
    n_req = sum(len(r) for r in requests.values())
    out = {
        "batch": batch, "requests": n_req, "wall_s": wall,
        "requests_per_s": n_req / wall,
        "p50_ms": {k: float(np.percentile(v, 50)) * 1e3 for k, v in lat.items()},
        "p99_ms": {k: float(np.percentile(v, 99)) * 1e3 for k, v in lat.items()},
        "batched": sched.batched, "coalesced": sched.coalesced,
        "shed": {lane.name.lower(): n for lane, n in sched.shed_counts.items()},
        "shed_by_kind": dict(sheds),
        "batch_size": {"count": len(sizes),
                       "mean": statistics.mean(sizes) if sizes else 0.0,
                       "max": max(sizes, default=0.0)},
        "k2_launches": launches["scan_mask_q"],
        "k2_mean_q": statistics.mean(qs) if qs else 0.0,
        "k1_launches": launches["scan_mask"],
        "host_pages": len(lat["page"]), "launches": launches}
    log(f"{what}: {n_req} requests from {len(requests)} clients in "
        f"{wall:.3f} s = {out['requests_per_s']:.1f} requests/s, every one "
        f"equal to the unscheduled oracle; p50 ms {out['p50_ms']}; p99 ms "
        f"{out['p99_ms']}; batched {out['batched']}, coalesced "
        f"{out['coalesced']}, shed {out['shed']} (by request "
        f"{out['shed_by_kind']}, each submitted again); kb.sched.batch.size "
        f"{out['batch_size']}; K2 launches {out['k2_launches']} (mean Q "
        f"{out['k2_mean_q']:.3f}), K1 launches {out['k1_launches']}; "
        f"{out['host_pages']} pages of {PAGE_SIZE} on the host path")
    if batch > 1 and (out["k2_launches"] <= 0 or out["k2_mean_q"] <= 1):
        raise AssertionError(f"{what}: the batches never reached K2 "
                             f"(launches {out['k2_launches']}, mean Q "
                             f"{out['k2_mean_q']})")
    if writes:
        wsizes = sink.samples("kb.sched.write.batch.size")[wsizes0:]
        out["writes"] = check_writes(backend, sched, sink, ledger, events,
                                     wsizes, max(write_wall))
        log(f"(i2): {json.dumps(out['writes'])}; every acknowledged write "
            f"read back and watched once, in revision order")
    return out


def scheduled_reads(backend, sink, top: int, writes: int,
                    batch: int) -> dict:
    """(i1) and (i2): the oracle first (each distinct request once, on the
    Backend without the scheduler), then the reads through a scheduler of
    ``batch`` 1 in the place of the CLI's, then through the CLI's own,
    which ``--sched-batch`` told to batch ``batch`` reads, with ``writes``
    writes beside it."""
    cli_sched = backend._kb_scheduler
    requests = read_requests(top)
    take_launches()
    t0 = time.perf_counter()
    oracle = {}
    for reqs in requests.values():
        for kind, args in reqs:
            if (kind, args) not in oracle:
                oracle[(kind, args)] = read_via(backend, kind, args)
    oracle_s = time.perf_counter() - t0
    launches = collections.Counter(take_launches())
    log(f"(i1) oracle: {len(oracle)} distinct requests one by one on the "
        f"Backend in {oracle_s:.3f} s")
    runs = {}
    del backend._kb_scheduler
    one = ensure_scheduler(
        backend, dataclasses.replace(cli_sched.config, batch=1), metrics=sink)
    try:
        runs[1] = read_run(backend, sink, one, 1, oracle, requests)
    finally:
        one.close()
        backend._kb_scheduler = cli_sched
    runs[batch] = read_run(backend, sink, cli_sched, batch, oracle, requests,
                           writes)
    for run in runs.values():
        launches.update(run.pop("launches"))
    del oracle
    return {"oracle_s": oracle_s, "runs": runs, "launches": dict(launches)}


class Keeper:
    """A keepalive client on the scheduler's SYSTEM lane, as the JAX
    front's ``LeaseService.keepalive_one`` submits each refresh
    (``kubebrain_tpu/server/etcd/misc.py:133-135``): every ``interval``
    seconds one keepalive per kept lease, while attached to a Backend."""

    def __init__(self, interval: float = 1.0):
        self.interval = interval
        self.lock = threading.Lock()
        self.backend = None
        self.ids: list[int] = []
        self.ok = 0
        self.refused: list[int] = []
        self.errors: list[BaseException] = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, name="lease-keeper")
        self.thread.start()

    def attach(self, backend) -> None:
        with self.lock:
            self.backend = backend

    def detach(self) -> None:
        with self.lock:
            self.backend = None

    def keep(self, lease_id: int) -> None:
        with self.lock:
            self.ids.append(lease_id)

    def drop(self, lease_id: int) -> None:
        """No more keepalives of ``lease_id`` from the moment this returns."""
        with self.lock:
            self.ids.remove(lease_id)

    def release(self) -> None:
        with self.lock:
            self.ids = []

    def _run(self) -> None:
        while not self.stop.wait(self.interval):
            with self.lock:
                if self.backend is None:
                    continue
                sched = self.backend._kb_scheduler
                reg = self.backend._kb_lease
                for lid in self.ids:
                    try:
                        ttl = sched.submit(lambda lid=lid: reg.keepalive(lid),
                                           Lane.SYSTEM, client="lease-keepalive")
                    except BaseException as e:  # raised by check()
                        self.errors.append(e)
                        continue
                    if ttl > 0:
                        self.ok += 1
                    else:
                        self.refused.append(lid)

    def check(self) -> None:
        if self.errors or self.refused:
            raise AssertionError(f"(i3) keepalives failed: {self.errors[:1]}, "
                                 f"refused for {len(self.refused)} leases")

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=30)


def lease_writer(leases: dict, keeper: Keeper, n_threads: int, ttl: float,
                 sheds: collections.Counter):
    """A :func:`watch_drive` writer: each thread grants its share of the
    leases, each of ``ttl`` seconds, and creates ``KEYS_PER_LEASE`` Event
    keys under it through the scheduler right after the grant (a shed
    create submitted again). Each lease is kept alive while its keys are
    written: kube-apiserver writes a lease's Events within the first 60 s
    of its 1 h TTL, so no write meets an expired lease. Then every other
    lease is let expire, its TTL counted from its last keepalive.
    ``leases`` gets (lease as of its last keepalive, keys) by index."""

    def write(backend, thread: int, n_ops: int, seed: int) -> list:
        sched, reg = backend._kb_scheduler, backend._kb_lease
        revs = []
        for j in range(n_ops // KEYS_PER_LEASE):
            idx = thread + j * n_threads
            lease = reg.grant(ttl)
            keeper.keep(lease.id)
            keys = []
            for k in range(KEYS_PER_LEASE):
                ns = FANOUT_NAMESPACES[(idx + k) % len(FANOUT_NAMESPACES)]
                key = b"/registry/events/%s/ev-%04d-%03d" % (ns, idx, k)
                revs.append(until_admitted(
                    lambda: sched.create(key, b"event-%d-%d" % (idx, k),
                                         lease=lease.id,
                                         client=f"events-{thread}"),
                    sheds, "event_create"))
                keys.append(key)
            if idx % 2:
                keeper.drop(lease.id)
                lease = reg.peek(lease.id)
            leases[idx] = (lease, keys)
        return revs

    return write


def wait_until(pred, what: str, timeout: float) -> float:
    """Poll ``pred`` until it holds; returns the seconds waited."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"(i3) timed out waiting: {what}")
        time.sleep(0.02)
    return time.monotonic() - t0


def lease_expiry(backend, sink, keeper: Keeper, args) -> dict:
    """(i3) up to the restart: ``args.leases`` leases of ``LEASE_TTL_S``
    seconds with ``KEYS_PER_LEASE`` Event keys each, half kept alive, under
    a watch drive of ``EVENT_WATCHERS`` watchers on
    ``/registry/events/`` namespaces (70 broad); after the reaper, the
    expired leases' keys are gone from Count (K1) and Range, every watcher
    equals ``match_oracle``, K4 launched, and the lease checkpoints moved
    neither a rebuild nor a quarantine."""
    sc, reg = backend.scanner, backend._kb_lease
    n_threads = math.gcd(args.leases, 10)
    leases: dict[int, tuple] = {}
    written: list[int] = []
    sheds: collections.Counter = collections.Counter()
    orig_ckpt = reg.checkpoint

    def counting(*a, **kw):
        wrote = orig_ckpt(*a, **kw)
        if wrote:
            written.append(1)
        return wrote

    def settle():
        # the drive waits for the reaper's deletes: expiry, then the reap
        expired = [lease.id for idx, (lease, _k) in leases.items() if idx % 2]
        wait_until(lambda: all(reg.peek(lid) is None for lid in expired),
                   "the reaper reaps every expired lease", LEASE_TTL_S + 60)

    before = (sc._poison_epoch, sc.rebuild_bg_count, sc.full_rebuild_total,
              len(sink.samples("kb.mirror.merge.seconds", kind="full_rebuild")))
    take_launches()
    reg.checkpoint = counting
    try:
        drive = watch_drive(backend, EVENT_WATCHERS, 70,
                            args.leases * KEYS_PER_LEASE, n_threads, args.seed,
                            writer=lease_writer(leases, keeper, n_threads,
                                                LEASE_TTL_S, sheds),
                            settle=settle, kinds=(b"events",), sink=sink)
    finally:
        del reg.checkpoint
    launches = take_launches()
    keeper.check()
    after = (sc._poison_epoch, sc.rebuild_bg_count, sc.full_rebuild_total,
             len(sink.samples("kb.mirror.merge.seconds", kind="full_rebuild")))
    merge_rebuilds = after[3] - before[3]
    if after[:2] != before[:2] or after[2] - before[2] != merge_rebuilds:
        raise AssertionError(f"(i3) across {len(written)} lease checkpoints "
                             f"the mirror quarantined or rebuilt: (poison, "
                             f"background rebuilds, full rebuilds, merges "
                             f"that rebuilt) {before} -> {after}")
    if not written:
        raise AssertionError("(i3) no lease checkpoint was written")
    kept = {i: v for i, v in leases.items() if i % 2 == 0}
    gone = {i: v for i, v in leases.items() if i % 2}
    live = sorted(k for _lease, keys in kept.values() for k in keys)
    n_gone = sum(len(keys) for _lease, keys in gone.values())
    sched = backend._kb_scheduler
    count = sched.count(*EVENTS)[0]
    keys = [kv.key for kv in sched.list_(*EVENTS).kvs]
    reads = take_launches()
    k1 = reads["scan_mask"]
    if count != len(live) or count != args.leases * KEYS_PER_LEASE - n_gone \
            or keys != live:
        raise AssertionError(f"(i3) after the reap Count says {count} and "
                             f"Range {len(keys)} Event keys, not the kept "
                             f"leases' {len(live)}: an expired lease's key "
                             f"is still visible, or a kept one is gone")
    if k1 <= 0 or launches["fanout_dispatch"] <= 0:
        raise AssertionError(f"(i3) K1 ({k1}) or K4 "
                             f"({launches['fanout_dispatch']}) never launched")
    deleted = {e.key: e for e in drive["streamed"] if e.verb == Verb.DELETE}
    lag = [deleted[k].ts - lease.deadline for lease, ks in gone.values()
           for k in ks]
    out = {"watchers": drive["watchers"], "events": drive["events"],
           "delivered": drive["delivered"], "blocks": drive["blocks"],
           "wall_s": drive["wall_s"], "checkpoints": len(written),
           "merge_full_rebuilds": merge_rebuilds,
           "reaper_lag_p50_s": statistics.median(lag),
           "reaper_lag_max_s": max(lag), "count_after_reap": count,
           "keepalives": keeper.ok, "sheds": dict(sheds)}
    for name, n in reads.items():
        launches[name] += n
    log(f"(i3): {args.leases} leases of {LEASE_TTL_S} s x "
        f"{KEYS_PER_LEASE} Event keys, half kept alive from the SYSTEM lane "
        f"({keeper.ok} keepalives); Count at the head {count} = the kept "
        f"leases' keys (K1 launched {k1}); watch drive of {drive['watchers']} "
        f"watchers: {drive['events']} events, {drive['delivered']} "
        f"deliveries, every watcher equal to match_oracle, none dropped, K4 "
        f"launches {launches['fanout_dispatch']}; reaper lag from expiry to "
        f"the delete's commit p50 {out['reaper_lag_p50_s']:.3f} s, max "
        f"{out['reaper_lag_max_s']:.3f} s; {len(written)} lease checkpoints "
        f"moved no quarantine and no rebuild ({merge_rebuilds} merges "
        f"rebuilt the mirror for keys the key dictionary could not hold)")
    return {**out, "leases": leases, "launches": launches}


def sched_phase(args, dev) -> dict:
    """(i): scheduled serving over native, booted by the port's CLI; then
    (j), a follower of the leader the (i3) restart leaves standing."""
    d = data_dir("sched")
    flags = cli_args(d, dev)
    sink = RecordingMetrics()
    keeper = Keeper()
    sheds: collections.Counter = collections.Counter()
    rows, top = kube_dataset(args.keys, args.seed)
    store = backend = None
    scanners = []
    take_launches()  # every count to 0: (i)'s own launches from here
    try:
        native = new_storage("native", data_dir=str(d), fsync=False,
                             partitions=NATIVE_PARTITIONS)
        try:
            load_s = load_rows(native, rows, top)
        finally:
            native.close()
        del rows
        backend, store, cli_s, publish_s = cli_boot(flags, sink, "(i)")
        scanners.append(backend.scanner)
        launches = collections.Counter(take_launches())
        reads = scheduled_reads(backend, sink, top, args.sched_writes,
                                flags.sched_batch)
        launches.update(reads.pop("launches"))
        keeper.attach(backend)
        expiry = lease_expiry(backend, sink, keeper, args)
        launches.update(expiry.pop("launches"))
        kept = {i: v for i, v in expiry.pop("leases").items() if i % 2 == 0}

        # the restart: more leases with keys, which expire while the reaper
        # is stopped, so the last checkpoint holds them expired (TTLs are
        # durations on the monotonic clock: downtime does not age a lease)
        reg, sched = backend._kb_lease, backend._kb_scheduler
        n_restart = max(1, args.leases // 4)

        def doom(i):
            # one client a lease, all at once; kept alive until its keys
            # are written
            lease = reg.grant(LEASE_TTL_S)
            keeper.keep(lease.id)
            for k in range(KEYS_PER_LEASE):
                key = b"/registry/events/%s/rs-%04d-%03d" % (
                    FANOUT_NAMESPACES[(i + k) % len(FANOUT_NAMESPACES)], i, k)
                until_admitted(lambda: sched.create(
                    key, b"restart-%d-%d" % (i, k), lease=lease.id,
                    client=f"events-restart-{i}"), sheds, "event_create")
            keeper.drop(lease.id)
            return lease.id

        with ThreadPoolExecutor(n_restart) as pool:
            doomed = list(pool.map(doom, range(n_restart)))
        reaper = backend._kb_lease_reaper
        reaper._stop.set()
        reaper._thread.join(timeout=30)
        wait_until(lambda: all(reg.time_to_live(lid)[0] == -1
                               for lid in doomed),
                   "the restart leases expire", LEASE_TTL_S + 60)
        head = backend.current_revision()
        keeper.detach()
        backend.close()
        backend = None
        store.close()
        store = None
        # the keeper attaches as soon as build_backend returns: its last
        # step, ensure_lease, rehydrates the lease table and starts the
        # reaper, so the keepalives resume before the mirror's publish, the
        # point where the hand wiring of earlier runs attached them
        backend, store, restart_cli_s, restart_publish_s = cli_boot(
            flags, sink, "(i3) restart", on_lease=keeper.attach)
        scanners.append(backend.scanner)
        reg, sched = backend._kb_lease, backend._kb_scheduler
        # the boot reap may already be under way: the reaper's first tick
        # runs as the lease table is rehydrated
        if backend.current_revision() < head:
            raise AssertionError(f"(i3) restart: revision "
                                 f"{backend.current_revision()}, below {head}")
        for lease, keys in kept.values():
            ttl, _granted, attached = reg.time_to_live(lease.id)
            if ttl <= 0 or attached != tuple(sorted(keys)):
                raise AssertionError(f"(i3) restart: kept lease {lease.id} "
                                     f"came back with TTL {ttl} and "
                                     f"{len(attached)} keys")
        boot_reap_s = wait_until(
            lambda: all(reg.peek(lid) is None for lid in doomed),
            "the boot reap of the leases that expired", 60)
        n_kept = len(kept) * KEYS_PER_LEASE
        if sched.count(*EVENTS)[0] != n_kept or any(
                reg.time_to_live(lid)[0] != -1 for lid in doomed) or \
                backend.current_revision() != head + n_restart * KEYS_PER_LEASE:
            raise AssertionError("(i3) restart: the expired leases were not "
                                 "reaped at boot, or were resurrected")
        keeper.release()
        with ThreadPoolExecutor(len(kept)) as pool:
            revoked = sum(pool.map(backend._kb_lease_reaper.revoke,
                                   [lease.id for lease, _k in kept.values()]))
        if revoked != n_kept or sched.count(*EVENTS)[0] != 0:
            raise AssertionError(f"(i3) revoking the kept leases deleted "
                                 f"{revoked} keys, not {n_kept}")
        keeper.check()
        log(f"(i3) restart: the CLI's build_backend (engine reopen, wiring, "
            f"lease table rehydrated with {len(kept)} kept leases and their "
            f"keys) in {restart_cli_s:.3f} s, mirror by export in "
            f"{restart_publish_s:.3f} s; the {n_restart} leases that expired "
            f"were reaped at boot in {boot_reap_s:.3f} s, not resurrected; "
            f"revoking the kept leases deleted {revoked} keys")

        # compaction at the head (K3): every answer as before it
        spans = [EVENTS, (WRITE_PREFIX, coder.prefix_end(WRITE_PREFIX)), NS,
                 PODS]
        head = backend.current_revision()
        before = response_set(backend, (head,), spans)
        launches.update(take_launches())
        t0 = time.perf_counter()
        compacted = backend.compact(head)
        compact_s = time.perf_counter() - t0
        k3 = take_launches()
        launches.update(k3)
        if response_set(backend, (head,), spans) != before or \
                k3["victim_mask"] <= 0:
            raise AssertionError(f"(i3) after the compaction to {compacted} a "
                                 f"response differs, or K3 never launched")
        launches.update(take_launches())
        log(f"(i3) compaction at the head ({compacted}) in {compact_s:.3f} s, "
            f"K3 launched {k3['victim_mask']}; every Range, Count and "
            f"list_batch answer equals the one before it")

        # the sink against the registries and the scanners
        want = {"kb.lease.granted.total": args.leases + n_restart,
                "kb.lease.expired.total": args.leases // 2 + n_restart,
                "kb.lease.revoked.total": len(kept),
                "kb.lease.keepalive.total": keeper.ok}
        lease_counts = {name: sink.counter(name) for name in want}
        gauges = {name: (sink.gauge(name), fn()) for name, fn in (
            ("kb.lease.active", reg.count),
            ("kb.lease.attached.keys", reg.attached_count))}
        merged = (sink.counter("kb.mirror.merge.rows.total"),
                  sum(s.merge_rows_total for s in scanners),
                  len(sink.samples("kb.mirror.merge.seconds")))
        log(f"(i) sink: lease counters {lease_counts}, gauges (sink, "
            f"registry) {gauges}; kb.mirror.merge.rows.total {merged[0]}, "
            f"the scanners' merge_rows_total {merged[1]}, "
            f"kb.mirror.merge.seconds samples {merged[2]}")
        if lease_counts != want or any(a != b for a, b in gauges.values()) \
                or merged[0] != merged[1] or merged[2] <= 0:
            raise AssertionError(f"(i) the sink disagrees with the registry "
                                 f"or the scanners: {lease_counts} against "
                                 f"{want}, {gauges}, {merged}")
        out = {"load_s": load_s, "cli_s": cli_s, "publish_s": publish_s,
               "reads": reads, "leases": expiry, "restart": {
                   "cli_s": restart_cli_s, "publish_s": restart_publish_s,
                   "boot_reap_s": boot_reap_s, "revoked": revoked},
               "compact_s": compact_s, "launches": dict(launches)}
        log(f"(i): {json.dumps(out)}")

        # (j): a follower of the leader the restart left standing
        t0 = time.perf_counter()
        followed = follower_phase(backend, args, dev)
        followed["seconds"] = time.perf_counter() - t0
        launches.update(followed.pop("launches"))
        out["follower"] = followed
        out["launches"] = dict(launches)
        return out
    finally:
        keeper.close()
        if backend is not None:
            backend.close()
        if store is not None:
            store.close()
        TRACER.metrics = None
        shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ phase j
#: phase (j)'s follower flags to the port's CLI, ``--leader-info`` and
#: ``--device`` apart: a stateless follower (docs/replication.md:28-32)
#: with its own ``cuda`` mirror over memkv and the block fan-out matcher
#: (K4), the staleness bound at the CLI's default, its own identity and
#: ports (no listener opens). ``--leader-address`` names no live server and
#: is never dialled: the replication stream and the forwarding need
#: ``grpcio``, which the card's machine lacks, so :class:`ReplicationFeed`
#: stands in for the stream
FOLLOWER_FLAGS = ("--role", "follower", "--storage", "cuda",
                  "--inner-storage", "memkv", "--tpu-fanout",
                  "--leader-address", "127.0.0.1:1",
                  "--max-staleness-ms", "5000",
                  "--identity", "127.0.0.1:2390", "--client-port", "2391",
                  "--peer-port", "2390", "--info-port", "2392")
#: the follower-local watchers on /registry/pods/ namespaces (70 broad)
FOLLOWER_WATCHERS = 1000
#: fenced (linearizable) Counts the phase needs at the least
FENCED_COUNTS = 100
#: the replication stream's progress-request cadence
#: (``FollowerConfig.progress_interval_s``)
PROGRESS_INTERVAL_S = 0.2
#: the owner the follower's scanner and matcher count their kernel launches
#: under (``ops/launch_owner.py``), apart from the leader's beside them
FOLLOWER_OWNER = "follower"
#: a serializable read refused as stale fails (j) when the follower's
#: staleness at the refusal (the age of the oldest leader event it had not
#: applied) was this much or more inside ``--max-staleness-ms``: room for
#: the gate call's own time
STALE_MARGIN_S = 0.5
FOLLOWER_KINDS = ("range", "count", "range_old", "page", "serializable")


class LeaderStatus:
    """The leader's ``/status`` on a free local port, from a stdlib
    ``ThreadingHTTPServer``, answered from the leader Backend with the keys
    of ``server/__init__.py::_status``: what the follower's fence (the
    ticketed ``HttpRevisionSyncer`` fetch) and its compaction sync read."""

    def __init__(self, backend, identity: str = "127.0.0.1:2380"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from kubebrain_tpu_torch import __version__

        status = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path != "/status":
                    self.send_error(404)
                    return
                body = json.dumps({
                    "revision": backend.current_revision(),
                    "compact_revision": backend.compact_revision(),
                    "is_leader": True, "leader": identity,
                    "identity": identity,
                    "watchers": backend.watcher_hub.watcher_count(),
                    "version": __version__}).encode()
                status.served += 1
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_args):
                pass

        self.served = 0
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.address = f"127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


class WireKV:
    __slots__ = ("key", "value", "mod_revision", "create_revision", "version")

    def __init__(self, key, value, mod_revision, create_revision, version):
        self.key, self.value = key, value
        self.mod_revision, self.create_revision = mod_revision, create_revision
        self.version = version


class WireEvent:
    """One leader event as the etcd Watch stream carries it to a follower,
    which asks for ``prev_kv``: the mapping of the port's
    ``server/etcd/shim.py::to_event`` (type 0 PUT, 1 DELETE; a PUT's
    create revision is its own for a create, else the previous revision),
    with the attributes ``ReplicaApplier.apply_wire_events`` reads."""

    __slots__ = ("type", "kv", "prev_kv")

    def __init__(self, ev: WatchEvent):
        if ev.verb == Verb.DELETE:
            self.type = 1
            self.kv = WireKV(ev.key, b"", ev.revision, 0, 0)
        else:
            self.type = 0
            self.kv = WireKV(
                ev.key, ev.value, ev.revision,
                ev.revision if ev.verb == Verb.CREATE
                else ev.prev_revision or ev.revision, 1)
        self.prev_kv = None if ev.prev_value is None else WireKV(
            ev.key, ev.prev_value, ev.prev_revision, ev.prev_revision, 1)

    def HasField(self, name: str) -> bool:  # noqa: N802 - protobuf's name
        return name == "prev_kv" and self.prev_kv is not None


class ReplicationFeed:
    """Stands in for ``ReplicationStream`` and ``WatchMux``, which need
    ``grpcio``: one leader watch of the whole keyspace from ``start`` (the
    stream's ``b""``-to-``b"\\0"`` watch with ``prev_kv``), each delivered
    block turned into :class:`WireEvent` s for
    ``ReplicaApplier.apply_wire_events`` at the block's header revision,
    and progress marks every ``PROGRESS_INTERVAL_S`` from
    ``Backend.flushed_revision`` posted through the watch's own queue, as
    the leader answers the stream's progress requests
    (docs/replication.md:53-61), each tick with the role's leader-head
    sample the stream takes beside its request. An event at or below a mark or an earlier
    event fails the feed: a mark may never run ahead of an owed event."""

    def __init__(self, leader, applier, start: int, role=None):
        self.leader, self.applier, self.role = leader, applier, role
        self.wid, self.q = leader.watch_range(b"", b"", start)
        self.last = start - 1       # highest revision applied or vouched
        self.events: list[tuple] = []
        self.commit_ts: list[float] = []  # each event's commit, monotonic
        self.lag_ms: list[float] = []
        self.lag_revs: list[int] = []
        self.apply_s = 0.0
        self.marks = 0
        self.error: BaseException | None = None
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._apply),
                        threading.Thread(target=self._tick)]
        for t in self.threads:
            t.start()

    def _apply(self) -> None:
        try:
            while not self.stop.is_set() or not self.q.empty():
                try:
                    item = self.q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is None:
                    raise AssertionError("(j) the leader dropped the "
                                         "replication watch")
                t0 = time.perf_counter()
                if isinstance(item, ProgressMarker):
                    self.applier.apply_wire_events([], item.revision)
                    self.apply_s += time.perf_counter() - t0
                    self.last = max(self.last, item.revision)
                    self.marks += 1
                    continue
                if item[0].revision <= self.last:
                    raise AssertionError(
                        f"(j) event {item[0].revision} came after revision "
                        f"{self.last} was vouched for: a progress mark ran "
                        f"ahead of an owed event")
                self.applier.apply_wire_events([WireEvent(e) for e in item],
                                               item[-1].revision)
                self.apply_s += time.perf_counter() - t0
                self.lag_ms.append((time.monotonic() - item[-1].ts) * 1e3)
                self.lag_revs.append(self.leader.current_revision()
                                     - self.applier.backend.current_revision())
                self.events.extend(event_row(e) for e in item)
                self.commit_ts.extend(e.ts for e in item)
                self.last = item[-1].revision
        except BaseException as e:  # raised by close()
            self.error = e
            self.stop.set()

    def _tick(self) -> None:
        while not self.stop.wait(PROGRESS_INTERVAL_S):
            if self.role is not None:
                self.role.sample_leader_head()
            for _ in range(50):
                rev = self.leader.flushed_revision()
                if rev >= 0:
                    break
                time.sleep(0.002)
            if rev > 0:
                self.leader.watcher_hub.post_progress(self.wid, rev)

    def close(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(timeout=60)
        self.leader.unwatch(self.wid)
        if self.error is not None:
            raise self.error
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("(j) the replication feed did not stop")


def staleness_at(feed: ReplicationFeed, t: float, applied: int) -> float:
    """Seconds, at monotonic instant ``t``, since the leader committed the
    oldest event above revision ``applied`` (0 where the follower owed
    none then), from the commit times of the events the feed applied."""
    i = bisect.bisect_right(feed.events, applied, key=lambda e: e[0])
    if i == len(feed.events) or feed.commit_ts[i] > t:
        return 0.0
    return t - feed.commit_ts[i]


def event_row(e: WatchEvent) -> tuple:
    """An event as a watcher sees it: revision, verb, key and (not for a
    delete) value."""
    return (e.revision, e.verb, e.key,
            None if e.verb == Verb.DELETE else e.value)


def range_rows(res) -> tuple:
    """A Range answer as the wire carries it: every kv's key, value and
    revision (``shim.to_kv`` sends the revision as both the create and the
    mod revision, version 1), the count and ``more``."""
    return ([(kv.key, kv.value, kv.revision) for kv in res.kvs], res.count,
            res.more)


def follower_requests(r0: int) -> dict:
    """(j)'s follower reads by client: each pod namespace's reader issues,
    ``READ_ROUNDS`` times, a Range and a Count at the follower's watermark,
    a Range at the bootstrap revision ``r0``, a ``PAGE_SIZE`` page at the
    watermark (explicit revisions, revision 0 standing for the watermark
    read when it is issued) and a serializable ``PAGE_SIZE`` page at the
    head."""
    out = {}
    for i, ns in enumerate(POD_NAMESPACES):
        s, e = ns, coder.prefix_end(ns)
        out[f"follower-{i:02d}"] = [
            ("range", (s, e, 0, 0)), ("count", (s, e, 0)),
            ("range_old", (s, e, r0, 0)), ("page", (s, e, 0, PAGE_SIZE)),
            ("serializable", (s, e, 0, PAGE_SIZE))] * READ_ROUNDS
    return out


def pod_writer(leader, sheds: collections.Counter):
    """(j)'s leader writers for :func:`watch_drive` (the Backend it passes
    is the follower's, where the watchers are): each thread a scheduler
    client of the leader's, writing create/update/delete chains of pods
    in the dataset's pod namespaces, which the follower's readers read.
    Returns the revisions of its acknowledged writes."""
    sched = leader._kb_scheduler

    def write(_backend, t: int, n_ops: int, _seed: int) -> list:
        client = f"pod-writer-{t}"
        revs: list[int] = []
        i = 0
        while len(revs) < n_ops:
            key = POD_NAMESPACES[(t + 7 * i) % len(POD_NAMESPACES)] + \
                b"pod-w%d-%05d" % (t, i)
            rev = until_admitted(lambda: sched.create(
                key, b"created-%d-%d" % (t, i), client=client), sheds,
                "create")
            revs.append(rev)
            if len(revs) < n_ops:
                rev = until_admitted(lambda: sched.update(
                    key, b"updated-%d-%d" % (t, i), rev, client=client),
                    sheds, "update")
                revs.append(rev)
            if i % 3 == 2 and len(revs) < n_ops:
                revs.append(until_admitted(lambda: sched.delete(
                    key, rev, client=client), sheds, "delete")[0])
            i += 1
        return revs

    return write


class FollowerTraffic:
    """(j)'s follower clients, started together on threads of their own
    beside the leader's writers: the namespace readers of
    :func:`follower_requests` through the follower's scheduler, each read
    admitted by the role's gate and held against the leader's answer at
    the revision the follower read (revision 0 reads resolve at the
    watermark), and one client of ``FENCED_COUNTS`` fenced (linearizable)
    Counts of all pods, each at or above the leader revision read before
    the call."""

    def __init__(self, follower, role, leader, r0: int):
        self.follower, self.role, self.leader = follower, role, leader
        self.sched = follower._kb_scheduler
        self.requests = follower_requests(r0)
        self.lat = {k: [] for k in (*FOLLOWER_KINDS, "fenced_count")}
        self.fence_wait: list[float] = []
        self.refused: collections.Counter = collections.Counter()
        #: (instant, applied revision) read just before each serializable
        #: read the gate refused as stale, and the role's own lag then (ms)
        self.stale: list[tuple[float, int, float]] = []
        self.sheds: collections.Counter = collections.Counter()
        self.wrong: list = []
        self.errors: list = []
        self.fenced = 0
        self.threads = [threading.Thread(target=self._reader, args=item)
                        for item in self.requests.items()]
        self.threads.append(threading.Thread(target=self._fenced_counts))
        for t in self.threads:
            t.start()

    def _gate(self, revision: int, serializable: bool) -> bool:
        """The role's read gate; False (counted) where it refuses."""
        t, applied = time.monotonic(), self.role.applied_revision()
        try:
            self.role.gate_read(revision, serializable)
            return True
        except ReplicaRefusedError as e:
            self.refused[e.reason] += 1
            if isinstance(e, StaleReplicaError):
                self.stale.append((t, applied, self.role.lag_seconds() * 1e3))
            return False

    def _reader(self, client: str, reqs) -> None:
        try:
            for kind, args in reqs:
                t = time.perf_counter()
                if kind == "serializable":
                    while not self._gate(0, True):
                        time.sleep(0.05)
                else:
                    rev = args[2] or self.role.applied_revision()
                    args = (*args[:2], rev, *args[3:])
                    if not self._gate(rev, False):
                        raise AssertionError(f"(j) {client}: an explicit "
                                             f"read at {rev} was refused")
                res = until_admitted(lambda: read_via(
                    self.sched, kind, args, client), self.sheds, kind)
                self.lat[kind].append(time.perf_counter() - t)
                if kind == "count":
                    got, at = res[0], res[1]
                    want = self.leader.count(*args[:2], at)[0]
                else:
                    got, at = range_rows(res), res.revision
                    want = range_rows(self.leader.list_(
                        args[0], args[1], at, args[3]))
                if got != want or (kind != "serializable" and at != args[2]):
                    self.wrong.append((client, kind, args, at))
        except BaseException as e:  # raised by close()
            self.errors.append(e)

    def _fenced_counts(self) -> None:
        try:
            while self.fenced < FENCED_COUNTS and not self.errors:
                before = self.leader.current_revision()
                t = time.perf_counter()
                if not self._gate(0, False):
                    continue
                self.fence_wait.append(time.perf_counter() - t)
                n, at = until_admitted(lambda: self.sched.count(
                    *PODS, 0, client="fenced"), self.sheds, "fenced_count")
                self.lat["fenced_count"].append(time.perf_counter() - t)
                if at < before or n != self.leader.count(*PODS, at)[0]:
                    self.wrong.append(("fenced", "count", before, at))
                self.fenced += 1
        except BaseException as e:  # raised by close()
            self.errors.append(e)

    def close(self) -> dict:
        for t in self.threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("(j) a follower client never finished")
        if self.errors:
            raise self.errors[0]
        if self.wrong:
            raise AssertionError(
                f"(j) {len(self.wrong)} follower answers differ from the "
                f"leader's at the same revision, or a fenced read came back "
                f"below the leader revision read before it; the first "
                f"{self.wrong[0]}")
        if self.fenced < FENCED_COUNTS:
            raise AssertionError(f"(j) {self.fenced} fenced Counts, not "
                                 f"{FENCED_COUNTS}")
        return {
            "requests": sum(len(v) for v in self.lat.values()),
            "p50_ms": {k: float(np.percentile(v, 50)) * 1e3
                       for k, v in self.lat.items()},
            "p99_ms": {k: float(np.percentile(v, 99)) * 1e3
                       for k, v in self.lat.items()},
            "fenced_counts": self.fenced,
            "fence_wait_p50_ms": statistics.median(self.fence_wait) * 1e3,
            "refused": dict(self.refused), "sheds": dict(self.sheds)}

    def check_stale_refusals(self, feed: ReplicationFeed) -> dict:
        """Fails where a serializable read was refused as stale while the
        follower's staleness (:func:`staleness_at`, once the feed has
        applied every leader event) was inside the bound by
        ``STALE_MARGIN_S`` or more; returns the staleness and the role's
        lag at the refusals, in ms."""
        bound_s = self.role.config.max_staleness_ms / 1e3
        lags = [staleness_at(feed, t, applied) for t, applied, _ in self.stale]
        inside = [s for s in lags if s < bound_s - STALE_MARGIN_S]
        if inside:
            raise AssertionError(
                f"(j) {len(inside)} of {len(lags)} serializable reads refused "
                f"as stale while the follower was {min(inside) * 1e3:.1f}-"
                f"{max(inside) * 1e3:.1f} ms behind the leader, inside the "
                f"{bound_s * 1e3:.0f} ms bound")
        role_ms = [r for _, _, r in self.stale]
        return {"refusals": len(lags),
                "staleness_ms": [min(lags, default=0.0) * 1e3,
                                 statistics.median(lags or [0.0]) * 1e3,
                                 max(lags, default=0.0) * 1e3],
                "role_lag_ms": [min(role_ms, default=0.0),
                                max(role_ms, default=0.0)]}


def follower_boot(leader_info: str, sink, dev) -> tuple:
    """The follower, built as the port's CLI builds one:
    ``cli.build_backend`` with ``FOLLOWER_FLAGS`` (the ``FollowerRole`` is
    its peers surface). Returns (backend, store, role, seconds)."""
    args = cli.build_parser().parse_args(
        [*FOLLOWER_FLAGS, "--leader-info", leader_info, "--device", dev.type])
    t0 = time.perf_counter()
    backend, store, role = cli.build_backend(args, metrics=sink)
    return backend, store, role, time.perf_counter() - t0


def follower_phase(leader, args, dev) -> dict:
    """(j): a follower on the card beside (i)'s leader, below the gRPC
    front. Bootstrap from one leader ``list_`` of the whole keyspace at its
    head, then the replication feed; under the leader's writers, the
    follower's namespace readers, fenced Counts and follower-local watchers
    (K4); a leader compaction the follower adopts from ``/status`` (K3).
    Every follower answer equals the leader's at the same revision, every
    watcher the oracle of the leader's events, and the follower's K1-K4
    launch."""
    sink = RecordingMetrics()
    status = LeaderStatus(leader)
    follower = fstore = role = feed = None
    sheds: collections.Counter = collections.Counter()
    launches = collections.Counter(take_launches())
    try:
        follower, fstore, role, boot_s = follower_boot(status.address, sink,
                                                       dev)
        fsc = follower.scanner
        # the follower's own launches, counted by the wrappers apart from
        # the leader's
        launch_owner.take(FOLLOWER_OWNER)
        fsc.launch_owner = FOLLOWER_OWNER
        follower.watcher_hub._fanout_matcher.launch_owner = FOLLOWER_OWNER
        owned = collections.Counter()
        applier = ReplicaApplier(follower, role=role)
        t0 = time.perf_counter()
        r0 = leader.current_revision()
        kvs = [WireKV(kv.key, kv.value, kv.revision, kv.revision, 1)
               for kv in leader.list_(b"", b"", r0).kvs]
        list_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        applier.apply_bootstrap(kvs, r0)
        apply_s = time.perf_counter() - t1
        n_boot = len(kvs)
        del kvs
        feed = ReplicationFeed(leader, applier, r0 + 1, role)
        t1 = time.perf_counter()
        fsc.publish()
        publish_s = time.perf_counter() - t1
        boot = {"keys": n_boot, "revision": r0, "list_s": list_s,
                "apply_s": apply_s, "publish_s": publish_s,
                "seconds": time.perf_counter() - t0,
                "rows": fsc._mirror.rows, "merges": fsc.merge_count,
                "builds": dict(fsc.mirror_builds), "cli_s": boot_s}
        boot["keys_per_s"] = n_boot / boot["seconds"]
        if follower.compact_revision() != r0 or \
                follower.current_revision() < r0:
            raise AssertionError(f"(j) bootstrap at {r0}: compact floor "
                                 f"{follower.compact_revision()}, watermark "
                                 f"{follower.current_revision()}")
        log(f"(j) bootstrap: the CLI's build_backend (--role follower) in "
            f"{boot_s:.3f} s; {n_boot} keys at revision {r0}: leader list_ "
            f"{list_s:.3f} s, ReplicaApplier.apply_bootstrap {apply_s:.3f} s, "
            f"the follower mirror's first publish {publish_s:.3f} s "
            f"({boot['rows']} rows, builds {boot['builds']}); "
            f"{boot['seconds']:.3f} s = {boot['keys_per_s']:.0f} keys/s, "
            f"{boot['merges']} merges")
        rebuilds = fsc.full_rebuild_total
        launches.update(take_launches())

        # the traffic: leader writers (in the watch drive), follower readers
        # and fenced Counts beside them
        head0 = follower.current_revision()
        traffic = FollowerTraffic(follower, role, leader, r0)
        try:
            drive = watch_drive(follower, FOLLOWER_WATCHERS, 70,
                                args.sched_writes, WRITER_THREADS, args.seed,
                                writer=pod_writer(leader, sheds),
                                kinds=(b"pods",), sink=sink,
                                namespaces=POD_NAMESPACE_NAMES)
        finally:
            reads = traffic.close()
        streamed = [event_row(e) for e in drive.pop("streamed")]
        leader_events = [e for e in feed.events if e[0] > head0]
        if streamed != leader_events:
            raise AssertionError(f"(j) the follower's hub streamed "
                                 f"{len(streamed)} events, not the leader's "
                                 f"{len(leader_events)} in order")
        k_traffic = take_launches()
        launches.update(k_traffic)
        log(f"(j) traffic: {drive['writes']} leader writes from "
            f"{WRITER_THREADS} threads; {reads['requests']} follower reads "
            f"and {reads['fenced_counts']} fenced Counts, every answer equal "
            f"to the leader's at the same revision; p50 ms {reads['p50_ms']}; "
            f"p99 ms {reads['p99_ms']}; fence wait p50 "
            f"{reads['fence_wait_p50_ms']:.3f} ms; refused by reason "
            f"{reads['refused']}; follower watch drive of {drive['watchers']} "
            f"watchers: {drive['events']} events, {drive['delivered']} "
            f"deliveries, every watcher equal to match_oracle over the "
            f"follower's stream, which equals the leader's")

        # the compaction the follower adopts, as the stream's compact sync
        # does: the leader's /status, then the local Backend.compact
        head = leader.current_revision()
        t0 = time.perf_counter()
        leader.compact(head)
        leader_compact_s = time.perf_counter() - t0
        launches.update(take_launches())
        role.fence()
        payload = role._syncer.fetch_status()
        compacted = int(payload["compact_revision"])
        owned.update(launch_owner.take(FOLLOWER_OWNER))
        t0 = time.perf_counter()
        follower.compact(compacted)
        compact_s = time.perf_counter() - t0
        k_compact = take_launches()
        launches.update(k_compact)
        k3 = launch_owner.take(FOLLOWER_OWNER).get("victim_mask", 0)
        owned["victim_mask"] += k3
        if compacted != head or follower.compact_revision() != head or \
                k3 != k_compact["victim_mask"]:
            raise AssertionError(f"(j) the follower adopted compaction "
                                 f"{follower.compact_revision()}, the leader "
                                 f"{head}, /status {compacted}")
        fsched = follower._kb_scheduler
        for s, e in (NS, PODS):
            for side in (leader, follower):
                try:
                    side.count(s, e, head - 1)
                except CompactedError:
                    continue
                raise AssertionError(f"(j) a read below the compaction "
                                     f"({head - 1}) served on one side")
            for rev in (head, follower.current_revision()):
                same = fsched.count(s, e, rev) == leader.count(s, e, rev)
                if (s, e) == NS:
                    same = same and range_rows(fsched.list_(s, e, rev)) == \
                        range_rows(leader.list_(s, e, rev))
                if not same:
                    raise AssertionError(f"(j) after the compaction the "
                                         f"follower's answer for {s!r} at "
                                         f"{rev} differs from the leader's")
        launches.update(take_launches())
        stayed_on_device(fsc, rebuilds, "(j) follower")
        owned.update(launch_owner.take(FOLLOWER_OWNER))
        follower_launches = {name: owned[name] for name in SOURCES}
        missing = [k for k in ("scan_mask", "scan_mask_q", "victim_mask",
                               "fanout_dispatch") if follower_launches[k] <= 0]
        if missing:
            raise AssertionError(f"(j) the follower never launched {missing}: "
                                 f"{follower_launches}")
        feed.close()
        reads["stale"] = traffic.check_stale_refusals(feed)
        apply_events = len(feed.events)
        lag_max = max(feed.lag_ms)
        out = {
            "bootstrap": boot, "reads": reads,
            "watch": {k: drive[k] for k in ("watchers", "events", "delivered",
                                            "blocks", "wall_s", "lag_p50_ms")},
            "apply": {"events": apply_events, "marks": feed.marks,
                      "seconds": feed.apply_s,
                      "events_per_s": apply_events / max(feed.apply_s, 1e-9),
                      "lag_ms_p50": statistics.median(feed.lag_ms),
                      "lag_ms_max": lag_max,
                      "lag_revs_p50": statistics.median(feed.lag_revs),
                      "lag_revs_max": max(feed.lag_revs)},
            "leader_compact_s": leader_compact_s, "compact_s": compact_s,
            "compact_revision": head, "status_served": status.served,
            "writer_sheds": dict(sheds),
            "follower_launches": follower_launches}
        log(f"(j) apply: {apply_events} events and {feed.marks} progress "
            f"marks in {feed.apply_s:.3f} s inside apply_wire_events = "
            f"{out['apply']['events_per_s']:.0f} events/s; watermark lag p50 "
            f"{out['apply']['lag_revs_p50']} / max "
            f"{out['apply']['lag_revs_max']} revisions, p50 "
            f"{out['apply']['lag_ms_p50']:.3f} / max {lag_max:.3f} ms")
        log(f"(j) compaction: leader {head} in {leader_compact_s:.3f} s, "
            f"the follower's from /status in {compact_s:.3f} s; reads below "
            f"it refused as compacted on both sides, above it equal")
        log(f"(j) {reads['stale']['refusals']} serializable reads refused as "
            f"stale, the follower then min / p50 / max "
            f"{reads['stale']['staleness_ms']} ms behind the leader (the "
            f"age of the oldest event it had not applied), the role's lag "
            f"{reads['stale']['role_lag_ms']} ms; none inside the "
            f"{role.config.max_staleness_ms:.0f} ms bound by "
            f"{STALE_MARGIN_S} s or more")
        log(f"(j) follower launches per kernel, counted by the wrappers under "
            f"the follower's owner: {follower_launches}")
        log(f"(j): {json.dumps(out)}")
        out["launches"] = dict(launches)
        return out
    finally:
        if feed is not None and not feed.stop.is_set():
            feed.stop.set()
            for t in feed.threads:
                t.join(timeout=60)
            leader.unwatch(feed.wid)
        if role is not None:
            role.close()
        if follower is not None:
            follower.close()
        if fstore is not None:
            fstore.close()
        status.close()


# ------------------------------------------------------------------ phase k
#: (k)'s cluster size: ``make bench-cluster``'s default shape
#: (``Makefile:95``, ``N ?= 1000``; docs/workloads.md)
REPLAY_NODES = 1000
#: the kernels each replay of (k) must launch; (k2) adds K4
REPLAY_KERNELS = ("scan_mask", "scan_mask_q", "victim_mask")
#: the owner (k)'s scanner and matcher count their launches under
REPLAY_OWNER = "replay"
#: the checker thread's point reads go to keys written this recently (s)
RECENT_S = 1.0
#: the checker thread's pause between two point reads (s)
POINT_READ_PAUSE_S = 0.002
#: the histogram buckets of the port's Prometheus sink (``metrics/prom.py``)
PROM_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: a key-value as the etcd client returns it
ReplayKV = collections.namedtuple("ReplayKV", "key value mod_revision")


def prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def prom_labels(tags: tuple) -> str:
    if not tags:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace("\\", "\\\\")
                                 .replace('"', '\\"')) for k, v in tags)
    return "{" + body + "}"


def prom_text(sink: RecordingMetrics) -> str:
    """``sink``'s series in the Prometheus text exposition that the port's
    Prometheus sink serves on ``/metrics`` (the names with dots as
    underscores, ``_total`` after a counter's, cumulative ``_bucket``
    series over its buckets, ``_count`` and ``_sum``), which
    ``workload.slo.parse_prom`` reads."""
    with sink.lock:
        counters = list(sink.counters.items())
        hists = [(k, list(v)) for k, v in sink.histograms.items()]
        gauges = list(sink.gauges.items()) + list(sink.gauge_fns.items())
    lines = []
    for (name, tags), v in counters:
        pname = prom_name(name)
        if not pname.endswith("_total"):
            pname += "_total"
        lines.append(f"{pname}{prom_labels(tags)} {float(v)!r}")
    for (name, tags), vs in hists:
        pname = prom_name(name)
        arr = np.sort(np.asarray(vs, dtype=np.float64))
        for le in PROM_BUCKETS:
            n = int(np.searchsorted(arr, le, side="right"))
            lines.append(f"{pname}_bucket"
                         f"{prom_labels(tags + (('le', repr(le)),))} {n}")
        lines.append(f"{pname}_bucket{prom_labels(tags + (('le', '+Inf'),))}"
                     f" {len(arr)}")
        lines.append(f"{pname}_count{prom_labels(tags)} {len(arr)}")
        lines.append(f"{pname}_sum{prom_labels(tags)} {float(arr.sum())!r}")
    for (name, tags), v in gauges:
        if callable(v):
            try:
                v = v()
            except Exception:
                continue  # a gone subject (a dropped watcher's backlog)
        lines.append(f"{prom_name(name)}{prom_labels(tags)} {float(v)!r}")
    return "\n".join(lines) + "\n"


class ReplayHistory:
    """The pod writes and head point-reads of (k) as a
    ``lincheck.History``, and the keys written in the last
    :data:`RECENT_S` seconds, which the checker thread reads."""

    def __init__(self):
        self.history = History()
        self.lock = threading.Lock()
        self.recent: collections.deque = collections.deque()

    def record(self, kind: str, key: bytes, call: float, ret: float,
               **kw) -> None:
        if not key.startswith(generator.PODS_PREFIX):
            return
        with self.lock:
            self.history.record(0, kind, key, call, ret, **kw)
            if kind != "get" and kw.get("ok"):
                self.recent.append((ret, key))

    def recent_keys(self, now: float) -> list:
        with self.lock:
            while self.recent and self.recent[0][0] < now - RECENT_S:
                self.recent.popleft()
            return [k for _t, k in self.recent]


class InProcessClient:
    """The runner's client (``EtcdCompatClient``'s methods that the runner
    calls), entering where the etcd services enter: Range, Count and Txn
    through the request scheduler the services share
    (``server/etcd/kv.py``, its lanes ``sched/lanes.py``), a single-key
    Range on ``Backend.get`` (``kv.py``'s point-read path), Compact on
    ``Backend.compact``, LeaseGrant on the lease registry. The outcomes the
    front turns into a Txn's ``succeeded = false`` come back the same way;
    the other errors are raised as the scheduler and the Backend raise
    them (the transport classifies them as the front's status codes)."""

    def __init__(self, transport: "InProcessTransport", name: str):
        self.t = transport
        self.name = name
        self.sched = transport.backend._kb_scheduler
        #: the gRPC client's transparent retries (none in process)
        self.retries_sent: dict = {}

    # ------------------------------------------------------------ writes
    def _write(self, kind: str, key: bytes, fn, value: bytes | None = None,
               prev_rev: int = 0):
        """``fn()`` with its outcome recorded in the history: ``(ok,
        revision)``, ok False on the conflicts a Txn reports as failed."""
        rec = self.t.history
        call = time.monotonic()
        kw = {"value": value} if value is not None else {}
        if kind != "create":
            kw["prev_rev"] = prev_rev
        try:
            rev = fn()
        except (KeyExistsError, CASRevisionMismatchError) as e:
            if rec is not None:
                rec.record(kind, key, call, time.monotonic(), ok=False,
                           err="conflict", conflict_rev=e.revision, **kw)
            return False, e.revision
        except KeyNotFoundError:
            if rec is not None and kind == "delete":
                rec.record(kind, key, call, time.monotonic(), ok=False,
                           err="notfound", **kw)
            return False, 0
        except (SchedResultTimeoutError, UncertainResultError):
            # dispatched, outcome unknown: either branch is legal
            if rec is not None:
                rec.record(kind, key, call, math.inf, ok=None, **kw)
            raise
        if rec is not None:
            rec.record(kind, key, call, time.monotonic(), ok=True, rev=rev,
                       **kw)
        return True, rev

    def create(self, key: bytes, value: bytes, lease: int = 0):
        return self._write("create", key, lambda: self.sched.create(
            key, value, lease=lease, client=self.name), value)

    def create_bulk(self, items, lease: int = 0, window: int = 128) -> list:
        """Concurrent creates, up to ``window`` in flight (the gRPC
        client's pipelined futures), results in input order."""
        items = list(items)
        with ThreadPoolExecutor(min(window, 64)) as pool:
            return list(pool.map(lambda kv: self.create(kv[0], kv[1], lease),
                                 items))

    def update(self, key: bytes, value: bytes, mod_revision: int,
               lease: int = 0):
        return self._write("update", key, lambda: self.sched.update(
            key, value, mod_revision, lease=lease, client=self.name),
            value, mod_revision)

    def delete(self, key: bytes, mod_revision: int = 0) -> bool:
        ok, _rev = self._write("delete", key, lambda: self.sched.delete(
            key, mod_revision, client=self.name)[0], None, mod_revision)
        return ok

    def compact(self, revision: int) -> None:
        scanner = self.t.backend.scanner
        rebuilds = scanner.full_rebuild_total
        if self.t.rebuilds is None:
            self.t.rebuilds = rebuilds
        self.t.backend.compact(revision)
        self.t.compact_rebuilds.append(scanner.full_rebuild_total - rebuilds)

    def lease_grant(self, ttl: int, lease_id: int = 0):
        lease = self.t.backend._kb_lease.grant(max(int(ttl), 1), lease_id)
        return lease.id, int(lease.granted_ttl)

    # ------------------------------------------------------------- reads
    def get(self, key: bytes, revision: int = 0):
        call = time.monotonic()
        try:
            kv = self.t.backend.get(key, revision)
        except KeyNotFoundError:
            if self.t.history is not None and not revision:
                self.t.history.record("get", key, call, time.monotonic(),
                                      ok=False)
            return None
        value = bytes(kv.value)
        if self.t.history is not None and not revision:
            self.t.history.record("get", key, call, time.monotonic(),
                                  ok=True, value=value, rev=kv.revision)
        return ReplayKV(kv.key, value, kv.revision)

    def list(self, start: bytes, end: bytes, revision: int = 0,
             limit: int = 0, page: int = 1000, stats: dict | None = None,
             serializable: bool = False):
        """Pages of ``page`` through the scheduler, each later page pinned
        to the first's revision, as the gRPC client pages."""
        out, key, list_rev = [], start, revision
        while True:
            want = min(page, limit - len(out)) if limit else page
            if stats is not None:
                stats["rpcs"] = stats.get("rpcs", 0) + 1
            res = self.sched.list_(key, end, list_rev, want, client=self.name)
            if list_rev == 0:
                list_rev = res.revision
            out.extend(ReplayKV(kv.key, bytes(kv.value), kv.revision)
                       for kv in res.kvs)
            if not res.more or (limit and len(out) >= limit):
                return out, list_rev
            key = res.kvs[-1].key + b"\x00"

    def list_unpaged(self, start: bytes, end: bytes, revision: int = 0,
                     serializable: bool = False):
        res = self.sched.list_(start, end, revision, 0, client=self.name)
        return ([ReplayKV(kv.key, bytes(kv.value), kv.revision)
                 for kv in res.kvs], res.revision)

    def count(self, start: bytes, end: bytes,
              serializable: bool = False) -> int:
        return self.sched.count(start, end, 0, client=self.name)[0]

    def current_revision(self) -> int:
        return self.t.backend.current_revision()

    def close(self) -> None:
        pass


class ReplayWatch:
    """One watch of the in-process ``WatchMux``: its range, start revision,
    delivered revisions and whether the hub dropped it."""

    __slots__ = ("key", "range_end", "start_revision", "wid", "events",
                 "revisions", "cancelled", "broad")

    def __init__(self, key, range_end, start_revision, broad=False):
        self.key, self.range_end = key, range_end
        self.start_revision = start_revision
        self.wid = -1
        self.events = 0
        self.revisions: list[int] = []
        self.cancelled = False
        self.broad = broad


class InProcessWatchMux:
    """The runner's ``WatchMux`` over ``Backend.watch_range`` (what the
    etcd Watch service calls): each watch's queue, a :class:`NotifyingQueue`
    of the hub's bounded size (so the hub's slow-consumer drop applies),
    drained by one of ``streams`` consumer threads that counts and records
    the delivered revisions. A watch the hub drops is cancelled, as the
    Watch service cancels it."""

    def __init__(self, backend, streams: int):
        self.backend = backend
        self._readies = [collections.deque() for _ in range(streams)]
        self._all: list[ReplayWatch] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._threads = [threading.Thread(target=self._consume, args=(r,),
                                          daemon=True, name="kb-wl-watch")
                         for r in self._readies]
        for t in self._threads:
            t.start()

    def add(self, key: bytes, range_end: bytes = b"", start_revision: int = 0,
            shard: int | None = None, timeout: float = 30.0,
            broad: bool = False) -> ReplayWatch:
        w = ReplayWatch(key, range_end, start_revision, broad)
        with self._lock:
            i = len(self._all) if shard is None else shard
            ready = self._readies[i % len(self._readies)]
            self._all.append(w)

        def factory(maxsize):
            q = NotifyingQueue(maxsize, ready)
            q.watch = w
            return q

        try:
            w.wid, _q = self.backend.watch_range(key, range_end,
                                                 start_revision,
                                                 queue_factory=factory)
        except WatchExpiredError:
            w.cancelled = True  # below the compaction: the client re-lists
        return w

    def _consume(self, ready) -> None:
        while True:
            try:
                q = ready.popleft()
            except IndexError:
                if self._done.is_set() and not ready:
                    return
                time.sleep(0.002)
                continue
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    q.watch.cancelled = True
                elif not isinstance(item, ProgressMarker):
                    q.watch.events += len(item)
                    q.watch.revisions.extend(e.revision for e in item)

    def watchers(self) -> list:
        with self._lock:
            return list(self._all)

    def total_events(self) -> int:
        return sum(w.events for w in self.watchers())

    def cancelled_count(self) -> int:
        return sum(1 for w in self.watchers() if w.cancelled)

    def resumed_total(self) -> int:
        return 0  # no stream to reset in process

    def close(self) -> None:
        """Stops once every dealt revision has been streamed and drained."""
        deadline = time.monotonic() + 60
        while self.backend.flushed_revision() < \
                self.backend.current_revision() \
                or any(self._readies):
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        self._done.set()
        for t in self._threads:
            t.join(timeout=60)
        for w in self.watchers():
            if w.wid >= 0 and not w.cancelled:
                self.backend.unwatch(w.wid)


class InProcessLeaseMux:
    """The runner's ``LeaseMux``: each keepalive admitted on the SYSTEM lane
    as the Lease service's ``keepalive_one`` admits it
    (``server/etcd/misc.py``), from ``streams`` threads; TTL 0 is the etcd
    encoding of an expired lease."""

    def __init__(self, backend, streams: int):
        self.backend = backend
        self.sent = self.acked = self.expired_acks = self.shed = 0
        self._lock = threading.Lock()
        self._qs = [queue.Queue() for _ in range(streams)]
        self._threads = [threading.Thread(target=self._run, args=(q,),
                                          daemon=True, name="kb-wl-lease")
                         for q in self._qs]
        for t in self._threads:
            t.start()

    def keepalive_async(self, lease_id: int, shard: int = 0,
                        on_ack=None) -> bool:
        with self._lock:
            self.sent += 1
        self._qs[shard % len(self._qs)].put((lease_id, on_ack,
                                             time.monotonic()))
        return True

    def _run(self, q) -> None:
        reg, sched = self.backend._kb_lease, self.backend._kb_scheduler
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                lid, on_ack, t0 = item
                try:
                    ttl = sched.submit(lambda: reg.keepalive(lid),
                                       lane=Lane.SYSTEM,
                                       client="lease-keepalive")
                except SchedOverloadError:
                    with self._lock:
                        self.shed += 1
                    continue
                with self._lock:
                    self.acked += 1
                    self.expired_acks += ttl <= 0
                if on_ack is not None:
                    on_ack(time.monotonic() - t0, ttl)
            finally:
                q.task_done()

    def flush(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while any(q.unfinished_tasks for q in self._qs):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def close(self) -> None:
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join(timeout=30)


class InProcessTransport:
    """The workload runner's transport into one Backend of this process,
    in place of the spawned servers and the gRPC front, which need
    ``grpcio`` (the card's machine has none). Its scrape renders the
    :class:`RecordingMetrics` sink the CLI wired as the metrics. It counts
    no RPCs, so the report names the RPC-count reconcile as not
    applicable. The watch multiplexer it hands out registers
    ``broad`` whole-``/registry/pods/`` watchers first, from the next
    revision."""

    in_process = True
    #: the errors a gRPC call would raise as a status code
    rpc_errors = (SchedOverloadError, UncertainResultError, StorageError,
                  LeaseNotFoundError, FutureRevisionError, CompactedError)

    def __init__(self, backend, sink: RecordingMetrics, device: str,
                 history: ReplayHistory | None = None, broad: int = 0):
        self.backend = backend
        self.sink = sink
        self.device = device
        self.history = history
        self.broad = broad
        self.clients = 0
        #: full rebuilds from the store that each compaction caused, and
        #: ``full_rebuild_total`` as the first compaction began
        self.compact_rebuilds: list[int] = []
        self.rebuilds: int | None = None
        self.muxes: list[InProcessWatchMux] = []

    def client(self, target, **_kw) -> InProcessClient:
        self.clients += 1
        return InProcessClient(self, f"replay-{self.clients}")

    def watch_mux(self, client, streams: int, resume: bool):
        mux = InProcessWatchMux(self.backend, streams)
        rev = self.backend.current_revision() + 1
        for i in range(self.broad):
            mux.add(generator.PODS_PREFIX,
                    coder.prefix_end(generator.PODS_PREFIX), rev, shard=i,
                    broad=True)
        self.muxes.append(mux)
        return mux

    def lease_mux(self, client, streams: int):
        return InProcessLeaseMux(self.backend, streams)

    def is_shed(self, e: BaseException) -> bool:
        return (isinstance(e, SchedOverloadError)
                and not isinstance(e, SchedResultTimeoutError))

    def classify(self, e: BaseException, write: bool) -> str:
        if isinstance(e, (SchedResultTimeoutError, UncertainResultError)):
            return "ambiguous"
        return "safe"

    def describe(self, e: BaseException) -> str:
        return f"{type(e).__name__}: {e}"

    def scrape(self, host: str, info_port: int):
        return slo.parse_prom(prom_text(self.sink))


def point_reader(transport: InProcessTransport, stop: threading.Event,
                 seed: int) -> None:
    """The checker thread: head point-reads, each of a key written in the
    last :data:`RECENT_S` seconds, into the history."""
    client = transport.client("in-process")
    rng = random.Random(seed)
    while not stop.wait(POINT_READ_PAUSE_S):
        keys = transport.history.recent_keys(time.monotonic())
        if keys:
            client.get(keys[rng.randrange(len(keys))])


def check_replay_watches(mux: InProcessWatchMux, events: list) -> dict:
    """Every watch's delivered revisions against ``match_oracle`` over the
    hub's event stream from its start revision: none dropped, none
    missing, none extra, in revision order."""
    revs = np.array([e.revision for e in events], dtype=np.int64)
    if (np.diff(revs) <= 0).any():
        raise AssertionError("(k) the hub streamed events out of revision "
                             "order")
    watches = mux.watchers()
    ranges = sorted({(w.key, w.range_end) for w in watches})
    col = {r: j for j, r in enumerate(ranges)}
    mask = match_oracle(events, [(j, s, e, 0)
                                 for j, (s, e) in enumerate(ranges)])
    delivered = 0
    for w in watches:
        if w.cancelled:
            raise AssertionError(f"(k) watch [{w.key!r}, {w.range_end!r}) "
                                 f"from {w.start_revision} was cancelled")
        want = revs[mask[:, col[(w.key, w.range_end)]]
                    & (revs >= w.start_revision)]
        if w.revisions != want.tolist():
            raise AssertionError(
                f"(k) watch [{w.key!r}, {w.range_end!r}) from "
                f"{w.start_revision}: {len(w.revisions)} events, the oracle "
                f"{len(want)}")
        delivered += len(want)
    return {"watchers": len(watches),
            "broad": sum(1 for w in watches if w.broad),
            "events": len(events), "delivered": delivered}


def replay_broad(spec: WorkloadSpec) -> int:
    """The fewest whole-``/registry/pods/`` watchers that, beside every
    controller watch of ``spec`` (one namespace prefix each), make the
    hub's interval index over them dense (``_RangeIndex.dense``), so that
    the hub routes every block to the CUDA matcher, K4. Without them it
    serves ``for_cluster``'s informers from the index: its blocks (at most
    a few dozen events x 1,000 watchers) stay under the
    ``WatcherHub.DEVICE_PAIRS`` from which a CUDA matcher takes one."""
    n = spec.nodes * spec.controllers_per_node
    filters = {}
    for w in range(n):
        prefix = generator.PODS_PREFIX + generator.ns_name(
            w % spec.namespaces) + b"/"
        filters[w] = (prefix, coder.prefix_end(prefix), 0)
    broad = (generator.PODS_PREFIX, coder.prefix_end(generator.PODS_PREFIX),
             0)
    for b in itertools.count():
        if _RangeIndex(filters).dense:
            return b
        filters[n + b] = broad


def replay_summary(report: dict) -> dict:
    """What (k) prints of the report: ops/s, p50 and p99 per lane and per
    op kind, sheds, the pacer's largest dispatch lag, write-group and
    query-batch sizes."""
    sched = report["sched"]
    return {
        "ops_per_sec": report["replay"]["ops_per_sec"],
        "wall_s": report["replay"]["wall_s"],
        "preload_wall_s": report["replay"]["preload_wall_s"],
        "max_dispatch_lag_s": report["replay"]["max_dispatch_lag_s"],
        "lanes": {lane: {k: s[k] for k in ("count", "p50_ms", "p99_ms",
                                            "shed", "errors")}
                  for lane, s in report["lanes"].items()},
        "op_kinds": {kind: {k: s[k] for k in ("count", "ok", "p50_ms",
                                               "p99_ms", "shed", "errors",
                                               "conflicts", "skipped")}
                     for kind, s in report["op_kinds"].items()},
        "sheds": sched["shed_total"],
        "query_batches": sched["batched_launches"],
        "query_batch_mean": (sched["batched_requests"]
                             / max(sched["batched_launches"], 1)),
        "write_groups": sched["write_batched_groups"],
        "write_group_mean": (sched["write_batched_ops"]
                             / max(sched["write_batched_groups"], 1)),
        "watch": {k: report["watch"][k] for k in ("watchers", "events",
                                                  "cancelled",
                                                  "lag_queue_p99_s")},
        "compact": {k: report["compact"][k] for k in ("completed", "phases",
                                                      "full_rebuilds")},
    }


def replay_run(spec: WorkloadSpec, dev, seed: int, broad: int,
               kernels: tuple, label: str) -> dict:
    """One replay of (k): ``spec`` replayed by the port's workload runner
    on a fresh native store of its own, booted by ``cli.build_backend``
    with ``CLI_FLAGS``, through an :class:`InProcessTransport` (the one
    cut: no gRPC on the card) that registers ``broad``
    whole-``/registry/pods/`` watchers beside the workload's.

    It fails unless: the schedule regenerates to the same sha256 (the
    runner's self-check); the runner's acknowledged-write check, over the
    quiescent store, finds every acknowledged pod write at its revision, no
    definite-failure key present and no ghost; the ``lincheck`` history of
    every pod create, update and delete and the checker thread's head
    point-reads is linearizable within its budget; every watch's events
    equal ``match_oracle`` over the hub's stream from its start revision
    (none cancelled) and no lease expired while kept alive; a compaction
    completed and moved no full rebuild; the report's correctness bounds
    of ``slo.evaluate`` hold (``min_batched_requests`` among them, so the
    relist storms reached K2 as query batches); each kernel of
    ``kernels`` launched under (k)'s owner; and no off-device counter
    moved. The latency and shed bounds of ``slo.evaluate`` are printed
    with their limits and not held: the host sets them (PERF.md §5)."""
    d = data_dir("replay")
    sink = RecordingMetrics()
    take_launches()
    launch_owner.take(REPLAY_OWNER)
    backend, store, _peers = cli.build_backend(cli_args(d, dev), metrics=sink)
    history = ReplayHistory()
    stop = threading.Event()
    reader = None
    hub = backend.watcher_hub
    streamed: list = []
    try:
        backend.scanner.launch_owner = REPLAY_OWNER
        hub._fanout_matcher.launch_owner = REPLAY_OWNER
        orig_stream = hub.stream

        def recording(batch):
            orig_stream(batch)
            streamed.append(list(batch))

        hub.stream = recording
        transport = InProcessTransport(backend, sink, dev.type, history,
                                       broad=broad)
        reader = threading.Thread(target=point_reader,
                                  args=(transport, stop, seed),
                                  daemon=True)
        reader.start()
        runner = WorkloadRunner(spec, write_report=False, transport=transport)
        t0 = time.perf_counter()
        report = runner.run()
        replay_s = time.perf_counter() - t0
        stop.set()
        reader.join(timeout=60)
        del hub.stream
        events = [e for b in streamed for e in b]
        launches = take_launches()
        owned = launch_owner.take(REPLAY_OWNER)

        consistency = runner._consistency_check(report["replay"]["drained"])
        t1 = time.perf_counter()
        lin = history.history.check()
        lin_s = time.perf_counter() - t1
        watch = check_replay_watches(transport.muxes[0], events)
        passed, violations = report["slo"]["pass"], report["slo"]["violations"]
        held = [v for v in violations
                if not v.startswith(("lane ", "shed rate"))]
        summary = replay_summary(report)
        out = {"spec": {"nodes": spec.nodes, "seed": spec.seed,
                        "sha256": report["trace"]["sha256"],
                        "ops": report["trace"]["ops"]},
               "replay_s": replay_s,
               "summary": summary,
               "reconcile": report["reconcile"],
               "consistency": {k: consistency[k] for k in (
                   "ok", "checked_keys", "acked_live", "acked_deleted",
                   "ambiguous", "definite_failures", "scanned")},
               "lincheck": {k: lin.get(k) for k in (
                   "ok", "ops", "keys", "nodes_searched", "max_key_nodes",
                   "violation")} | {"seconds": lin_s},
               "watch": watch,
               "blocks": {"count": len(streamed),
                          "max_events": max(map(len, streamed), default=0)},
               "rebuilds": {"in_compactions": transport.compact_rebuilds,
                            "at_first_compaction": transport.rebuilds,
                            "total": backend.scanner.full_rebuild_total},
               "slo": {"pass": passed, "violations": violations,
                       "bounds": report["slo"]["bounds"]},
               "launches": launches, "owner_launches": owned}
        log(f"{label}: {json.dumps(out)}")
        if report["trace"]["sha256"] != generator.generate(spec).sha256() \
                or not report["trace"]["determinism_checked"]:
            raise AssertionError(f"{label} the schedule did not regenerate to the "
                                 "same sha256")
        if not consistency["ok"]:
            raise AssertionError(
                f"{label} acknowledged-write check failed: losses "
                f"{consistency['losses']}, ghosts {consistency['ghosts']}, "
                f"revision mismatches {consistency['rev_mismatches']}")
        if not lin["ok"] or lin.get("truncated") or lin.get("truncated_keys"):
            raise AssertionError(f"{label} the history is not linearizable: "
                                 f"{lin.get('violation')}")
        if report["watch"]["cancelled"] or \
                report["leases"]["metrics"]["expired_delta"]:
            raise AssertionError(
                f"{label} {report['watch']['cancelled']} watchers cancelled, "
                f"{report['leases']['metrics']['expired_delta']} leases "
                f"expired while kept alive")
        # the mirror booted on the empty store is rebuilt from the store
        # when rows outgrow its key dictionary: the preload's pods, then the
        # node-lease directory, which the replay's first writes open; from
        # the first compaction on, full_rebuild_total must not move
        rebuilds = transport.rebuilds
        if report["op_kinds"].get("COMPACT", {}).get("ok", 0) < 1 or \
                rebuilds is None or \
                backend.scanner.full_rebuild_total != rebuilds:
            raise AssertionError(
                f"{label} no compaction completed, or the mirror was rebuilt "
                f"from the store from the first compaction on: "
                f"{transport.compact_rebuilds} in the compactions, "
                f"full_rebuild_total {backend.scanner.full_rebuild_total} "
                f"against {rebuilds} as the first began")
        if held:
            raise AssertionError(f"{label} correctness bounds of the SLO report "
                                 f"failed: {held}")
        missing = [k for k in kernels if owned.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{label} never launched {missing} under its "
                                 f"owner: {owned}")
        stayed_on_device(backend.scanner, rebuilds, label)
        log(f"{label} the latency and shed bounds (held by the host, not "
            f"gated): {'met' if passed else violations}; limits "
            f"{report['slo']['bounds']}")
        return out
    finally:
        stop.set()
        if reader is not None:
            reader.join(timeout=60)
        backend.close()
        store.close()
        TRACER.metrics = None
        shutil.rmtree(d, ignore_errors=True)


def replay_phase(args, dev, spec=None) -> dict:
    """(k): the kube-apiserver traffic mix of
    ``WorkloadSpec.for_cluster(REPLAY_NODES, seed=--seed)`` (``spec``
    replaces it) replayed twice, each time on a fresh store and held to
    every check of :func:`replay_run`: (k1) unchanged, where K1, K2 and
    K3 must launch (the hub serves the informers from its interval index,
    so K4 does not run), then (k2) beside the fewest
    whole-``/registry/pods/`` watchers that route the hub's blocks to the
    CUDA matcher (:func:`replay_broad`), where K4 must launch too."""
    if spec is None:
        spec = WorkloadSpec.for_cluster(REPLAY_NODES, seed=args.seed)
    t0 = time.perf_counter()
    generator.generate(spec)
    host_s = time.perf_counter() - t0
    log(f"(k) host speed: generate(WorkloadSpec(nodes={spec.nodes})) in "
        f"{host_s:.3f} s")
    cluster = replay_run(spec, dev, args.seed, 0, REPLAY_KERNELS, "(k1)")
    broad = replay_broad(spec)
    cohort = replay_run(spec, dev, args.seed, broad,
                        REPLAY_KERNELS + ("fanout_dispatch",), "(k2)")
    launches = collections.Counter(cluster["launches"])
    launches.update(cohort["launches"])
    owned = collections.Counter(cluster["owner_launches"])
    owned.update(cohort["owner_launches"])
    return {"host_generate_s": host_s, "cluster": cluster, "broad": cohort,
            "launches": dict(launches), "owner_launches": dict(owned)}


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
    ap.add_argument("--sched-writes", type=int, default=4000,
                    help="(i2): writes from 8 threads beside the reads")
    ap.add_argument("--leases", type=int, default=100,
                    help="(i3): leases of 100 Event keys, half kept alive")
    ap.add_argument("--watch-ab", metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.watch_ab:
        return watch_ab(args)

    dev = resolve_device(CARD)

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

    t_side = time.perf_counter()
    side = SidePhases(args)
    sched = SidePhases(args, "sched_phases", "phases (i), (j) and (k)")
    try:
        t0 = time.perf_counter()
        store, top = load_store(args.keys, args.seed, dev)
        backend = Backend(store, BackendConfig(
            fanout_matcher=DeviceFanout(device=dev)))
        try:
            launches, main_cases = serve_phase(backend, store, top, dev)
            seconds["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            programs_phase(backend, store, top, args.keys, args.seed, dev, smi)
            seconds["n"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            meshed = mesh_phase(backend, store, top, args, dev)
            seconds["l"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            compacted = compact_phase(backend, store, top, args.keys, dev)
            seconds["e"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fanned = fanout_phase(backend, dev, args)
            seconds["f"] = time.perf_counter() - t0
        finally:
            backend.close()
            store.close()
        side_out = side.result()
        served = sched.result()
    finally:
        side.close()
        sched.close()
    seconds.update(side_out["seconds"])
    seconds.update(served["seconds"])
    seconds["c-k, three processes"] = time.perf_counter() - t_side
    log(f"phase seconds: {json.dumps(seconds)}")
    launches["victim_mask"] = compacted["launches"]
    main_cases["victim_mask"] = compacted["case"]
    launches.update(fanned["watch"]["launches"])
    # the launches of the deployed engines', the chaos, (i)'s, (j)'s and
    # (k)'s paths
    for name, n in itertools.chain(side_out["launches"].items(),
                                   served["launches"].items()):
        launches[name] = launches.get(name, 0) + n
    main_cases.update(fanned["watch"]["cases"])
    errs = {name: [v["max_abs_err"] for (n, _l), v in bench.items() if n == name]
            for name in ("scan_mask", "scan_mask_q")}
    errs["victim_mask"] = [v["max_abs_err"] for v in victim_bench.values()]
    for name in ("fanout_dispatch", "fanout_mask_range"):
        errs[name] = [v["max_abs_err"] for (n, _c), v in
                      fanned["cases"].items() if n == name]

    follower_launches = served["follower_launches"]
    replay_launches = served["replay_launches"]
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
            "follower_launches": follower_launches[name],
            "replay_launches": replay_launches.get(name, 0),
            "mesh_launches": meshed["launches"][name],
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
