#!/usr/bin/env python3
"""Drive kubebrain_tpu_torch on one CUDA card and check every result.

    python3 chip_smoke.py [--seed 0] [--keys 1000000]
                          [--kernel-keys 200000] [--kernel-revs 100]

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

Each measured kernel case prints its time per call over many launches back
to back between one pair of CUDA events (the host's side of each call
included where it is the longer), its device time from ``torch.profiler``
with the L2 cache flushed before each call, the plain version's time, its
bound (the valid rows inside the queries' ranges for K1/K2, inside the
compaction's [start, end) for K3) and the full-scan bound of every valid
row.

Output, last three lines: the kernels JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kubebrain_tpu_torch import _build, coder
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.common import LAST_REV_KEY, TOMBSTONE
from kubebrain_tpu_torch.backend.scanner import EVENTS_TTL_SECONDS, Scanner
from kubebrain_tpu_torch.device import TRANSFER_METER, resolve_device
from kubebrain_tpu_torch.ops import compact, compact_kernels, scan, scan_kernels
from kubebrain_tpu_torch.ops import keys as keyops
from kubebrain_tpu_torch.ops.scan import flip_sign
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.cuda.encode import build_encoding
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
}
REPLACES = {
    "scan_mask": "kubebrain_tpu/ops/scan_pallas.py:175",
    "scan_mask_q": "kubebrain_tpu/ops/scan_pallas.py:222",
    "victim_mask": "kubebrain_tpu/ops/compact_pallas.py:122",
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


def device_ms(fn, kernels: tuple[str, ...], reps: int) -> float | None:
    """Device time per call of ``fn`` of the CUDA kernels whose names
    contain one of ``kernels``, from ``torch.profiler``, with the L2 cache
    flushed before every call (a request finds the mirror cold): the
    kernels' own duration without the host's side of the call. None where
    the profiler records no device time for them."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if any(k in ev.key for k in kernels))
    return total / reps / 1e3 if total else None


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

    def __init__(self, name, kernel, plain, bound, bound_full, kernels):
        self.name = name
        self.kernel = kernel
        self.plain = plain
        self.bound = bound
        self.bound_full = bound_full
        self.kernels = kernels  # CUDA kernel names the profiler reports

    def check(self) -> int:
        """Max |kernel - plain| over every output (must be 0)."""
        got = self.kernel()
        torch.cuda.synchronize()
        want = self.plain()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{self.name}: kernel disagrees with plain "
                                 f"(max abs err {err})")
        return err

    def measure(self, reps: int) -> dict:
        b, by = self.bound()
        return {"ms": time_ms(self.kernel, reps),
                "device_ms": device_ms(self.kernel, self.kernels, reps),
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
            f"device {m['device_ms']} ms (plain {m['plain_ms']} ms, bound "
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


def load_store(n_keys: int, seed: int, dev):
    """A cuda store over memkv, without engine TTL (so /events/ rows expire
    through the compaction history), loaded with :func:`kube_dataset`
    through the untracked inner engine. Returns (store, top revision)."""
    t0 = time.perf_counter()
    rows, top = kube_dataset(n_keys, seed)
    store = new_storage("cuda", inner="memkv", device=dev, ttl_supported=False)
    inner = store.untracked()
    for b0 in range(0, len(rows), 1024):
        bw = inner.begin_batch_write()
        for k, v in rows[b0 : b0 + 1024]:
            bw.put(k, v)
        bw.commit()
    bw = inner.begin_batch_write()
    bw.put(LAST_REV_KEY, coder.encode_rev_value(top))
    bw.commit()
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
        if backend.current_revision() != top:
            raise AssertionError("backend did not recover the top revision")

        lat: dict[str, list[float]] = {}

        def timed(kind, fn):
            t = time.perf_counter()
            out = fn()
            lat.setdefault(kind, []).append(time.perf_counter() - t)
            return out

        ns = (b"/registry/pods/ns05/", b"/registry/pods/ns050")
        pods = (b"/registry/pods/", b"/registry/pods0")
        old = top // 2
        batch = [
            ("list", b"/registry/pods/ns01/", b"/registry/pods/ns010", 0, 0),
            ("list", b"/registry/pods/ns02/", b"/registry/pods/ns020", old, 0),
            ("count", b"/registry/pods/", b"/registry/pods0", 0),
            ("list", b"/events/ns03/", b"/events/ns030", 0, 0),
            ("list", b"/registry/pods/ns31/pod-0001", b"/registry/pods/ns31/pod-0005", 0, 0),
            ("count", b"/events/", b"/events0", old),
            ("list", b"/registry/pods/ns07/", b"/registry/pods/ns070", top // 3, 0),
            ("list", b"/registry/pods/ns09/pod-", b"", 0, 0),
        ]
        TRANSFER_METER.bytes = TRANSFER_METER.pulls = 0
        scan_kernels.reset_launch_counts()
        reps = 3
        for _ in range(reps):
            r_ns = timed("range_namespace", lambda: backend.list_(*ns))
            r_all = timed("range_all_pods", lambda: backend.list_(*pods))
            r_cnt = timed("count", lambda: backend.count(*pods))
            r_old = timed("range_old_revision",
                          lambda: backend.list_(*ns, revision=old))
            r_batch = timed("list_batch_8", lambda: backend.list_batch(batch))
        # writes, then reads through the delta overlay
        k_new = b"/registry/pods/ns05/pod-new"
        backend.create(k_new, b"fresh")
        k_upd = next(kv for kv in r_ns.kvs)
        backend.update(k_upd.key, b"updated", k_upd.revision)
        backend.delete(r_ns.kvs[1].key)
        for _ in range(reps):
            r_ovl = timed("range_overlay", lambda: backend.list_(*ns))
            c_ovl = timed("count_overlay", lambda: backend.count(*pods))
        launches = {"scan_mask": scan_kernels.visibility_mask_batch.launches,
                    "scan_mask_q": scan_kernels.visibility_mask_batch_q.launches}
        moved = TRANSFER_METER.snapshot()

        head = backend.current_revision()
        same_kvs(r_ns.kvs, oracle.range_(*ns, top)[0], "namespace range")
        same_kvs(r_all.kvs, oracle.range_(*pods, top)[0], "pods range")
        if r_cnt[0] != oracle.count(*pods, top):
            raise AssertionError("count differs from the host scanner")
        same_kvs(r_old.kvs, oracle.range_(*ns, old)[0], "old-revision range")
        check_batch(batch, r_batch, oracle, top)
        same_kvs(r_ovl.kvs, oracle.range_(*ns, head)[0], "overlay range")
        if c_ovl[0] != oracle.count(*pods, head):
            raise AssertionError("overlay count differs from the host scanner")
        log(f"main path: every response equals the host scanner "
            f"(pods range {len(r_all.kvs)} kvs, count {r_cnt[0]}, "
            f"overlay count {c_ovl[0]})")
        for kind, ts in lat.items():
            log(f"p50 {kind}: {statistics.median(ts) * 1e3:.3f} ms "
                f"over {len(ts)} requests")
        log(f"main path launches: K1 {launches['scan_mask']}, "
            f"K2 {launches['scan_mask_q']}; device->host {moved[0]} bytes "
            f"in {moved[1]} pulls")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")

        # where one Range's time goes, stage by stage (host clock)
        scanner = backend.scanner
        mirror = scanner._mirror
        for label, (s, e) in (("namespace", ns), ("all pods", pods)):
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
                ("scan_mask", [(ns[0], ns[1], head)]),
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
                mirror.encoding, mirror.key_width, [(pods[0], pods[1], head)],
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


def compact_phase(backend, store, top: int, n_keys: int, dev) -> dict:
    """(e): Backend.compact on the main path against the host scanner's
    compaction of a twin store."""
    scanner = backend.scanner
    inner = store.untracked()
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
    twin = new_storage("memkv", ttl_supported=False)
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
    log(f"compact: twin memkv filled from a dump in "
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
            log(f"compact [device, {s.mirror_path}]: scanned {s.scanned}, "
                f"survivors {s.survivor_rows}, dirty partitions "
                f"{s.dirty_partitions}, phases " + ", ".join(
                    f"{k} {v} s" for k, v in s.phase_seconds.items()))
        log(f"compact: device path {dev_wall} s, host scanner on the twin "
            f"{host_wall} s; victims (versions, tombstones, rev records, "
            f"ttl) device {victim_totals(dev_stats)}, host "
            f"{victim_totals(host_stats)}; K3 launches {launches}")
        if done != compact_rev or host_done != compact_rev:
            raise AssertionError(f"compacted to {done}/{host_done}, "
                                 f"not {compact_rev}")
        if victim_totals(dev_stats) != victim_totals(host_stats):
            raise AssertionError("CompactStats victim fields differ")
        if victim_totals(dev_stats)[3] <= 0:
            raise AssertionError("no /events/ row expired by TTL")
        n_rows = same_store(inner, twin)
        counts = (inner.version_count(), twin.version_count())
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
        log(f"compact: store dumps equal ({n_rows} rows), version_count "
            f"{counts[0]} on both")

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
        log("compact: every Range, Count and list_batch after compaction "
            "equals the host scanner")

        # K3 against the plain version on the main path's own inputs
        args = scanner._victim_args(*marked[0])
        m = victim_checks(args, measure_reps=50)
        p, c, n = args[0].shape
        log(describe("victim_mask", f"main path mirror, P={p}, C={c}, N={n}, "
                     f"{m['victims']} victims", m))
        stayed_on_device(scanner, rebuilds, "compact")
        return {"launches": launches, "case": m}
    finally:
        oracle.close()
        twin_backend.close()
        twin.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--kernel-keys", type=int, default=200_000)
    ap.add_argument("--kernel-revs", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    dev = resolve_device()

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        log(f"ptxas [{name}]:\n{text.strip()}")
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    layouts = bench_layouts(args.kernel_keys)
    bench = kernel_phase(layouts, args.kernel_revs, dev)
    victim_bench = victim_phase(layouts, args.kernel_revs, dev)
    del layouts

    store, top = load_store(args.keys, args.seed, dev)
    backend = Backend(store, BackendConfig())
    try:
        launches, main_cases = serve_phase(backend, store, top, dev)
        compacted = compact_phase(backend, store, top, args.keys, dev)
    finally:
        backend.close()
        store.close()
    launches["victim_mask"] = compacted["launches"]
    main_cases["victim_mask"] = compacted["case"]
    errs = {name: [v["max_abs_err"] for (n, _l), v in bench.items() if n == name]
            for name in ("scan_mask", "scan_mask_q")}
    errs["victim_mask"] = [v["max_abs_err"] for v in victim_bench.values()]

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
