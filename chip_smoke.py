#!/usr/bin/env python3
"""Drive kubebrain_tpu_torch on one CUDA card and check every result.

    python3 chip_smoke.py [--seed 0] [--keys 1000000]
                          [--kernel-keys 200000] [--kernel-revs 100]

Phases (any failure exits non-zero and prints no result line):

(a) build: compile every ``kubebrain_tpu_torch/csrc/*.cu`` with nvcc (one
    process per source, started together) and print the build seconds, the
    ptxas report and the card's name and power limit.
(b) kernels at the scan bench shape: a synthetic mirror of ``--kernel-keys``
    keys × ``--kernel-revs`` revisions (20M version rows by default), raw
    128-byte keys and the same rows encoded. K1 (one ``/registry/pods/``
    query at a mid-history revision) and K2 (8 distinct prefix/revision
    queries) must give masks and counts bit-identical to the plain PyTorch
    version; kernel, plain and bound times are printed.
(c) main path: ``--keys`` kube-shaped user keys (version chains, tombstones,
    256–2047-byte values) loaded into memkv, served by
    ``Backend(new_storage("cuda", inner=...))``: per-namespace Range, full
    ``/registry/pods/`` Range, Count, a Range at an older revision, one
    ``list_batch`` of 8 queries (K2), and writes read back through the delta
    overlay. Every response must equal the generic host ``Scanner`` over the
    same store, byte for byte. K1 and K2 launches are counted over this
    phase and must both be > 0; then both kernels are held against the plain
    version at the mirror's own shape.

Output, last three lines: the kernels JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
from kubebrain_tpu_torch.backend.scanner import Scanner
from kubebrain_tpu_torch.device import TRANSFER_METER, resolve_device
from kubebrain_tpu_torch.ops import keys as keyops
from kubebrain_tpu_torch.ops import scan, scan_kernels
from kubebrain_tpu_torch.ops.scan import flip_sign
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.cuda.encode import build_encoding
from kubebrain_tpu_torch.storage.cuda.engine import (
    _part_indices_of_mask,
    query_tensors,
)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
VECTOR_OPS_PER_S = 67e12    # H100 SXM non-tensor 32-bit rate
SOURCE = "kubebrain_tpu_torch/csrc/scan_visibility.cu"
REPLACES = {
    "scan_mask": "kubebrain_tpu/ops/scan_pallas.py:175",
    "scan_mask_q": "kubebrain_tpu/ops/scan_pallas.py:222",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(keys_t, valid_rows: int, q: int) -> tuple[float, str]:
    """Least time for one visibility launch: inputs read once (keys,
    revisions and tombstones of the ``valid_rows`` rows below each
    partition's n_valid, which are all the kernel reads; n_valid and the
    per-query bounds), outputs written once (Q mask bytes for every row of
    [P, N] and the counts), over the memory rate; or the 2·Q·C chunk
    compares of each valid row over the vector rate, whichever is larger."""
    p, c, n = keys_t.shape
    nbytes = (valid_rows * (4 * c + 8 + 1) + 4 * p + q * (8 * c + 4 + 8)
              + q * p * n + 4 * q * p)
    ops = 2 * q * c * valid_rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / VECTOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelCase:
    """One kernel call on fixed device inputs, its plain counterpart, and
    the comparison between them."""

    def __init__(self, name, keys_t, revs, tomb, nv, starts, ends, unb, rrevs):
        self.name = name
        self.q = starts.shape[0]
        self.keys_t = keys_t
        self.valid_rows = int(nv.sum())
        if name == "scan_mask":
            self.kernel = lambda: scan_kernels.visibility_mask_batch(
                keys_t, revs, tomb, nv, starts[0], ends[0], unb, rrevs)
        else:
            self.kernel = lambda: scan_kernels.visibility_mask_batch_q(
                keys_t, revs, tomb, nv, starts, ends, unb, rrevs)

        def plain():
            m = scan.visibility_mask(keys_t, revs, tomb, nv, starts, ends,
                                     unb, rrevs)
            if name == "scan_mask":
                m = m[0]
            return m, m.sum(dim=-1, dtype=torch.int32)

        self.plain = plain

    def check(self) -> int:
        """Max |kernel - plain| over mask and counts (must be 0)."""
        km, kc = self.kernel()
        torch.cuda.synchronize()
        pm, pc = self.plain()
        err = max(int((km.to(torch.int32) - pm.to(torch.int32)).abs().max()),
                  int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"{self.name}: kernel disagrees with plain "
                                 f"(max abs err {err})")
        return err

    def measure(self, reps: int) -> dict:
        b, by = bound_ms(self.keys_t, self.valid_rows, self.q)
        return {"ms": time_ms(self.kernel, reps),
                "plain_ms": time_ms(self.plain, max(3, reps // 4)),
                "bound_ms": b, "bound_by": by}


# ------------------------------------------------------------------ phase b
def kernel_phase(n_keys: int, revs_per_key: int, dev) -> dict:
    """K1/K2 against the plain version on the scan bench's synthetic
    mirror: '/registry/pods/default/pod-%08d' keys, ascending revisions,
    the last version of every 10th key tombstoned."""
    width = keyops.KEY_WIDTH
    prefix = b"/registry/pods/default/pod-"
    key_bytes = np.zeros((n_keys, width), np.uint8)
    key_bytes[:, : len(prefix)] = np.frombuffer(prefix, np.uint8)
    x = np.arange(n_keys, dtype=np.int64)
    for d in range(7, -1, -1):
        key_bytes[:, len(prefix) + d] = (x % 10) + ord("0")
        x //= 10
    lens = np.full(n_keys, len(prefix) + 8, np.int32)
    n = n_keys * revs_per_key
    revs = torch.arange(1, n + 1, dtype=torch.int64, device=dev).view(1, n)
    tomb = torch.zeros((1, n), dtype=torch.int8, device=dev)
    tomb[0, revs_per_key - 1 :: 10 * revs_per_key] = 1
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    read_mid = n // 2

    encoding = build_encoding(key_bytes, lens, raw_width=width)
    layouts = {"raw": (None, keyops.bytes_to_chunks(key_bytes))}
    enc_u8, _ = encoding.encode_keys(key_bytes, lens)
    layouts["encoded"] = (encoding, keyops.bytes_to_chunks(enc_u8))

    def digits(i):
        return b"%08d" % i

    specs_q = [
        (b"/registry/pods/", b"/registry/pods0", read_mid),
        (b"/registry/pods/default/pod-" + digits(n_keys // 4),
         b"/registry/pods/default/pod-" + digits(n_keys // 2), n),
        (b"/registry/", b"", n // 3),
        (b"/registry/pods/default/pod-" + digits(7), b"/registry/pods/default/pod-"
         + digits(7) + b"\x00", n),
        (b"/registry/pods/default/pod-0000", b"/registry/pods/default/pod-0001", n // 5),
        (b"/registry/pods/default/pod-" + digits(n_keys - 3), b"", n),
        (b"/events/", b"/events0", n),
        (b"", b"", 1),
    ]
    results = {}
    for label, (enc, chunks) in layouts.items():
        c = chunks.shape[1]
        keys_t = (torch.from_numpy(flip_sign(chunks)).to(dev)
                  .repeat_interleave(revs_per_key, dim=0).t().contiguous()
                  .view(1, c, n))
        for name, specs in (("scan_mask", specs_q[:1]), ("scan_mask_q", specs_q)):
            case = KernelCase(name, keys_t, revs, tomb, nv,
                              *query_tensors(enc, width, specs, dev))
            err = case.check()
            m = case.measure(reps=20)
            m.update(max_abs_err=err, chunks=c, rows=n, queries=len(specs))
            results[(name, label)] = m
            log(f"kernel {name} [{label}, C={c}, {n} rows, Q={len(specs)}]: "
                f"{m['ms']} ms (plain {m['plain_ms']} ms, bound "
                f"{m['bound_ms']} ms by {m['bound_by']}), max_abs_err {err}")
        del keys_t
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase c
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


def same_kvs(got, want, what: str) -> None:
    g = [(kv.key, kv.value, kv.revision) for kv in got]
    w = [(kv.key, kv.value, kv.revision) for kv in want]
    if g != w:
        raise AssertionError(f"{what}: {len(g)} rows differ from the host "
                             f"scanner's {len(w)}")


def main_path_phase(n_keys: int, seed: int, dev) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    rows, top = kube_dataset(n_keys, seed)
    store = new_storage("cuda", inner="memkv", device=dev)
    inner = store.untracked()
    for b0 in range(0, len(rows), 1024):
        bw = inner.begin_batch_write()
        for k, v in rows[b0 : b0 + 1024]:
            bw.put(k, v)
        bw.commit()
    bw = inner.begin_batch_write()
    bw.put(LAST_REV_KEY, coder.encode_rev_value(top))
    bw.commit()
    n_rows = len(rows)
    del rows
    log(f"main path: {n_keys} user keys, {n_rows} store rows, top revision "
        f"{top}, loaded in {time.perf_counter() - t0:.1f} s")

    backend = Backend(store, BackendConfig())
    oracle = Scanner(inner, get_compact_revision=lambda _s: 0)
    try:
        t0 = time.perf_counter()
        backend.scanner.publish()
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
        for q, res in zip(batch, r_batch):
            rr = q[3] or top
            if isinstance(res, BaseException):
                raise res
            if q[0] == "count":
                if res[0] != oracle.count(q[1], q[2], rr):
                    raise AssertionError(f"batched count {q} differs")
            else:
                same_kvs(res.kvs, oracle.range_(q[1], q[2], rr)[0],
                         f"batched range {q}")
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
        cases = []
        for name, specs in (
                ("scan_mask", [(ns[0], ns[1], head)]),
                ("scan_mask_q", [(q[1], q[2], q[3] or head) for q in batch])):
            case = KernelCase(name, mirror.keys_dev, mirror.revs_dev,
                              mirror.tomb_dev, mirror.n_valid_dev,
                              *query_tensors(mirror.encoding, mirror.key_width,
                                             specs, dev))
            err = case.check()
            m = case.measure(reps=50)
            m["max_abs_err"] = err
            p, c, n = mirror.keys_dev.shape
            log(f"kernel {name} [main path mirror, P={p}, C={c}, N={n}, "
                f"Q={len(specs)}]: {m['ms']} ms (plain {m['plain_ms']} ms, "
                f"bound {m['bound_ms']} ms by {m['bound_by']}), "
                f"max_abs_err {err}")
            cases.append((name, m))
        # J1 (mask -> index block) beside its one-call yardstick
        mask, counts = KernelCase(
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
        return launches, dict(cases)
    finally:
        backend.close()
        store.close()


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

    bench = kernel_phase(args.kernel_keys, args.kernel_revs, dev)
    launches, main_cases = main_path_phase(args.keys, args.seed, dev)

    kernels = []
    for name in ("scan_mask", "scan_mask_q"):
        m = main_cases[name]
        err = max([m["max_abs_err"]] + [v["max_abs_err"] for (n, _l), v in
                                        bench.items() if n == name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
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
