"""``chip_smoke.py``'s phases rehearsed on the CPU at a small size (phase
(g2) needs ``kbstored``: ``make -C native``).

CPU tensors take the kernels' plain versions and launch nothing, so the
rehearsal counts a launch where a wrapper calls its plain version, on the
wrapper's own counter, and stubs the CUDA clock, the profiler and
synchronisation. The wrappers compute the kernels' own algorithms in place
of the plain versions (K1/K2's block-classified
``scan.visibility_mask_blocked``, K3's tiled ``compact.victim_mask_tiled``,
K4's ranks → count → look-back → ranked write
``fanout.fanout_dispatch_ranked``), so
every check of the script holds those algorithms against the plain
version. What it checks is the script's control flow: every comparison it
makes against the plain versions, the host ``Scanner`` and
``match_oracle``, the launch and routing checks, and the compaction against
the twin store. It measures nothing on a device.

Run as a script, it rehearses at a chosen size and prints each phase's
host seconds (CPU numbers, not device metrics)::

    JAX_PLATFORMS=cpu python tests/test_torch_chip_smoke.py --keys 100000
"""

import argparse
import sys
import time
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from kubebrain_tpu_torch.ops import compact as tcompact  # noqa: E402
from kubebrain_tpu_torch.fanout import DeviceFanout  # noqa: E402
from kubebrain_tpu_torch.ops import compact_kernels, scan_kernels  # noqa: E402
from kubebrain_tpu_torch.ops import fanout as tfanout  # noqa: E402
from kubebrain_tpu_torch.ops import fanout_kernels  # noqa: E402
from kubebrain_tpu_torch.ops import keys as keyops  # noqa: E402
from kubebrain_tpu_torch.ops import scan as tscan  # noqa: E402
from kubebrain_tpu_torch.storage.native import NativeKv  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that the test
    run's parallel workers do not oversubscribe the cores (with every
    worker's threads spinning, a small op can take a hundred times
    longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, **_kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def cpu_shims(setattr_) -> None:
    """Install the rehearsal's stand-ins with ``setattr_(obj, name, value)``."""
    setattr_(torch.cuda, "synchronize", lambda *a: None)
    setattr_(torch.cuda, "Event", _HostEvent)
    setattr_(torch.cuda, "empty_cache", lambda: None)
    setattr_(chip_smoke, "device_ms",
             lambda fn, kernels, reps: (fn(), (None, 1.0))[1])
    setattr_(chip_smoke, "cold_ms", lambda fn, reps: chip_smoke.time_ms(fn, 1))

    def victim_mask(*args):
        compact_kernels.victim_mask_batch.launches += 1
        return tcompact.victim_mask_tiled(*args)

    def visibility_mask(keys_t, revs, tomb, nv, starts, ends, unb, rrevs):
        # K1 passes one query; K2 two or more (scan_batch sends a single
        # device query to K1, and the script's K2 cases hold eight)
        wrapper = (scan_kernels.visibility_mask_batch if starts.shape[0] == 1
                   else scan_kernels.visibility_mask_batch_q)
        wrapper.launches += 1
        return tscan.visibility_mask_blocked(keys_t, revs, tomb, nv, starts,
                                             ends, unb, rrevs)

    def fanout_dispatch(*args, index=None):
        fanout_kernels.fanout_dispatch.launches += 1
        # a small residency, so that the look-back walks past a window
        return tfanout.fanout_dispatch_ranked(*args, index=index, resident=3)

    def fanout_mask_range(*args, index=None):
        fanout_kernels.fanout_mask_range.launches += 1
        return tfanout.fanout_mask_rank_plain(*args, index=index)

    setattr_(compact_kernels, "compact",
             types.SimpleNamespace(victim_mask=victim_mask))
    setattr_(scan_kernels, "scan",
             types.SimpleNamespace(visibility_mask=visibility_mask))
    plain = {k: v for k, v in vars(tfanout).items() if not k.startswith("__")}
    setattr_(fanout_kernels, "fanout", types.SimpleNamespace(**{
        **plain, "fanout_dispatch_ranked": fanout_dispatch,
        "fanout_mask_rank_plain": fanout_mask_range}))


@pytest.fixture
def shims(monkeypatch):
    cpu_shims(monkeypatch.setattr)
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()
    yield
    for mod in (scan_kernels, compact_kernels, fanout_kernels):
        mod.reset_launch_counts()


def test_kernel_phases(shims):
    """Phases (b) and (d): every case agrees with the plain version and
    reports a bound; the long-chain case expires some chains whole."""
    layouts = chip_smoke.bench_layouts(300)
    bench = chip_smoke.kernel_phase(layouts, 4, CPU)
    victims = chip_smoke.victim_phase(layouts, 4, CPU)
    # K3: 3 cases x raw/encoded, long chains, 6 tile-edge cases x raw/narrow
    assert len(bench) == 8 and len(victims) == 19
    for m in [*bench.values(), *victims.values()]:
        assert m["max_abs_err"] == 0
    for (_name, label), m in bench.items():
        if label.endswith("edges"):
            continue
        assert m["bound_by"] == "bytes" and 0 < m["bound_ms"] <= m["bound_full_ms"]
        assert sum(m["blocks"]) > 0 and "device_ms" in m
    assert victims[("raw", "long chains")]["victims"] > 0
    assert all(v["victims"] > 0 for v in victims.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_main_path_and_compaction(shims, seed):
    """Phases (c) and (e) on one store: the reads equal the host scanner,
    the compaction equals the host scanner's on the twin, and every kernel
    of the path counts its launches."""
    n_keys = 2000
    store, top = chip_smoke.load_store(n_keys, seed, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        launches, cases = chip_smoke.serve_phase(backend, store, top, CPU)
        compacted = chip_smoke.compact_phase(backend, store, top, n_keys, CPU)
    finally:
        backend.close()
        store.close()
    assert min(launches.values()) > 0 and compacted["launches"] == 1
    assert compacted["case"]["max_abs_err"] == 0
    assert all(m["max_abs_err"] == 0 for m in cases.values())


@pytest.mark.parametrize("encoded", [False, True], ids=["raw", "encoded"])
def test_edge_queries_land_on_block_edges(shims, encoded):
    """The edge queries of phase (b) start and end at the keys of the rows
    they name, and every one of them agrees with the plain version."""
    n_keys, revs_per_key = 600, 5
    enc, chunks = chip_smoke.bench_layouts(n_keys)["encoded" if encoded else "raw"]
    cols = chip_smoke.bench_mirror(chunks, revs_per_key, CPU)
    n = n_keys * revs_per_key
    key_at = lambda r: chip_smoke.bench_key(r // revs_per_key)
    rows = [254, 255, 256, 510, 1275]
    specs = chip_smoke.edge_specs(key_at, rows, n, n // 2)
    assert len(specs) == 2 * len(rows) + 5
    assert specs[2 * rows.index(1275)][0] == key_at(1275) != key_at(1274)
    got = chip_smoke.check_edges(cols, enc, keyops.KEY_WIDTH, specs, CPU)
    assert got["scan_mask"] == got["scan_mask_q"] == 0
    assert got["queries"] == len(specs) and all(got["blocks"])


@pytest.mark.parametrize("broken", ["last_owned_row", "look_ahead_row"])
def test_edge_checks_catch_a_wrong_block_edge(shims, monkeypatch, broken):
    """A kernel that gets one row of every block edge wrong fails the edge
    checks: they have teeth."""
    cols = chip_smoke.bench_mirror(
        chip_smoke.bench_layouts(600)["raw"][1], 5, CPU)
    off = 254 if broken == "last_owned_row" else 255

    def wrong(*args):
        mask = tscan.visibility_mask(*args).clone()
        mask[..., off :: tscan.BLOCK_OWNED] ^= True
        return mask

    monkeypatch.setattr(scan_kernels, "scan",
                        types.SimpleNamespace(visibility_mask=wrong))
    specs = chip_smoke.edge_specs(lambda r: chip_smoke.bench_key(r // 5),
                                  [254, 255, 256, 510], 3000, 1500)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_edges(cols, None, keyops.KEY_WIDTH, specs, CPU)


def test_pow2_padding_copies_the_first_query():
    specs = [(b"a", b"b", i) for i in range(5)]
    padded = chip_smoke.pow2_padded(specs)
    assert len(padded) == 8 and padded[5:] == [specs[0]] * 3
    assert chip_smoke.pow2_padded(specs[:1]) == specs[:1]


@pytest.mark.parametrize("moved", [*chip_smoke.OFF_DEVICE_COUNTERS,
                                   "full_rebuild_total", "quarantined"])
def test_off_device_guard_fails(moved):
    """A failure that a retry absorbed, a degraded window or a rebuild from
    the store fails the run even when every answer was right."""
    scanner = types.SimpleNamespace(
        full_rebuild_total=1, _mirror_state="serving",
        **{k: 0 for k in chip_smoke.OFF_DEVICE_COUNTERS})
    chip_smoke.stayed_on_device(scanner, 1, "clean")
    if moved == "quarantined":
        scanner._mirror_state = moved
    else:
        setattr(scanner, moved, getattr(scanner, moved) + 1)
    with pytest.raises(AssertionError, match="left the device"):
        chip_smoke.stayed_on_device(scanner, 1, "faulty")


def test_fanout_kernel_cases(shims):
    """Phase (f) kernel cases (i)-(vi): K4's ranked algorithm and K5 agree
    with both plain versions, the edge cases and samples of the others
    with match_oracle (and the pinned 16-byte width, C = 4, with the plain
    versions), and every case counts its launches."""
    cases = chip_smoke.fanout_kernel_phase(CPU, 300, 512, 700, 128, seed=0,
                                           deep_e=600)
    assert len(cases) == 16
    for (name, what), m in cases.items():
        assert m["max_abs_err"] == 0 and m["launches"] > 0, (name, what)
    for what in ("i", "ii"):
        m = cases[("fanout_dispatch", what)]
        assert m["pairs"] > 0 and 0 < m["bound_ms"] and "device_ms" in m
        # the least-work bound of rank space lies below the compare bound
        assert m["bound_ms"] < m["bound_full_ms"]
        assert m["index_ms"] > 0 and m["oracle_pairs"] > 0
        churn = m["churn"]
        assert all(churn[kind]["publish_ms"] > 0
                   for kind in chip_smoke.CHURN_KINDS)
        assert churn["min_rev"]["index_ms"] == 0
        assert churn["new key"]["index_ms"] > 0
    assert cases[("fanout_dispatch", "i")]["churn"]["oracle_pairs"] > 0
    assert cases[("fanout_dispatch", "v")]["oracle_pairs"] == 64 * 600


def test_a_case_without_profiler_records_fails(shims, monkeypatch):
    """A measured case whose profile keeps no kernel record fails the
    phase (its device time would read as nothing), after two retries."""
    calls = []

    def no_records(fn, kernels, reps):
        calls.append(reps)
        return None, 0.0

    monkeypatch.setattr(chip_smoke, "device_ms", no_records)
    with pytest.raises(AssertionError, match="no record"):
        chip_smoke.fanout_kernel_phase(CPU, 300, 512, 700, 128, seed=0,
                                       deep_e=600)
    assert calls == [50, 100, 200]


def _watch_backend():
    store = chip_smoke.new_storage("cuda", inner="memkv", device=CPU)
    return store, chip_smoke.Backend(store, chip_smoke.BackendConfig(
        fanout_matcher=DeviceFanout(device=CPU)))


@pytest.mark.parametrize("seed", [0, 1])
def test_watch_phase_routes_to_the_matcher_and_drops_nobody(shims, seed):
    """Phase (f) end to end at 300 watchers (70 broad: the hub's index is
    dense, so every block goes to the matcher): every watcher's events
    equal match_oracle, none is dropped, the blocks reach K4 (and the
    legacy drive K5), and blocks hold more than one event."""
    store, backend = _watch_backend()
    try:
        res = chip_smoke.watch_phase(backend, CPU, 300, 480, 4, 70, seed)
    finally:
        backend.close()
        store.close()
    assert res["matcher"]["blocks"] > 0 and res["matcher"]["dispatches"] > 0
    assert min(res["launches"].values()) > 0
    assert res["delivered"] > res["events"] > 0
    assert res["block_sizes"][-1] > 1
    assert all(m["max_abs_err"] == 0 for m in res["cases"].values())
    assert res["stage_s"].get("fanout_dispatch", 0) > 0


def test_watch_phase_catches_a_lost_delivery(shims, monkeypatch):
    """A K4 that loses the last match of every block fails the end-to-end
    comparison with match_oracle: it has teeth."""
    def lossy(*args, index=None):
        counts, idx = tfanout.fanout_dispatch_ranked(*args, index=index)
        hit = counts.nonzero()
        if len(hit):
            counts[hit[-1]] -= 1
        return counts, idx

    monkeypatch.setattr(fanout_kernels, "fanout", types.SimpleNamespace(
        **{**vars(fanout_kernels.fanout),
           "fanout_dispatch_ranked": lossy}))
    store, backend = _watch_backend()
    try:
        with pytest.raises(AssertionError, match="oracle"):
            chip_smoke.watch_drive(backend, 200, 70, 120, 2, 0)
    finally:
        backend.close()
        store.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_watch_drive_under_watcher_churn(shims, seed):
    """The drive with watchers re-established every few milliseconds:
    every watcher still equals match_oracle, every churned watcher's
    events are the oracle's first from its start revision, and the
    table's rank index was updated, not only rebuilt."""
    store, backend = _watch_backend()
    try:
        res = chip_smoke.watch_drive(backend, 300, 70, 480, 4, seed,
                                     rewatch_s=0.6)
    finally:
        backend.close()
        store.close()
    assert res["rewatches"] > 0 and res["churn_delivered"] > 0
    assert res["index"]["index_updates"] > 0
    assert res["index_ms_per_block"] > 0


def test_watch_drive_catches_a_churned_watchers_extra_event(shims,
                                                             monkeypatch):
    """A churned watcher handed an event from before its start revision
    fails the drive: the churn check has teeth."""
    orig = chip_smoke.Backend.watch_range

    def early(self, s, e, rev, queue_factory=None):
        return orig(self, s, e, max(rev - 200, 1) if rev else rev,
                    queue_factory=queue_factory)

    monkeypatch.setattr(chip_smoke.Backend, "watch_range", early)
    store, backend = _watch_backend()
    try:
        with pytest.raises(AssertionError, match="churned watcher"):
            chip_smoke.watch_drive(backend, 300, 70, 480, 4, 0,
                                   rewatch_s=0.6)
    finally:
        backend.close()
        store.close()


needs_kbstored = pytest.mark.skipif(
    not chip_smoke.KBSTORED.exists(), reason="kbstored not built (make -C native)")


def small_args(**kw):
    """The arguments phases (g) and (h) read, at a rehearsal's size."""
    args = dict(keys=2000, remote_keys=1500, seed=0, chaos_keys=1500,
                chaos_watchers=300, chaos_horizon=4.0,
                chaos_merge_threshold=64, writers=4)
    args.update(kw)
    return types.SimpleNamespace(**args)


@needs_kbstored
def test_deployed_engine_phases(shims):
    """Phase (g): over native (then restarted on its data dir) and over a
    kbstored, the mirror boots by the export, equals a per-row build, every
    response equals the host scanner, the compaction equals the host
    scanner's on a twin of the same kind, and K1-K3 launch on both."""
    out = chip_smoke.deployed_phases(small_args(), CPU)
    for name in ("native", "remote"):
        res = out[name]
        assert min(res["launches"].values()) > 0, name
        assert res["boot_s"] > 0 and res["per_row_build_s"] > 0
        assert {"gc", "mark", "merge"} <= set(res["compact_phase_s"][0])
    assert out["native"]["restart_boot_s"] > 0


def test_a_per_row_boot_fails_the_deployed_phase(shims, monkeypatch):
    """A mirror built row by row where the engine has the export fails the
    phase: the boot check has teeth."""
    def no_export(self, *args):
        raise chip_smoke.StorageError("no export")

    monkeypatch.setattr(NativeKv, "export_mvcc", no_export)
    store = chip_smoke.new_storage("cuda", inner="native", device=CPU)
    try:
        rows, top = chip_smoke.kube_dataset(300, 0)
        chip_smoke.load_rows(store.untracked(), rows, top)
        with pytest.raises(AssertionError, match="bulk export"):
            chip_smoke.boot(store, "native")
    finally:
        store.close()


def test_chaos_phase(shims):
    """Phase (h) under the storage and the merge presets: faults injected,
    every acknowledged write read back, no failed write present, the retry
    FIFO drained, the mirror serving again and every response equal to the
    host scanner, K1-K3 launching after recovery and the watch drive equal
    to match_oracle through K4."""
    out = chip_smoke.chaos_phase(small_args(), CPU)
    storage, merge = out["storage"], out["merge"]
    assert storage["quarantines"] > 0 and storage["writes"]["uncertain"] > 0
    assert storage["injected"].get("storage_error", 0) > 0
    assert merge["injected"] and merge["writes"]["acked"] > 0
    for res in (storage, merge):
        assert min(res["launches_after"].values()) > 0
    assert out["fanout_dispatch"] > 0


def test_chaos_read_back_catches_a_lost_acknowledged_write(shims):
    """An acknowledged write missing from the store fails the chaos
    read-back: the ledger check has teeth."""
    store = chip_smoke.new_storage("cuda", inner="native", device=CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        ledger = chip_smoke.ChaosLedger()
        for i in range(5):
            k = b"/registry/pods/ns/obj-%d" % i
            ledger.acked[k] = (b"v%d" % i, backend.create(k, b"v%d" % i))
        chip_smoke.check_ledger(backend, ledger)
        backend.delete(b"/registry/pods/ns/obj-3")
        with pytest.raises(AssertionError, match="do not read back"):
            chip_smoke.check_ledger(backend, ledger)
    finally:
        backend.close()
        store.close()


def test_routing_crossover_rows(shims):
    rows = chip_smoke.routing_crossover(CPU, 200, 0)
    assert [r["events"] for r in rows] == [1, 8, 64, 512]
    assert all(r["K4"] > 0 and r["index"] > 0 for r in rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--kernel-keys", type=int, default=2000)
    ap.add_argument("--kernel-revs", type=int, default=10)
    ap.add_argument("--watchers", type=int, default=2000)
    ap.add_argument("--writes", type=int, default=4000)
    ap.add_argument("--writers", type=int, default=8)
    args = ap.parse_args()
    cpu_shims(setattr)
    t0 = time.perf_counter()
    layouts = chip_smoke.bench_layouts(args.kernel_keys)
    chip_smoke.kernel_phase(layouts, args.kernel_revs, CPU)
    chip_smoke.victim_phase(layouts, args.kernel_revs, CPU)
    t1 = time.perf_counter()
    store, top = chip_smoke.load_store(args.keys, args.seed, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        chip_smoke.serve_phase(backend, store, top, CPU)
        t2 = time.perf_counter()
        chip_smoke.compact_phase(backend, store, top, args.keys, CPU)
        t3 = time.perf_counter()
    finally:
        backend.close()
        store.close()
    store, backend = _watch_backend()
    try:
        chip_smoke.fanout_kernel_phase(CPU, args.watchers, 128, 2 * args.watchers,
                                       256, args.seed, deep_e=2000)
        chip_smoke.watch_phase(backend, CPU, args.watchers, args.writes,
                               args.writers, 70, args.seed)
        chip_smoke.routing_crossover(CPU, args.watchers, args.seed)
        t4 = time.perf_counter()
    finally:
        backend.close()
        store.close()
    small = small_args(keys=args.keys // 10, remote_keys=args.keys // 10,
                       seed=args.seed, chaos_keys=args.keys // 20,
                       chaos_watchers=args.watchers // 4, chaos_horizon=10.0,
                       writers=args.writers)
    chip_smoke.deployed_phases(small, CPU)
    t5 = time.perf_counter()
    chip_smoke.chaos_phase(small, CPU)
    t6 = time.perf_counter()
    print(f"host seconds on the CPU: kernel phases {t1 - t0}, load and serve "
          f"{t2 - t1}, compaction phase {t3 - t2}, fan-out phase {t4 - t3}, "
          f"deployed engines {t5 - t4}, chaos {t6 - t5}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
