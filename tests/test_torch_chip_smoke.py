"""``chip_smoke.py``'s phases rehearsed on the CPU at a small size (phase
(g2) runs ``kbstored``, which the ``kbstored`` fixture builds on first
use).

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
import contextlib
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
from kubebrain_tpu_torch.ops import launch_owner  # noqa: E402
from kubebrain_tpu_torch.ops import scan as tscan  # noqa: E402
from kubebrain_tpu_torch.storage.native import NativeKv  # noqa: E402
from kubebrain_tpu_torch.workload import WorkloadSpec  # noqa: E402
from kubebrain_tpu_torch.workload.spec import SLOBounds  # noqa: E402

from kbstored_build import kbstored  # noqa: E402,F401

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
        launch_owner.count("victim_mask")
        return tcompact.victim_mask_tiled(*args)

    def visibility_mask(keys_t, revs, tomb, nv, starts, ends, unb, rrevs):
        # K1 passes one query; K2 two or more (scan_batch sends a single
        # device query to K1, and the script's K2 cases hold eight)
        wrapper = (scan_kernels.visibility_mask_batch if starts.shape[0] == 1
                   else scan_kernels.visibility_mask_batch_q)
        wrapper.launches += 1
        launch_owner.count("scan_mask" if starts.shape[0] == 1
                           else "scan_mask_q")
        return tscan.visibility_mask_blocked(keys_t, revs, tomb, nv, starts,
                                             ends, unb, rrevs)

    def fanout_dispatch(*args, index=None):
        fanout_kernels.fanout_dispatch.launches += 1
        launch_owner.count("fanout_dispatch")
        # a small residency, so that the look-back walks past a window
        return tfanout.fanout_dispatch_ranked(*args, index=index, resident=3)

    def fanout_mask_range(*args, index=None):
        fanout_kernels.fanout_mask_range.launches += 1
        launch_owner.count("fanout_mask_range")
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


PROGRAM_SIZES = {"n_lookups": 200, "n_watchers": 300, "n_broad": 3,
                 "n_events": 64}


@pytest.fixture
def served_store(shims):
    """(c) at a small size: (store, top, backend) after ``serve_phase``."""
    store, top = chip_smoke.load_store(2000, 0, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        chip_smoke.serve_phase(backend, store, top, CPU)
        yield store, top, backend
    finally:
        backend.close()
        store.close()


def test_programs_phase(served_store):
    """Phase (n) after (c) on its store: the six programs agree with K1
    and J1 on (c)'s queries, with the host store on drawn and absent keys,
    with their CPU runs, and with K5 where a prefix is a range; each is
    timed. (c)'s Backend still serves after it."""
    store, top, backend = served_store
    scan_kernels.reset_launch_counts()
    compact_kernels.reset_launch_counts()
    fanout_kernels.reset_launch_counts()
    out = chip_smoke.programs_phase(backend, store, top, 2000, 0, CPU,
                                    "cpu (rehearsal)", **PROGRAM_SIZES)
    assert set(out) == {"count_visible", "visible_mask", "visible_indices",
                        "point_lookup", "compact_block", "fanout_mask"}
    assert all(ms > 0 for ms in out.values())
    # the yardsticks ran: K1 once per query of (c)'s batch, K3 and K5 once
    assert scan_kernels.visibility_mask_batch.launches == 8
    assert compact_kernels.victim_mask_batch.launches == 1
    assert fanout_kernels.fanout_mask_range.launches == 1
    assert backend.count(*chip_smoke.PODS)[0] > 0


def _break_first(fn):
    """``fn`` whose first tensor result has its first element flipped."""
    def broken(*args, **kw):
        res = fn(*args, **kw)
        first = res[0] if isinstance(res, tuple) else res
        first = first.clone()
        flat = first.view(-1)
        flat[0] = ~flat[0] if flat.dtype == torch.bool else flat[0] + 1
        return (first, *res[1:]) if isinstance(res, tuple) else first
    return broken


@pytest.mark.parametrize("module,name,message", [
    ("scan", "visible_mask", "visible_mask differs from K1"),
    ("scan", "visible_indices", "visible_indices differs from J1"),
    ("scan", "point_lookup", "point_lookup"),
    ("compact", "compact_block", "compact_block"),
    ("fanout", "fanout_mask", "fanout_mask"),
])
def test_programs_phase_stops_at_a_mismatch(served_store, monkeypatch,
                                            module, name, message):
    """A program that answers wrong stops (n) with an AssertionError that
    names it: no mismatch is caught and passed over."""
    store, top, backend = served_store
    mod = {"scan": tscan, "compact": tcompact, "fanout": tfanout}[module]
    monkeypatch.setattr(mod, name, _break_first(getattr(mod, name)))
    with pytest.raises(AssertionError, match=message):
        chip_smoke.programs_phase(backend, store, top, 2000, 0, CPU,
                                  "cpu (rehearsal)", **PROGRAM_SIZES)


def mesh_args(**kw):
    return types.SimpleNamespace(**{"seed": 0, "watchers": 300,
                                    "block_events": 64, **kw})


def test_mesh_phase(shims):
    """Phase (l) after (c) on its store, on two CPU slots: the sharded
    answers equal (c)'s within the pull bound, only dirty slots re-upload,
    the compacted stores are equal, the sharded fan-out pairs and J6 equal
    the one-slot results, and every kernel launches under the owner."""
    store, top = chip_smoke.load_store(2000, 0, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    try:
        chip_smoke.serve_phase(backend, store, top, CPU)
        out = chip_smoke.mesh_phase(backend, store, top, mesh_args(), CPU,
                                    n_keys=3000, n_ops=300)
        # (c)'s store and Backend still serve after (l) closed its own
        assert backend.count(*chip_smoke.PODS)[0] > 0
    finally:
        backend.close()
        store.close()
    assert set(out["launches"]) == set(chip_smoke.SOURCES)
    assert min(out["launches"].values()) > 0
    assert out["what"] == "two slots of one device (cpu)"


def test_every_card_placement(shims, monkeypatch):
    """``chip_mesh.py``'s (m) on the CPU, the default store placed on two
    CPU slots in place of two cards: it serves (c)'s requests like the
    one-slot store and compacts to an equal store, K3 once per slot."""
    import chip_mesh

    real = chip_mesh.new_storage

    def placed(kind, **kw):
        if "device" not in kw:  # the engine's default: here two CPU slots
            kw["mesh"] = [CPU, CPU]
        return real(kind, **kw)

    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_mesh, "new_storage", placed)
    out = chip_mesh.every_card(3000, 0, [CPU, CPU])
    assert out["slots"] == 2 and out["rows"] > 0
    assert out["launches"]["victim_mask"] % 2 == 0
    assert out["launches"]["victim_mask"] > 0
    with pytest.raises(AssertionError, match=r"\(m\) the default"):
        chip_mesh.every_card(300, 0, [CPU])


def test_mesh_phase_catches_a_wrong_slot(shims, monkeypatch):
    """A K1 that drops the visible rows of the second slot's first
    partition fails (l1)'s comparison with (c)'s answers: the check has
    teeth."""
    store, top = chip_smoke.load_store(2000, 0, CPU)
    backend = chip_smoke.Backend(store, chip_smoke.BackendConfig())
    real = scan_kernels.scan.visibility_mask

    def wrong(keys_t, revs, tomb, nv, starts, ends, unb, rrevs):
        mask = real(keys_t, revs, tomb, nv, starts, ends, unb, rrevs)
        if int(nv[0]) == int(store_nv[2]):
            mask[..., 0, :] = False
        return mask

    try:
        chip_smoke.serve_phase(backend, store, top, CPU)
        sharded = chip_smoke.CudaKvStorage(store.untracked(), mesh=[CPU, CPU],
                                           partitions=4)
        sc = sharded.make_scanner(get_compact_revision=lambda _s: 0)
        sc.publish()
        store_nv = sc._mirror.n_valid.tolist()
        sc.close()
        monkeypatch.setattr(scan_kernels, "scan", types.SimpleNamespace(
            visibility_mask=wrong))
        with pytest.raises(AssertionError, match=r"\(l1\)"):
            chip_smoke.mesh_reads(backend, store, top, [CPU, CPU])
    finally:
        backend.close()
        store.close()


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


#: (g2) runs a kbstored: built on first use (``kbstored_build``)
needs_kbstored = pytest.mark.usefixtures("kbstored")


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


def sched_args(**kw):
    """The arguments phase (i) reads, at a rehearsal's size."""
    args = dict(keys=3000, seed=0, sched_writes=400, leases=4)
    args.update(kw)
    return types.SimpleNamespace(**args)


@pytest.fixture
def small_leases(monkeypatch):
    """Phase (i3) at a rehearsal's size: leases of 3 s, 300 watchers."""
    monkeypatch.setattr(chip_smoke, "LEASE_TTL_S", 3.0)
    monkeypatch.setattr(chip_smoke, "EVENT_WATCHERS", 300)


@contextlib.contextmanager
def cli_booted(tmp_path):
    """A small kube store on native behind a Backend booted as phase (i)
    boots it, by the port's CLI: (backend, sink, top revision)."""
    d = tmp_path / "native"
    native = chip_smoke.new_storage("native", data_dir=str(d), fsync=False,
                                    partitions=4)
    rows, top = chip_smoke.kube_dataset(1500, 0)
    chip_smoke.load_rows(native, rows, top)
    native.close()
    sink = chip_smoke.RecordingMetrics()
    backend = store = None
    try:
        backend, store, _cli_s, _publish_s = chip_smoke.cli_boot(
            chip_smoke.cli_args(d, CPU), sink, "test")
        yield backend, sink, top
    finally:
        if backend is not None:
            backend.close()
        if store is not None:
            store.close()
        chip_smoke.TRACER.metrics = None


@pytest.fixture
def wired(shims, tmp_path):
    with cli_booted(tmp_path) as booted:
        yield booted


def test_cli_flags_are_the_cli_defaults(tmp_path):
    """Phase (i)'s scheduler and lease flags state the CLI's defaults, and
    its boot gets them: the flags cannot drift from what the CLI runs."""
    from kubebrain_tpu_torch import cli

    args = chip_smoke.cli_args(tmp_path, CPU)
    defaults = cli.build_parser().parse_args([])
    names = [f[2:].replace("-", "_") for f in chip_smoke.CLI_FLAGS
             if f.startswith(("--sched-", "--lease-"))]
    assert len(names) == 7
    for name in names:
        assert getattr(args, name) == getattr(defaults, name), name
    assert (args.storage, args.inner_storage, args.device) == (
        "cuda", "native", "cpu")
    assert args.tpu_fanout and args.single_node and args.data_dir == str(tmp_path)


@pytest.fixture
def small_follower(monkeypatch):
    """Phase (j) at a rehearsal's size: 300 follower watchers, 20 fenced
    Counts."""
    monkeypatch.setattr(chip_smoke, "FOLLOWER_WATCHERS", 300)
    monkeypatch.setattr(chip_smoke, "FENCED_COUNTS", 20)


def test_sched_phase(shims, small_leases, small_follower):
    """Phase (i): scheduled reads equal the unscheduled oracle at batch 1
    and 8, the batch-8 run reaches K2 with more than one query a launch,
    writes beside it form groups and are watched once in order, expired
    leases' keys are gone (K1), their deletes reach every watcher (K4),
    the leases survive a restart of native and the compaction (K3)
    changes no answer; the sink agrees with the registries. Then (j): a
    follower of that leader, built by the CLI, bootstraps, follows, serves
    every read as the leader does and launches K1-K4 itself."""
    out = chip_smoke.sched_phase(sched_args(), CPU)
    one, eight = out["reads"]["runs"][1], out["reads"]["runs"][8]
    assert one["batched"] == 0 and one["k2_launches"] == 0
    assert eight["batched"] > 0 and eight["k2_launches"] > 0
    assert eight["k2_mean_q"] > 1
    assert eight["writes"]["write_batched"] > 0
    assert eight["writes"]["read_your_writes"] == 8
    leases = out["leases"]
    assert leases["count_after_reap"] == 200 and leases["checkpoints"] > 0
    assert leases["reaper_lag_max_s"] >= leases["reaper_lag_p50_s"] > 0
    assert out["restart"]["revoked"] == 200
    launches = out["launches"]
    for name in ("scan_mask", "scan_mask_q", "victim_mask", "fanout_dispatch"):
        assert launches[name] > 0, name
    follower = out["follower"]
    assert follower["bootstrap"]["keys"] > 0
    assert follower["reads"]["fenced_counts"] >= 20
    assert follower["watch"]["events"] == 400
    assert follower["apply"]["events"] >= 400
    for name, n in follower["follower_launches"].items():
        assert 0 < n <= launches[name] or name == "fanout_mask_range", name
    assert follower["follower_launches"]["fanout_mask_range"] == 0


def test_follower_phase_catches_a_wrong_follower_answer(wired, monkeypatch,
                                                        small_follower):
    """A follower whose bootstrap writes one pod's value wrong answers that
    namespace's reads unlike the leader, and phase (j) fails."""
    from kubebrain_tpu_torch.replica import ReplicaApplier

    backend, _sink, _top = wired
    orig = ReplicaApplier._put_rows
    target = chip_smoke.POD_NAMESPACES[3]

    def wrong(self, batch, key, rev, value, deleted):
        if key.startswith(target) and not deleted:
            value = value + b"!"
        return orig(self, batch, key, rev, value, deleted)

    monkeypatch.setattr(ReplicaApplier, "_put_rows", wrong)
    monkeypatch.setattr(chip_smoke, "FOLLOWER_WATCHERS", 100)
    with pytest.raises(AssertionError, match="differ from the leader's"):
        chip_smoke.follower_phase(backend, sched_args(sched_writes=80), CPU)


@pytest.mark.parametrize("t, applied, fails", [
    (103.0, 9, True),    # 3 s behind: inside the 5 s bound
    (105.0, 9, False),   # 5 s behind: within the margin of the bound
    (104.4, 9, True),    # 4.4 s behind: just past the margin
    (108.0, 10, False),  # 7 s behind (revision 11 owed since 101)
    (108.0, 11, True),   # nothing owed: not behind at all
    (100.5, 9, True),    # revision 10 committed after the refusal
])
def test_stale_refusal_check(t, applied, fails):
    """Phase (j) fails on a serializable read refused as stale while the
    follower's staleness (the age of the oldest leader event it had not
    applied, from the feed's commit times) was inside the bound by
    ``STALE_MARGIN_S`` or more."""
    feed = types.SimpleNamespace(events=[(10, "put", b"a", b"1"),
                                         (11, "put", b"b", b"2")],
                                 commit_ts=[100.0, 101.0])
    traffic = types.SimpleNamespace(
        role=types.SimpleNamespace(
            config=types.SimpleNamespace(max_staleness_ms=5000.0)),
        stale=[(t, applied, 9000.0)])
    check = chip_smoke.FollowerTraffic.check_stale_refusals
    if fails:
        with pytest.raises(AssertionError, match="inside the 5000 ms bound"):
            check(traffic, feed)
    else:
        assert check(traffic, feed)["refusals"] == 1


def test_replication_feed_refuses_an_event_behind_a_progress_mark(wired):
    """A progress mark that runs ahead of an owed event (the event then
    arrives at or below the vouched revision) fails the feed: the applier
    would drop that event as already applied."""
    backend, _sink, top = wired

    class Applier:
        backend = types.SimpleNamespace(current_revision=lambda: 0)
        seen: list = []

        def apply_wire_events(self, events, header):
            self.seen.append((len(events), header))

    feed = chip_smoke.ReplicationFeed(backend, Applier(), top + 1)
    try:
        rev = backend.current_revision()
        backend.watcher_hub.post_progress(feed.wid, rev + 5)
        wait = time.monotonic() + 10
        while feed.last < rev + 5 and time.monotonic() < wait:
            time.sleep(0.01)
        backend.create(b"/registry/pods/ns00/late", b"v")
    finally:
        with pytest.raises(AssertionError, match="ran ahead of an owed event"):
            feed.close()


def test_sched_phase_fails_when_batches_never_reach_k2(wired, monkeypatch):
    """A scheduler that forms no batch leaves the batch-8 run without a K2
    launch, and the phase fails: the check has teeth."""
    from kubebrain_tpu_torch.sched import RequestScheduler

    backend, sink, top = wired
    monkeypatch.setattr(RequestScheduler, "_form_batch",
                        lambda self, req: None)
    with pytest.raises(AssertionError, match="never reached K2"):
        chip_smoke.scheduled_reads(backend, sink, top, 0, 8)


def test_sched_phase_catches_a_wrong_scheduled_response(wired, monkeypatch):
    """A batch executor that drops a row from a Range fails the comparison
    with the unscheduled oracle."""
    backend, sink, top = wired
    orig = chip_smoke.Backend.list_batch

    def lossy(self, queries):
        out = orig(self, queries)
        for res in out:
            if hasattr(res, "kvs") and res.kvs:
                res.kvs.pop()
                break
        return out

    monkeypatch.setattr(chip_smoke.Backend, "list_batch", lossy)
    # the CLI's scheduler, which the batched run uses, resolved its batch
    # executor when the fixture booted it
    backend._kb_scheduler._backend_bexec = backend.list_batch
    with pytest.raises(AssertionError, match="unscheduled oracle"):
        chip_smoke.scheduled_reads(backend, sink, top, 0, 8)


def test_sched_phase_catches_an_expired_key_left_visible(wired, monkeypatch,
                                                         small_leases):
    """A reaper that drops an expired lease without deleting its keys
    leaves them visible, and the phase fails."""
    from kubebrain_tpu_torch.lease import LeaseReaper

    backend, sink, _top = wired
    monkeypatch.setattr(LeaseReaper, "_delete_range",
                        lambda self, keys, lease_id: True)
    keeper = chip_smoke.Keeper()
    keeper.attach(backend)
    try:
        with pytest.raises(AssertionError, match="still visible"):
            chip_smoke.lease_expiry(backend, sink, keeper, sched_args())
    finally:
        keeper.close()


def test_sched_phase_fails_when_the_cli_drops_batching(shims, tmp_path,
                                                       monkeypatch):
    """A CLI whose wiring builds its scheduler without read batches
    (``--sched-batch`` lost on the way) leaves the run through the CLI's
    scheduler without a K2 launch, and the phase fails."""
    from kubebrain_tpu_torch import sched

    real = sched.SchedConfig
    monkeypatch.setattr(sched, "SchedConfig",
                        lambda **kw: real(**{**kw, "batch": 1}))
    with cli_booted(tmp_path) as (backend, sink, top):
        assert backend._kb_scheduler.config.batch == 1
        with pytest.raises(AssertionError, match="never reached K2"):
            chip_smoke.scheduled_reads(backend, sink, top, 0, 8)


def test_sched_phase_fails_when_a_kept_lease_is_missing_after_restart(
        shims, small_leases, monkeypatch, tmp_path):
    """A restart that loses one live lease from the rehydrated table (as a
    keepalive client attached too late would let it expire) fails the
    phase at the kept-lease check."""
    from kubebrain_tpu_torch.lease import LeaseRegistry

    def own_data_dir(name):
        # not the checkout's: test_sched_phase's may be in use beside it
        d = tmp_path / name
        d.mkdir()
        return d

    monkeypatch.setattr(chip_smoke, "data_dir", own_data_dir)

    orig = LeaseRegistry.rehydrate
    dropped = []

    def lossy(self):
        n = orig(self)
        live = [lid for lid in self.ids() if self.time_to_live(lid)[0] > 0]
        if live and not dropped:
            self.drop(live[0])
            dropped.append(live[0])
        return n

    monkeypatch.setattr(LeaseRegistry, "rehydrate", lossy)
    with pytest.raises(AssertionError, match="kept lease"):
        chip_smoke.sched_phase(sched_args(), CPU)
    assert dropped


def test_side_phases_process_returns_its_result(monkeypatch):
    """The second process's result file comes back through ``result``."""
    monkeypatch.setattr(chip_smoke, "SIDE_CHILD", (
        "import json, sys\n"
        "json.dump({'seconds': {'g': 1.0}, 'launches': {'scan_mask': 2}},"
        " open(sys.argv[3], 'w'))\n"))
    side = chip_smoke.SidePhases(small_args())
    try:
        assert side.result() == {"seconds": {"g": 1.0},
                                 "launches": {"scan_mask": 2}}
    finally:
        side.close()


def test_side_process_runs_the_phases_it_is_given(monkeypatch):
    """(i) and (j) run in a process of their own: the child is told which
    function of the script to run, and a failure names those phases."""
    monkeypatch.setattr(chip_smoke, "SIDE_CHILD", (
        "import json, sys\n"
        "json.dump({'phases': sys.argv[4]}, open(sys.argv[3], 'w'))\n"))
    side = chip_smoke.SidePhases(small_args(), "sched_phases",
                                 "phases (i) and (j)")
    try:
        assert side.result() == {"phases": "sched_phases"}
        assert side.out.name == "sched_phases.json"
    finally:
        side.close()
    assert callable(chip_smoke.sched_phases)
    monkeypatch.setattr(chip_smoke, "SIDE_CHILD", "import sys; sys.exit(4)")
    side = chip_smoke.SidePhases(small_args(), "sched_phases",
                                 "phases (i) and (j)")
    try:
        with pytest.raises(AssertionError, match=r"\(i\) and \(j\) failed"):
            side.result()
    finally:
        side.close()


def test_side_phases_failure_fails_the_run(monkeypatch):
    """A second process that exits non-zero fails the run, and one still
    running when the run fails is stopped."""
    monkeypatch.setattr(chip_smoke, "SIDE_CHILD", "import sys; sys.exit(3)")
    side = chip_smoke.SidePhases(small_args())
    try:
        with pytest.raises(AssertionError, match="exit 3"):
            side.result()
    finally:
        side.close()
    monkeypatch.setattr(chip_smoke, "SIDE_CHILD",
                        "import time; time.sleep(600)")
    side = chip_smoke.SidePhases(small_args())
    side.close()
    assert side.proc.returncode is not None


def replay_spec(**kw):
    """(k) at a rehearsal's size: ``for_smoke`` at 100 nodes (100
    controllers over 33 namespaces: enough segments for a broad cohort to
    make the hub's index dense, so that (k2)'s blocks reach K4), held to
    ``for_cluster``'s batching bound unless ``bounds`` is given."""
    kw.setdefault("bounds", SLOBounds(min_batched_requests=2))
    return WorkloadSpec.for_smoke(100, seed=0, **kw)


def replay_args(**kw):
    return types.SimpleNamespace(**{"seed": 0, **kw})


@pytest.fixture
def replay_flags(monkeypatch):
    """``CLI_FLAGS`` with the merge threshold cut to the rehearsal's
    writes: at the engine's 4,096 rows a merge, a smoke replay's first
    merge would be its first compaction's, which then takes in the
    node-lease directory and rebuilds the mirror's key dictionary (the
    full-size replay merges, and rebuilds, long before its first
    compaction)."""
    monkeypatch.setattr(chip_smoke, "CLI_FLAGS",
                        chip_smoke.CLI_FLAGS + ("--merge-threshold", "64"))


def test_replay_phase(shims, replay_flags):
    """Phase (k) through the shims, both replays: the schedule's sha256
    re-checked, every acknowledged pod write read back, the history
    linearizable, every watch equal to ``match_oracle``, the compactions
    without a rebuild, the report's correctness bounds met, K1-K3
    launched under (k)'s owner in (k1) and K1-K4 in (k2), which adds the
    broad cohort; the RPC-count reconcile named as not applicable."""
    spec = replay_spec()
    out = chip_smoke.replay_phase(replay_args(), CPU, spec)
    runs = (out["cluster"], out["broad"])
    assert out["cluster"]["watch"]["broad"] == 0
    assert out["broad"]["watch"]["broad"] == chip_smoke.replay_broad(spec)
    assert out["broad"]["owner_launches"]["fanout_dispatch"] > 0
    for run in runs:
        assert run["spec"]["sha256"] == chip_smoke.generator.generate(
            spec).sha256()
        for name in chip_smoke.REPLAY_KERNELS:
            assert run["owner_launches"][name] > 0, name
        assert run["consistency"]["ok"] and \
            run["consistency"]["acked_live"] > 0
        lin = run["lincheck"]
        assert lin["ok"] and lin["ops"] > run["consistency"]["checked_keys"]
        assert run["watch"]["delivered"] > 0
        assert run["rebuilds"]["in_compactions"] == [0, 0]
        rec = run["reconcile"]
        assert rec["ok"] and set(rec["checks"]) == {"lease_keepalives",
                                                    "watchers"}
        assert set(rec["not_applicable"]) == {"txn_rpcs", "range_rpcs",
                                              "compact_rpcs",
                                              "lease_grant_rpcs"}
        assert run["summary"]["query_batches"] > 0
        assert run["summary"]["lanes"]["write"]["count"] > 0
    assert out["owner_launches"] == {
        name: sum(run["owner_launches"].get(name, 0) for run in runs)
        for name in out["owner_launches"]}


def test_replay_broad_is_the_fewest_that_make_the_index_dense():
    """At ``for_cluster(1000)`` (k2)'s cohort is 60 whole-pods watchers:
    the hub's index over the 1,000 namespace watches and 60 broad ones is
    dense, and over 59 it is not."""
    spec = WorkloadSpec.for_cluster(chip_smoke.REPLAY_NODES)
    assert chip_smoke.replay_broad(spec) == 60

    def index(broad):
        filters = {}
        for w in range(spec.nodes):
            prefix = b"/registry/pods/" + chip_smoke.generator.ns_name(
                w % spec.namespaces) + b"/"
            filters[w] = (prefix, chip_smoke.coder.prefix_end(prefix), 0)
        for b in range(broad):
            filters[spec.nodes + b] = (b"/registry/pods/", b"/registry/pods0",
                                       0)
        return chip_smoke._RangeIndex(filters)

    assert index(60).dense and not index(59).dense


def test_replay_phase_needs_the_broad_cohort_for_k4(shims, replay_flags,
                                                    monkeypatch):
    """Without broad watchers the hub serves every block of the workload's
    informers from its index: (k2) then fails on K4's zero count."""
    monkeypatch.setattr(chip_smoke, "replay_broad", lambda spec: 0)
    with pytest.raises(AssertionError,
                       match=r"\(k2\) never launched \['fanout_dispatch'\]"):
        chip_smoke.replay_phase(replay_args(), CPU, replay_spec())


def test_replay_phase_catches_a_lost_acknowledged_write(shims, replay_flags,
                                                        monkeypatch):
    """A pod create acknowledged and then lost from the store fails (k)."""
    orig = chip_smoke.InProcessClient.create
    lost = []

    def losing(self, key, value, lease=0):
        ok, rev = orig(self, key, value, lease)
        if ok and not lost and key.startswith(b"/registry/pods/"):
            lost.append(key)
            self.t.backend.delete(key)  # behind the acknowledgement
        return ok, rev

    monkeypatch.setattr(chip_smoke.InProcessClient, "create", losing)
    with pytest.raises(AssertionError, match="acknowledged-write check"):
        chip_smoke.replay_phase(replay_args(), CPU, replay_spec())
    assert lost


def test_replay_phase_catches_a_dropped_watch_event(shims, replay_flags,
                                                    monkeypatch):
    """One event kept from one namespace watcher fails (k)."""
    orig = chip_smoke.NotifyingQueue._put
    dropped = []

    def lossy(self, item):
        w = getattr(self, "watch", None)
        if not dropped and w is not None and not w.broad \
                and isinstance(item, list) and item:
            dropped.append(item[0].revision)
            item = item[1:]
            if not item:
                return
        orig(self, item)

    monkeypatch.setattr(chip_smoke.NotifyingQueue, "_put", lossy)
    with pytest.raises(AssertionError, match="the oracle"):
        chip_smoke.replay_phase(replay_args(), CPU, replay_spec())
    assert dropped


def test_replay_phase_fails_when_k2_never_launches(shims, replay_flags,
                                                   monkeypatch):
    """With the scheduler's batching off no query batch reaches K2, and (k)
    fails on K2's zero count (the batching bound lifted, so that it is the
    launch check that fails)."""
    monkeypatch.setattr(chip_smoke, "CLI_FLAGS",
                        chip_smoke.CLI_FLAGS + ("--sched-batch", "1"))
    with pytest.raises(AssertionError, match=r"never launched \['scan_mask_q'\]"):
        chip_smoke.replay_phase(replay_args(), CPU,
                                replay_spec(bounds=SLOBounds()))


def test_replay_phase_catches_a_lincheck_violation(shims, replay_flags,
                                                   monkeypatch):
    """A point read that returns a value no write wrote fails (k)."""
    orig = chip_smoke.ReplayHistory.record
    bad = []

    def stale(self, kind, key, call, ret, **kw):
        if kind == "get" and kw.get("ok") and not bad:
            bad.append(key)
            kw["value"] = b"a value no write wrote"
        orig(self, kind, key, call, ret, **kw)

    monkeypatch.setattr(chip_smoke.ReplayHistory, "record", stale)
    with pytest.raises(AssertionError, match="not linearizable"):
        chip_smoke.replay_phase(replay_args(), CPU, replay_spec())
    assert bad


def test_prom_text_is_what_the_report_reads():
    """The sink rendered as the Prometheus exposition: counters with
    ``_total``, histograms as cumulative buckets with count and sum,
    gauges sampled, a gone gauge skipped."""
    sink = chip_smoke.RecordingMetrics()
    sink.emit_counter("kb.watch.dropped", 2)
    sink.emit_counter("kb.lease.granted.total", 3)
    for v in (0.002, 0.02, 20.0):
        sink.emit_histogram("kb.watch.lag.seconds", v, point="queue")
    sink.register_gauge_fn("kb.watch.backlog", lambda: 4, watcher="7")

    def gone():
        raise LookupError

    sink.register_gauge_fn("kb.watch.backlog", gone, watcher="8")
    snap = chip_smoke.slo.parse_prom(chip_smoke.prom_text(sink))
    slo = chip_smoke.slo
    assert slo.series_sum(snap, "kb_watch_dropped_total") == 2
    assert slo.series_sum(snap, "kb_lease_granted_total") == 3
    assert slo.hist_count_sum(snap, "kb_watch_lag_seconds",
                              point="queue") == (3, 20.022)
    assert slo.hist_quantile(snap, "kb_watch_lag_seconds", 0.99,
                             point="queue") == 10.0
    assert slo.series_count(snap, "kb_watch_backlog") == 1


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
        chip_smoke.programs_phase(backend, store, top, args.keys, args.seed,
                                  CPU, "cpu (rehearsal)")
        t2n = time.perf_counter()
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
          f"{t2 - t1}, programs {t2n - t2}, compaction phase {t3 - t2n}, "
          f"fan-out phase {t4 - t3}, "
          f"deployed engines {t5 - t4}, chaos {t6 - t5}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
