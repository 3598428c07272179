"""Block-batched fan-out in the port, on the CPU: the counterparts of
``tests/test_fanout_device.py`` and ``tests/test_fanout_integration.py``
with ``device="cpu"`` (the persistent watcher table and the
one-dispatch-per-block matcher held byte-identical to the brute-force
raw-bytes oracle and to the hub's segment index, under churn, NUL-bearing
bounds and version regression; the hub and the Backend routed through the
matcher), plus a three-way differential against the JAX ``DeviceFanout``.

The JAX tests that need a multi-device mesh
(``test_sharded_wat_table_byte_identical``,
``test_table_capacity_rounds_to_device_multiple``,
``test_matcher_with_sharded_watcher_table``) wait for multi-GPU support."""

import queue
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
from kubebrain_tpu.backend.common import WatchEvent as JWatchEvent  # noqa: E402
from kubebrain_tpu.fanout.matcher import DeviceFanout as JDeviceFanout  # noqa: E402
from kubebrain_tpu_torch import coder  # noqa: E402
from kubebrain_tpu_torch.backend.common import WatchEvent  # noqa: E402
from kubebrain_tpu_torch.backend.watcherhub import (  # noqa: E402
    ProgressMarker,
    WatcherHub,
    _RangeIndex,
)
from kubebrain_tpu_torch.fanout import DeviceFanout, match_oracle  # noqa: E402
from kubebrain_tpu_torch.fanout.dispatch import max_block_events  # noqa: E402
from kubebrain_tpu_torch.fanout.table import MIN_WIDTH, WatcherTable  # noqa: E402
from kubebrain_tpu_torch.ops import fanout as fanout_ops  # noqa: E402
from kubebrain_tpu_torch.ops import fanout_kernels  # noqa: E402
from kubebrain_tpu_torch.ops.fanout import FanoutMatcher, compact_flat  # noqa: E402


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


def _events(rng, n, rev0=100, keymaker=None):
    keymaker = keymaker or (
        lambda i: b"/registry/%s/ns%02d/obj-%03d" % (
            (b"pods", b"leases")[rng.randint(2)], rng.randint(16),
            rng.randint(64)))
    return [WatchEvent(revision=rev0 + i, key=keymaker(i), value=b"v")
            for i in range(n)]


def _population(rng, n, wid0=0):
    specs = []
    for w in range(n):
        roll = rng.rand()
        if roll < 0.1:  # single-key watch: end carries a NUL
            key = b"/registry/pods/ns%02d/obj-%03d" % (rng.randint(16),
                                                       rng.randint(64))
            specs.append((wid0 + w, key, key + b"\x00", int(rng.randint(3))))
        elif roll < 0.2:  # unbounded from-key watch
            specs.append((wid0 + w, b"/registry/p", b"", int(rng.randint(3))))
        else:
            start = b"/registry/%s/ns%02d/" % ((b"pods", b"leases")[
                rng.randint(2)], rng.randint(16))
            specs.append((wid0 + w, start, coder.prefix_end(start),
                          int(rng.randint(0, 110))))
    return specs


def _deliver_via_index(events, specs):
    """The hub's segment-index path as an oracle: interval stabbing +
    min_rev filter, batch order per watcher."""
    filters = {wid: (s, e, r) for wid, s, e, r in specs}
    index = _RangeIndex(filters)
    assert not index.dense
    out = {}
    for ev in events:
        for wid in index.lookup(ev.key):
            if ev.revision >= filters[wid][2]:
                out.setdefault(wid, []).append(ev)
    return out


def _cpu_fanout(**kw):
    return DeviceFanout(device="cpu", **kw)


def test_block_deliver_identity_under_churn():
    """segment-index vs device vs brute-force byte-identity while the
    watcher set churns (adds, deletes, filter rewrites) across blocks."""
    rng = np.random.RandomState(3)
    matcher = _cpu_fanout()
    specs = _population(rng, 70)
    version = 1
    for round_ in range(5):
        events = _events(rng, 48, rev0=90 + 30 * round_)
        mask = matcher(events, specs, version=version)
        assert (mask == match_oracle(events, specs)).all(), round_
        got = _cpu_fanout().deliver(events, specs, version=1)
        bounded = [s for s in specs if s[2]]
        got_bounded = {wid: evs for wid, evs in got.items()
                       if wid in {w for w, *_ in bounded}}
        assert got_bounded == _deliver_via_index(events, bounded), round_
        keep = [s for s in specs if rng.rand() > 0.3]
        rewritten = [
            (wid, s, e, int(rng.randint(0, 140))) if rng.rand() < 0.3
            else (wid, s, e, r)
            for wid, s, e, r in keep
        ]
        specs = rewritten + _population(rng, 12, wid0=1000 + 100 * round_)
        version += 1
    assert matcher.stats["blocks"] == 0  # the mask protocol counts no blocks
    assert matcher.stats["dispatches"] >= 5


def test_block_deliver_matches_legacy_mask_protocol():
    rng = np.random.RandomState(5)
    specs = _population(rng, 40)
    events = _events(rng, 32)
    matcher = _cpu_fanout()
    delivered = matcher.deliver(events, specs, version=7)
    mask = match_oracle(events, specs)
    want = {}
    for j, (wid, *_rest) in enumerate(specs):
        evs = [events[i] for i in np.flatnonzero(mask[:, j])]
        if evs:
            want[wid] = evs
    assert delivered == want
    assert matcher.stats["blocks"] == 1


def test_nul_bound_single_key_watch():
    """Single-key watches (end = key + b"\\0") deliver exactly their key;
    the NUL appears only in BOUNDS, which canonicalize_bound rewrites to
    sit strictly between the key and every longer NUL-free key."""
    base = b"/registry/pods/ns00/obj-007"
    specs = [
        (1, base, base + b"\x00", 0),          # watches base only
        (2, base, coder.prefix_end(base), 0),  # prefix: base + extensions
        (3, base + b"\x00", b"", 0),           # from strictly-after base
    ]
    events = [
        WatchEvent(revision=10, key=base, value=b"v"),
        WatchEvent(revision=11, key=base + b"0", value=b"v"),  # obj-0070
        WatchEvent(revision=12, key=b"/registry/pods/ns00/obj-008",
                   value=b"v"),
    ]
    matcher = _cpu_fanout()
    mask = matcher(events, specs, version=1)
    assert (mask == match_oracle(events, specs)).all()
    got = _cpu_fanout().deliver(events, specs, version=1)
    assert [e.revision for e in got[1]] == [10]
    assert [e.revision for e in got[2]] == [10, 11]
    assert [e.revision for e in got[3]] == [11, 12]


def test_progress_mark_ordering_across_block_delivery():
    """post_progress after a block stream lands AFTER every event of the
    block on the subscriber queue, with the hub routed through the block
    path."""
    matcher = _cpu_fanout()
    hub = WatcherHub(fanout_matcher=matcher)
    assert hub.prefers_blocks
    qs = {}
    for i in range(8):
        start = b"/registry/pods/ns%02d/" % i
        wid, q = hub.add_watcher(start, coder.prefix_end(start), 0)
        qs[wid] = (q, i)
    # 8 watchers x 512 events >= 4096 pairs -> device path on a CPU matcher
    batch = [
        WatchEvent(revision=100 + i,
                   key=b"/registry/pods/ns%02d/obj-%03d" % (i % 8, i),
                   value=b"v")
        for i in range(512)
    ]
    hub.stream(batch)
    assert matcher.stats["blocks"] == 1
    top = max(e.revision for e in batch)
    for wid in qs:
        hub.post_progress(wid, top)
    for wid, (q, ns) in qs.items():
        got = []
        while not q.empty():
            got.append(q.get_nowait())
        *event_batches, marker = got
        assert isinstance(marker, ProgressMarker) and marker.revision == top
        revs = [e.revision for b in event_batches for e in b]
        assert revs == sorted(revs)
        assert revs == [e.revision for e in batch if e.key.startswith(
            b"/registry/pods/ns%02d/" % ns)]
    hub.close()


@pytest.mark.parametrize("make", [_cpu_fanout,
                                  lambda: FanoutMatcher(device="cpu")],
                         ids=["DeviceFanout", "FanoutMatcher"])
def test_version_regression_rebuilds_packed_state(make):
    """A restarted hub reuses watcher-set versions from 0: a version that
    moves BACKWARD with different specs must not serve the dead
    population's packed table."""
    rng = np.random.RandomState(23)
    old = _population(rng, 30)
    new = _population(rng, 30, wid0=2000)
    events = _events(rng, 16)
    matcher = make()
    m5 = matcher(events, old, version=5)
    assert (m5 == match_oracle(events, old)).all()
    m2 = matcher(events, new, version=2)  # regression + new population
    assert (m2 == match_oracle(events, new)).all()


class _GaugeRecorder:
    def __init__(self):
        self.gauges = {}
        self.fns = {}

    def emit_gauge(self, name, value, **tags):
        self.gauges[name] = value

    def register_gauge_fn(self, name, fn, **tags):
        self.fns[name] = fn


@pytest.mark.parametrize("cls", [DeviceFanout, FanoutMatcher])
def test_fanout_sharded_gauge(cls):
    """kb.fanout.sharded reads 0: the port's watcher table lives on one
    device, and the legacy matcher refuses a mesh until multi-GPU."""
    rec = _GaugeRecorder()
    cls(device="cpu").set_metrics(rec)
    assert rec.gauges["kb.fanout.sharded"] == 0.0
    assert rec.fns["kb.fanout.sharded"]() == 0.0
    if cls is FanoutMatcher:
        with pytest.raises(NotImplementedError):
            FanoutMatcher(mesh=object(), device="cpu")


def test_matchers_without_a_card_raise(monkeypatch):
    """``device=None`` means cuda: without a card the matchers raise, and
    never quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DeviceFanout, FanoutMatcher, WatcherTable):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------- table units
def test_table_capacity_buckets():
    t = WatcherTable(device="cpu")
    assert t._capacity_for(1) == 64       # MIN_CAPACITY
    assert t._capacity_for(65) == 128     # pow2 to 1024
    assert t._capacity_for(1024) == 1024
    assert t._capacity_for(1025) == 2048  # 1024-step buckets beyond
    assert t._capacity_for(10_016) == 10_240
    assert t._capacity_for(10_241) == 11_264
    s = t.stats()
    assert s["devices"] == 1 and s["sharded"] is False and s["capacity"] == 64


def test_table_width_grows_with_population():
    t = WatcherTable(device="cpu")
    assert t.width == MIN_WIDTH
    t.sync([(1, b"/registry/a/", b"/registry/b", 0)], version=1)
    assert t.width == MIN_WIDTH
    epoch0 = t.stats()["epoch"]
    long_start = b"/registry/pods/" + b"n" * 40 + b"/"
    specs = [(1, b"/registry/a/", b"/registry/b", 0),
             (2, long_start, coder.prefix_end(long_start), 0)]
    t.sync(specs, version=2)
    assert t.width == 64  # pow2 over the longest bound + margin
    assert t.stats()["epoch"] > epoch0  # growth = full republish
    m = _cpu_fanout()
    events = [WatchEvent(revision=5, key=long_start + b"x", value=b"v"),
              WatchEvent(revision=6, key=b"/registry/aa", value=b"v")]
    assert (m(events, specs, version=1) == match_oracle(events, specs)).all()


def test_table_explicit_width_is_pinned():
    t = WatcherTable(width=32, device="cpu")
    with pytest.raises(ValueError):
        t.sync([(1, b"/k" * 40, b"", 0)], version=1)
    assert t.width == 32


def test_table_publishes_dirty_rows_only():
    """After the first publish a churn sync republishes only the rows it
    changed, into the same device columns, and they equal a fresh full
    publish of the same population; freed rows hold the sentinel."""
    rng = np.random.RandomState(17)
    t = WatcherTable(device="cpu")
    specs = _population(rng, 50)
    t.sync(specs, version=1)
    first = t.device_view()
    epoch = t.stats()["epoch"]
    churned = specs[5:] + _population(rng, 3, wid0=900)
    t.sync(churned, version=2)
    assert 0 < t.stats()["dirty"] < len(churned)
    view = t.device_view()
    assert t.stats()["epoch"] == epoch and t.stats()["dirty"] == 0
    assert all(a is b for a, b in zip(view[:4], first[:4]))  # in place
    full = WatcherTable(device="cpu")
    full.sync(churned, version=2)
    want = full.device_view()
    order = np.argsort(view[4])
    want_order = np.argsort(want[4])
    assert (view[4][order] == want[4][want_order]).all()
    for got_col, want_col in zip(view[:4], want[:4]):
        assert torch.equal(got_col[order], want_col[want_order])


def test_event_side_width_growth():
    """A long EVENT key (not watcher bound) also grows the auto width —
    the kernel compares chunk for chunk at one width."""
    m = _cpu_fanout()
    specs = [(1, b"/registry/", b"", 0)]
    long_key = b"/registry/" + b"x" * 80
    events = [WatchEvent(revision=5, key=long_key, value=b"v")]
    got = m.deliver(events, specs, version=1)
    assert [e.key for e in got[1]] == [long_key]
    assert m.table.width >= len(long_key) + 2


def test_overflow_regrows_index_bucket():
    """A drain whose matches exceed the compacted-index bucket re-dispatches
    with a doubled bucket — and still delivers every pair."""
    rng = np.random.RandomState(31)
    m = _cpu_fanout()
    m._idx_size = 8  # force an immediate overflow
    specs = [(w, b"/registry/", b"", 0) for w in range(16)]  # all match all
    events = _events(rng, 16)
    got = m.deliver(events, specs, version=1)
    assert m.stats["redispatches"] >= 1
    assert m._idx_size >= 16 * 16
    for w in range(16):
        assert [e.revision for e in got[w]] == [e.revision for e in events]


@pytest.mark.parametrize("capacity,events", [
    (64, 1 << 24), (10_240, 1 << 17), (100_352, 1 << 14), (1 << 30, 1)])
def test_max_block_events(capacity, events):
    """The longest pow2 E bucket whose flat indices stay within int32."""
    assert max_block_events(capacity) == events
    assert capacity * events <= fanout_ops.MAX_FLAT < capacity * events * 2


@pytest.mark.parametrize("n_events", [300, 1000])
def test_hub_splits_a_block_past_the_int32_flat_index(monkeypatch, n_events):
    """A drain block whose padded E over the table's capacity passes the
    int32 flat index (a backlog behind a slow drainer: the Backend hands a
    block matcher whole drain blocks of up to the ring's size) is matched
    in pieces: every watcher gets exactly match_oracle's events, in
    revision order, and no exception unwinds the drain. The limit is
    lowered so that the 64-slot table takes 32 events per piece."""
    monkeypatch.setattr(fanout_ops, "MAX_FLAT", 64 * 32)
    rng = np.random.RandomState(n_events)
    specs = _population(rng, 60)  # < 64 watchers: the hub has no index
    events = _events(rng, n_events, rev0=50)
    cols = WatcherTable(device="cpu")
    cols.sync(specs, version=1)
    ws, we, wu, wr, _wids, _v = cols.device_view()
    ek = torch.zeros((512, ws.shape[1]), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 flat index"):
        fanout_kernels.fanout_dispatch(ek, torch.zeros(512, dtype=torch.int64),
                                       n_events, ws, we, wu, wr, 128)
    matcher = _cpu_fanout()
    hub = WatcherHub(fanout_matcher=matcher)
    queues = {}
    for wid, s, e, r in specs:
        hid, q = hub.add_watcher(s, e, r)
        queues[hid] = (q, (hid, s, e, r))
    hub.stream(events)
    assert matcher.stats["blocks"] == 1
    assert matcher.stats["dispatches"] >= -(-n_events // 32)
    live = [spec for _q, spec in queues.values()]
    mask = match_oracle(events, live)
    for j, (q, _spec) in enumerate(queues.values()):
        want = [events[i].revision for i in np.flatnonzero(mask[:, j])]
        assert _drain(q) == want
    assert (matcher(events, live, version=99) == mask).all()
    hub.close()


def test_compact_unit():
    rng = np.random.RandomState(41)
    for n, density, size in ((256, 0.5, 256), (4096, 0.01, 64),
                             (4096, 0.0, 16), (512, 1.0, 1024)):
        flat = rng.rand(n) < density
        out = compact_flat(torch.from_numpy(flat), size).numpy()
        ref = np.flatnonzero(flat)
        k = min(size, len(ref))
        assert (out[:k] == ref[:k]).all(), (n, density, size)
        assert (out[k:] == n).all(), "fill must be len(flat)"


def test_hub_block_path_drops_slow_consumer():
    """The block route honors the drop protocol: a full subscriber queue
    still gets flagged + poisoned, never silently skipped."""
    matcher = _cpu_fanout()
    hub = WatcherHub(fanout_matcher=matcher)
    small = lambda maxsize: queue.Queue(maxsize=1)
    wid, q = hub.add_watcher(b"/registry/", b"", 0, queue_factory=small)
    for i in range(7):
        s = b"/registry/pods/ns%02d/" % i
        hub.add_watcher(s, coder.prefix_end(s), 0)
    batch = [WatchEvent(revision=100 + i, key=b"/registry/pods/ns00/o%03d" % i,
                        value=b"v") for i in range(512)]
    hub.stream(batch)   # fills wid's 1-slot queue
    hub.stream([WatchEvent(revision=1000 + i, key=b"/registry/x%03d" % i,
                           value=b"v") for i in range(512)])  # overflows it
    assert wid not in hub.watcher_ids()
    assert getattr(q, "kb_dropped", False)
    assert matcher.stats["blocks"] == 2
    hub.close()


def _drain(q):
    out = []
    while not q.empty():
        item = q.get_nowait()
        if item:
            out.extend(e.revision for e in item)
    return out


def test_hub_vectorized_matches_python_filter():
    rng = np.random.RandomState(0)
    hub_vec = WatcherHub(fanout_matcher=FanoutMatcher(device="cpu"))
    hub_ref = WatcherHub()  # python filtering
    prefixes = [b"/registry/pods/ns%02d/" % i for i in range(64)]
    queues_vec, queues_ref = {}, {}
    for p in prefixes:
        end = coder.prefix_end(p)
        queues_vec[p] = hub_vec.add_watcher(p, end, 0)[1]
        queues_ref[p] = hub_ref.add_watcher(p, end, 0)[1]
    single = b"/registry/pods/ns03/pod-007"
    _, qv_single = hub_vec.add_watcher(single, single + b"\x00", 0)
    _, qr_single = hub_ref.add_watcher(single, single + b"\x00", 0)
    batch = [
        WatchEvent(revision=i + 1, key=b"/registry/pods/ns%02d/pod-%03d" % (
            rng.randint(64), rng.randint(10)))
        for i in range(128)
    ]
    hub_vec.stream(batch)  # 65 watchers x 128 events > 4096 -> kernel path
    hub_ref.stream(batch)
    for p in prefixes:
        assert _drain(queues_vec[p]) == _drain(queues_ref[p]), p
    assert _drain(qv_single) == _drain(qr_single)


class _CudaStub:
    """A block matcher that says it lives on a CUDA device and records the
    blocks it is handed (no card needed): the hub's routing rule only."""

    prefers_blocks = True
    device = torch.device("cuda")

    def __init__(self):
        self.blocks = 0

    def deliver(self, batch, specs, version=None):
        self.blocks += 1
        mask = match_oracle(batch, specs)
        return {wid: [batch[i] for i in np.flatnonzero(mask[:, j])]
                for j, (wid, *_r) in enumerate(specs) if mask[:, j].any()}


@pytest.mark.parametrize("n_events,routed", [(5, False), (20, True)])
def test_hub_routes_a_cuda_matcher_by_pair_count(n_events, routed):
    """A population the interval index serves (not dense) goes to a CUDA
    matcher only from DEVICE_PAIRS (watchers x events) on; a CPU matcher
    never takes it. The threshold is lowered on the instance, so 100
    watchers cross it at 10 events."""
    assert WatcherHub.DEVICE_PAIRS == 1_000_000
    specs = [(b"/registry/pods/ns%05d/" % i) for i in range(100)]
    batch = [WatchEvent(revision=1 + i, key=specs[i * 3] + b"x")
             for i in range(n_events)]
    for stub, want in ((_CudaStub(), routed), (_cpu_fanout(), False)):
        hub = WatcherHub(fanout_matcher=stub)
        hub.DEVICE_PAIRS = 1000
        queues = [hub.add_watcher(p, coder.prefix_end(p), 0)[1] for p in specs]
        hub.stream(batch)
        got_blocks = (stub.blocks if isinstance(stub, _CudaStub)
                      else stub.stats["blocks"])
        assert got_blocks == int(want)
        assert sum(len(_drain(q)) for q in queues) == n_events
        hub.close()


def _three_way_round(port, jax_matcher, events, specs, version):
    got = port.deliver(events, specs, version=version)
    jevents = [JWatchEvent(revision=e.revision, key=e.key, value=e.value)
               for e in events]
    jgot = jax_matcher.deliver(jevents, specs, version=version)
    mask = match_oracle(events, specs)
    want = {wid: [events[i].revision for i in np.flatnonzero(mask[:, j])]
            for j, (wid, *_r) in enumerate(specs) if mask[:, j].any()}
    revs = lambda d: {w: [e.revision for e in evs] for w, evs in d.items()}
    assert revs(got) == want
    assert revs(jgot) == want
    return sum(len(v) for v in want.values())


def test_three_way_differential_bench_population():
    """The port's DeviceFanout.deliver against the JAX DeviceFanout.deliver
    against match_oracle, on the bench population (2,000 watchers, 20
    broad; single-key watches with NUL bounds) x 256 events, under three
    rounds of churn (drops, min_rev rewrites, new watchers)."""
    rng = np.random.RandomState(2024)
    specs = bench._fanout_population(2000, 20, rng)
    port, jax_matcher = _cpu_fanout(), JDeviceFanout()
    pairs = 0
    for round_ in range(3):
        jev = bench._fanout_events(256, 100 + 300 * round_, rng)
        events = [WatchEvent(revision=e.revision, key=e.key, value=e.value)
                  for e in jev]
        pairs += _three_way_round(port, jax_matcher, events, specs, round_ + 1)
        keep = [s for s in specs if rng.rand() > 0.2]
        rewritten = [(w, s, e, int(rng.randint(0, 600)))
                     if rng.rand() < 0.2 else (w, s, e, r)
                     for w, s, e, r in keep]
        fresh = bench._fanout_population(300, 3, rng)
        specs = rewritten + [(5000 + 300 * round_ + w, s, e, r)
                             for w, s, e, r in fresh]
    assert pairs > 10_000
    assert port.stats["blocks"] == 3 and port.stats["pairs"] == pairs


@pytest.mark.parametrize("make", [_cpu_fanout,
                                  lambda: FanoutMatcher(device="cpu")],
                         ids=["DeviceFanout", "FanoutMatcher"])
def test_backend_with_vectorized_fanout(make):
    from kubebrain_tpu_torch.backend import Backend, BackendConfig
    from kubebrain_tpu_torch.storage import new_storage

    store = new_storage("memkv")
    matcher = make()
    b = Backend(store, BackendConfig(event_ring_capacity=2048,
                                     fanout_matcher=matcher))
    assert b._hub_blocks is isinstance(matcher, DeviceFanout)
    wid, q = b.watch(b"/registry/pods/")
    b.create(b"/registry/pods/a", b"v")
    b.create(b"/registry/other", b"x")
    batch = q.get(timeout=5)
    assert [e.key for e in batch] == [b"/registry/pods/a"]
    b.close()
    store.close()
