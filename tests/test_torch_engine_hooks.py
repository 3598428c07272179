"""The ``cuda`` engine's hooks for metrics and chaos injection on the CPU
(``device="cpu"``), each held against the JAX package's ``tpu`` engine on
the same operations: ``TorchScanner.register_metrics`` (gauges registered,
sampled, then unregistered at ``close``), ``encoding_stats``,
``set_fault_plane`` with its four check sites (merge failure, merge
suppression, forced EncodeOverflow, compaction failure) and
``_DeltaIndex.force_overflow``. The planes are stubs with the fault plane's
six methods.

Divergences, stated where a field is compared:

- ``full_rebuild_total``: the port counts the first publish of a mirror
  from the store, the JAX engine does not; the tests compare its movement
  after the healthy publish, which must agree.
- the byte gauges: the JAX engine reports one series per mesh device, the
  port one for its one device; the tests compare what each says about the
  key encoding (the raw-equivalent minus the stored bytes), which depends
  on the rows, not on the partitioning.
- ``mirror_bytes_per_row_padded``: the JAX mirror has one partition per
  mesh device, the port one, so their pow2 capacities differ; the padded
  figure is checked against each mirror's own capacity.
"""

import time

import pytest

from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.backend import wait_for_revision as j_wait
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu.storage.tpu.engine import _DeltaIndex as JDelta
from kubebrain_tpu_torch import coder
from kubebrain_tpu_torch.backend import Backend as TBackend
from kubebrain_tpu_torch.backend import BackendConfig as TConfig
from kubebrain_tpu_torch.backend import wait_for_revision as t_wait
from kubebrain_tpu_torch.storage import new_storage as t_new_storage
from kubebrain_tpu_torch.storage.cuda.engine import _DeltaIndex

def make_backend(engine: str, encode: bool = True, merge_threshold: int = 64):
    """(backend, store) of the port's ``cuda`` engine on the CPU or the
    JAX package's ``tpu`` engine, over memkv, always on the device path."""
    if engine == "cuda":
        store = t_new_storage("cuda", inner="memkv", device="cpu",
                              encode_keys=encode,
                              merge_threshold=merge_threshold)
        b = TBackend(store, TConfig(event_ring_capacity=8192))
    else:
        store = j_new_storage("tpu", inner="memkv", encode_keys=encode,
                              merge_threshold=merge_threshold)
        b = JBackend(store, JConfig(event_ring_capacity=8192))
    b.scanner._host_limit_threshold = 0
    return b, store


class Pair:
    """The port's backend and the JAX one, driven with the same calls."""

    def __init__(self, encode: bool = True, merge_threshold: int = 64):
        self.port, self._ps = make_backend("cuda", encode, merge_threshold)
        self.jax, self._js = make_backend("tpu", encode, merge_threshold)

    def both(self):
        return (self.port, self.jax)

    def close(self):
        for b in self.both():
            b.close()
        self._ps.close()
        self._js.close()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def rows(b, start=b"/registry/", end=b"/registry0"):
    return [(kv.key, kv.value, kv.revision)
            for kv in b.list_(start, end).kvs]


def load(b, n: int, prefix: bytes = b"/registry/pods/ns-%02d/pod-%05d"):
    for i in range(n):
        b.create(prefix % (i % 4, i), b"v%d" % i)


def churn(b, n_keys: int = 60):
    """Superseded chains, tombstoned chains and singletons (the victim mix
    of ``tests/test_compact_device.py``): the live key → revision map and
    the last revision."""
    live, last = {}, 0
    for i in range(n_keys):
        k = b"/registry/pods/p%04d" % i
        r = b.create(k, b"v0")
        if i % 3 == 0:
            for j in range(3):
                r = b.update(k, b"v%d" % (j + 1), r)
            live[k] = r
        elif i % 3 == 1:
            r, _ = b.delete(k, r)
        else:
            live[k] = r
        last = max(last, r)
    wait = t_wait if isinstance(b, TBackend) else j_wait
    assert wait(b, last)
    return live, last


def wait_serving(scanner, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and scanner._mirror_state != "serving":
        time.sleep(0.02)
    assert scanner._mirror_state == "serving", "the rebuild never completed"


class Plane:
    """A stub fault plane: each decision a fixed answer or a countdown of
    True answers; counts the suppressed merges and the compaction rolls."""

    def __init__(self, merge_fail=0, suppress=False, overflow=0,
                 compact_fail=0):
        self.merge_fail = merge_fail
        self.suppress = suppress
        self.overflow = overflow
        self.compact_fail = compact_fail
        self.suppressed = 0
        self.compact_rolls = 0

    @staticmethod
    def _take(n):
        return n > 0, n - 1 if n > 0 else 0

    def merge_fault(self):
        hit, self.merge_fail = self._take(self.merge_fail)
        return hit

    def merge_fail_active(self):
        return self.merge_fail > 0

    def merges_suppressed(self):
        return self.suppress

    def note_suppressed_merge(self):
        self.suppressed += 1

    def encode_overflow(self):
        hit, self.overflow = self._take(self.overflow)
        return hit

    def compact_fault(self):
        self.compact_rolls += 1
        hit, self.compact_fail = self._take(self.compact_fail)
        return hit


class FakeRegistry:
    """The metrics surface the engine uses: callback gauges by (name,
    tags), and a record of every registration and unregistration."""

    def __init__(self):
        self.gauges = {}
        self.registered = []
        self.unregistered = []

    @staticmethod
    def _key(name, tags):
        return name, tuple(sorted(tags.items()))

    def register_gauge_fn(self, name, fn, **tags):
        self.gauges[self._key(name, tags)] = fn
        self.registered.append(self._key(name, tags))

    def unregister_gauge_fn(self, name, **tags):
        self.unregistered.append(self._key(name, tags))
        del self.gauges[self._key(name, tags)]

    def sample(self, name):
        return {tags: fn() for (n, tags), fn in self.gauges.items()
                if n == name}


# ------------------------------------------------------------ force_overflow
@pytest.mark.parametrize("cls", [_DeltaIndex, JDelta], ids=["port", "jax"])
def test_force_overflow_marks_the_delta(cls):
    """A forced overflow shows in the merge's snapshot, as an
    inexpressible key would, and rows recorded after it still seal."""
    d = cls(64, seal_rows=4)
    d.extend([(b"/a/%d" % i, 10 + i, b"v") for i in range(6)])
    assert d.snapshot_blocks()[2] is False
    d.force_overflow()
    d.extend([(b"/b/%d" % i, 20 + i, b"v") for i in range(5)])
    blocks, prefix, overflowed = d.snapshot_blocks()
    assert overflowed is True and len(prefix) == 11
    assert sum(len(blk[2]) for blk in blocks) == 11


# --------------------------------------------------------- register_metrics
@pytest.mark.parametrize("encode", [True, False], ids=["encoded", "raw"])
def test_register_metrics_gauges_then_unregistered_at_close(encode):
    """Every gauge of ``register_metrics`` is registered, reads the live
    mirror, and is unregistered at close; the state gauges follow the
    mirror's state machine with exactly one series at 1."""
    b, store = make_backend("cuda", encode)
    reg = FakeRegistry()
    try:
        load(b, 300)
        rows(b)  # publishes the mirror
        b.scanner.register_metrics(reg)
        names = sorted(n for n, _t in reg.registered)
        assert names == ["kb.mirror.bytes", "kb.mirror.raw.bytes"] + [
            "kb.mirror.state"] * 3
        assert reg.sample("kb.mirror.state") == {
            (("state", "serving"),): 1.0, (("state", "quarantined"),): 0.0,
            (("state", "rebuilding"),): 0.0}
        (dev_tags, stored), = reg.sample("kb.mirror.bytes").items()
        assert dev_tags == (("device", "cpu"),)
        raw = reg.sample("kb.mirror.raw.bytes")[dev_tags]
        m = b.scanner._mirror
        want = sum(t.numel() * t.element_size() for t in (
            m.keys_dev, m.revs_dev, m.tomb_dev, m.ttl_dev, m.n_valid_dev))
        assert stored == want
        assert (raw > stored) if encode else (raw == stored)
        sc = b.scanner
        # hold the single-flight rebuild off, so the state stays put
        assert sc._rebuild_kick.acquire(blocking=False)
        try:
            sc.mark_uncertain()
            assert reg.sample("kb.mirror.state") == {
                (("state", "serving"),): 0.0,
                (("state", "quarantined"),): 1.0,
                (("state", "rebuilding"),): 0.0}
        finally:
            sc._rebuild_kick.release()
        rows(b)  # a degraded read kicks the rebuild again
        wait_serving(sc)
        assert reg.sample("kb.mirror.state")[(("state", "serving"),)] == 1.0
    finally:
        b.close()
        store.close()
    assert sorted(reg.unregistered) == sorted(reg.registered)
    assert not reg.gauges
    b.scanner.close()  # a second close unregisters nothing twice


def test_register_metrics_none_is_a_no_op():
    b, store = make_backend("cuda")
    try:
        b.scanner.register_metrics(None)
        assert b.scanner._gauge_regs == []
    finally:
        b.close()
        store.close()


def test_mirror_raw_bytes_gauge_exposes_compression(pair):
    """``kb.mirror.raw.bytes`` minus ``kb.mirror.bytes`` is the key
    column's saving: (raw width - stored width) per row of capacity, on
    the port's one device and summed over the JAX engine's devices alike
    (counterpart of ``tests/test_encode.py``'s gauge test)."""
    regs = []
    for b in pair.both():
        load(b, 2000)
        rows(b)
        reg = FakeRegistry()
        b.scanner.register_metrics(reg)
        regs.append(reg)
    for b, reg in zip(pair.both(), regs):
        enc = sum(reg.sample("kb.mirror.bytes").values())
        raw = sum(reg.sample("kb.mirror.raw.bytes").values())
        m = b.scanner._mirror
        stored_w = m.keys_host.shape[2] * 4
        key_bytes = m.keys_host.size * 4
        assert raw - enc == key_bytes // stored_w * m.raw_key_width - key_bytes
        assert raw > enc * 2
    assert len(regs[0].sample("kb.mirror.bytes")) == 1
    # the same rows and the same encoding: the same saving per row
    per_row = [(sum(r.sample("kb.mirror.raw.bytes").values())
                - sum(r.sample("kb.mirror.bytes").values()))
               / (b.scanner._mirror.keys_host.shape[0]
                  * b.scanner._mirror.keys_host.shape[1])
               for b, r in zip(pair.both(), regs)]
    assert per_row[0] == per_row[1]


# ----------------------------------------------------------- encoding_stats
COMPARED = ("rows", "mirror_bytes_per_row", "key_bytes_per_row",
            "raw_key_bytes_per_row", "key_compression_ratio", "encoded",
            "dict_entries", "suffix_width", "compact_count",
            "compact_victims_total", "compact_survivor_rows_total",
            "compact_retries_total", "compact_escalations_total")


@pytest.mark.parametrize("encode", [True, False], ids=["encoded", "raw"])
def test_encoding_stats_equal_the_jax_engine(encode):
    """Same keys and definitions as the JAX engine's ``encoding_stats``;
    every field equal on the same rows, the padded figure against each
    mirror's own capacity (counterpart of ``test_encoding_stats_schema``)."""
    p = Pair(encode)
    try:
        assert p.port.scanner.encoding_stats() == {}  # nothing published
        for b in p.both():
            load(b, 2000)
            rows(b)
        st, jst = (b.scanner.encoding_stats() for b in p.both())
        assert set(st) == set(jst)
        assert {k: st[k] for k in COMPARED} == {k: jst[k] for k in COMPARED}
        assert st["rows"] == 2000 and st["encoded"] is encode
        if encode:
            assert st["key_compression_ratio"] >= 4.0
            assert st["key_bytes_per_row"] * st["key_compression_ratio"] == \
                pytest.approx(st["raw_key_bytes_per_row"], rel=1e-3)
        else:
            assert st["key_compression_ratio"] == 1.0
        for b, s in zip(p.both(), (st, jst)):
            m = b.scanner._mirror
            cap = m.keys_host.shape[0] * m.keys_host.shape[1]
            assert s["mirror_bytes_per_row_padded"] == round(
                s["mirror_bytes_per_row"] * cap / s["rows"], 2)
    finally:
        p.close()


def test_encoding_stats_count_a_compaction(pair):
    """After one compaction of the same churn, the compaction fields agree
    with the JAX engine's, survivors included."""
    for b in pair.both():
        live, last = churn(b)
        b.scanner.publish()
        lo, hi = coder.internal_range(b"", b"")
        b.scanner.compact(lo, hi, last)
        assert {kv.key: kv.revision for kv in b.list_(
            b"/registry/", b"/registry0").kvs} == live
    st, jst = (b.scanner.encoding_stats() for b in pair.both())
    assert st["compact_count"] == 1 and st["compact_victims_total"] > 0
    assert st["compact_survivor_rows_total"] == len(live)
    assert {k: st[k] for k in COMPARED} == {k: jst[k] for k in COMPARED}


# -------------------------------------------------- set_fault_plane: compact
@pytest.mark.parametrize("fail_times", [1, 2])
def test_compact_retry_then_recover(pair, fail_times):
    """A transiently failing mirror half retries and lands the stored-
    domain merge on a later attempt: no escalation, no rebuild. The same
    mirror path and counts as the JAX engine (counterpart of
    ``tests/test_compact_device.py``)."""
    got = []
    for b in pair.both():
        sc = b.scanner
        live, last = churn(b)
        sc.publish()
        rebuilds = sc.full_rebuild_total
        plane = Plane(compact_fail=fail_times)
        sc.set_fault_plane(plane)
        lo, hi = coder.internal_range(b"", b"")
        stats = sc.compact(lo, hi, last)
        sc.set_fault_plane(None)
        assert {kv.key: kv.revision for kv in b.list_(
            b"/registry/", b"/registry0").kvs} == live
        got.append((stats.mirror_path, sc.compact_retries_total,
                    sc.compact_escalations_total,
                    sc.full_rebuild_total - rebuilds, plane.compact_rolls,
                    rows(b)))
    assert got[0] == got[1]
    assert got[0][:5] == ("stored_incremental", fail_times, 0, 0,
                          fail_times + 1)


def test_compact_escalates_to_quarantine_rebuild(pair):
    """Exhausted retries escalate: the mirror quarantines, reads serve the
    host store, one background rebuild recovers; the same path and counts
    as the JAX engine."""
    got = []
    for b in pair.both():
        sc = b.scanner
        sc._merge_max_retries = 2
        live, last = churn(b)
        sc.publish()
        rebuilds = sc.full_rebuild_total
        plane = Plane(compact_fail=10 ** 9)
        sc.set_fault_plane(plane)
        lo, hi = coder.internal_range(b"", b"")
        stats = sc.compact(lo, hi, last)
        sc.set_fault_plane(None)
        assert {kv.key: kv.revision for kv in b.list_(
            b"/registry/", b"/registry0").kvs} == live
        wait_serving(sc)
        assert sc.rebuild_bg_count >= 1
        got.append((stats.mirror_path, sc.compact_escalations_total,
                    sc.compact_retries_total, plane.compact_rolls,
                    sc.full_rebuild_total - rebuilds, rows(b)))
    assert got[0] == got[1]
    assert got[0][:5] == ("escalated", 1, 1, 2, 0)


# ---------------------------------------------------- set_fault_plane: merges
def test_merge_failure_bounded_retry_then_escalation(pair):
    """A persistently failing merge (the write-kicked one and the read
    path's) retries with backoff, then escalates to one rebuild from the
    store; reads equal the JAX engine's throughout."""
    for b in pair.both():
        sc = b.scanner
        sc._merge_threshold = 16
        load(b, 10, b"/t/a-%d%03d")
        baseline = rows(b, b"/t/", b"/t0")
        sc.set_fault_plane(Plane(merge_fail=10 ** 9))
        load(b, 40, b"/t/b-%d%03d")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and sc.merge_escalations_total == 0:
            time.sleep(0.02)
        assert sc.merge_bg_errors > 0 and sc.merge_retries_total >= 1
        assert sc.merge_escalations_total >= 1
        assert sc._merge_bg_last_error is not None
        wait_serving(sc)
        got = rows(b, b"/t/", b"/t0")
        assert len(got) == 50
        assert [r for r in got if r[0].startswith(b"/t/a-")] == baseline
        sc.set_fault_plane(None)
    assert rows(pair.port, b"/t/", b"/t0") == rows(pair.jax, b"/t/", b"/t0")


def test_forced_encode_overflow_takes_full_rebuild_path(pair):
    """A forced EncodeOverflow at the write feed sends the next merge to
    the rebuild from the store (one more full rebuild on both engines)."""
    moved = []
    for b in pair.both():
        sc = b.scanner
        sc._merge_threshold = 10 ** 6   # no write-kicked merge
        load(b, 8, b"/t/k-%d%03d")
        before = rows(b, b"/t/", b"/t0")
        rebuilds = sc.full_rebuild_total
        sc.set_fault_plane(Plane(overflow=1))
        load(b, 40, b"/t/o-%d%03d")
        assert sc._delta.snapshot_blocks()[2] is True
        sc.publish()
        got = rows(b, b"/t/", b"/t0")
        assert [r for r in got if r[0].startswith(b"/t/k-")] == before
        assert len(got) == 48
        moved.append((sc.full_rebuild_total - rebuilds, sc.merge_count))
        sc.set_fault_plane(None)
    assert moved[0] == moved[1] == (1, 1)


def test_merge_suppression_grows_delta_and_reads_stay_exact(pair):
    """Suppressed merges: the write feed and the reads that would have
    merged count them, the delta grows past the threshold, and overlay
    reads stay exact. Disarming the plane lets the next read merge."""
    for b in pair.both():
        sc = b.scanner
        sc._merge_threshold = 16
        load(b, 8, b"/t/k-%d%03d")
        rows(b, b"/t/", b"/t0")
        plane = Plane(suppress=True)
        sc.set_fault_plane(plane)
        load(b, 50, b"/t/s-%d%03d")
        assert plane.suppressed >= 50
        assert len(sc._delta) >= 50 and sc.merge_count == 0
        got = rows(b, b"/t/", b"/t0")
        assert len(got) == 58 and plane.suppressed >= 51
        sc.set_fault_plane(None)
        rows(b, b"/t/", b"/t0")
        assert len(sc._delta) == 0 and sc.merge_count == 1
    assert rows(pair.port, b"/t/", b"/t0") == rows(pair.jax, b"/t/", b"/t0")


def test_merge_fail_window_kicks_a_merge_below_the_threshold(pair):
    """An open merge-fail window kicks a merge on every write, below the
    threshold, so the failing merge's retries run; once it closes, the
    retried merge lands (no escalation)."""
    for b in pair.both():
        sc = b.scanner
        sc._merge_threshold = 10 ** 6
        load(b, 8, b"/t/k-%d%03d")
        rows(b, b"/t/", b"/t0")
        sc.set_fault_plane(Plane(merge_fail=1))
        b.create(b"/t/w", b"w")
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and sc.merge_count == 0:
            time.sleep(0.02)
        assert sc.merge_bg_errors == 1 and sc.merge_retries_total == 1
        assert sc.merge_count == 1 and sc.merge_escalations_total == 0
        sc.set_fault_plane(None)
    assert rows(pair.port, b"/t/", b"/t0") == rows(pair.jax, b"/t/", b"/t0")
