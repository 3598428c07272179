"""The port's write-path merge on the CPU (``device="cpu"``) against the JAX
package: the delta's stored-domain sealing and ``merge_partitions_stored`` /
``compact_partitions_stored`` give the JAX functions' host arrays exactly;
the incremental merge equals a full rebuild (the identity of
``tests/test_write_batch.py``), including the capacity-grow path; an
``EncodeOverflow`` falls back to a rebuild from the store; the merge is
write-kicked, runs off the engine lock, retries and escalates; and a
quarantined mirror serves reads from the host store while it rebuilds."""

import random
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu.storage.tpu import blocks as jblocks
from kubebrain_tpu.storage.tpu.engine import _DeltaIndex as JDelta
from kubebrain_tpu_torch.backend import Backend as TBackend
from kubebrain_tpu_torch.backend import BackendConfig as TConfig
from kubebrain_tpu_torch.backend import wait_for_revision
from kubebrain_tpu_torch.backend.scanner import Scanner
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan
from kubebrain_tpu_torch.storage import new_storage as t_new_storage
from kubebrain_tpu_torch.storage.cuda import blocks as tblocks
from kubebrain_tpu_torch.storage.cuda import engine as teng
from kubebrain_tpu_torch.storage.cuda.engine import _DeltaIndex as TDelta

WIDTH = 128
HOST_COLS = ("keys_host", "lens_host", "revs_host", "tomb_host", "ttl_host",
             "n_valid")


def version_rows(seed, n, rev0=0, keyspace=90):
    """(user key, revision, value) rows with ascending revisions over a kube
    shaped keyspace; 10% tombstones (empty values)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        k = b"/%s/ns%d/o-%03d" % (rng.choice([b"registry/pods", b"events"]),
                                  rng.randrange(3), rng.randrange(keyspace))
        out.append((k, rev0 + i + 1,
                    b"" if rng.random() < 0.1 else b"v" * rng.randrange(1, 9)))
    return out


def mirrors(base, n_parts, encode):
    """The same base rows as a JAX mirror and a port mirror."""
    j_sorted = jblocks.merge_sorted_arrays(
        jblocks.rows_to_arrays([], WIDTH), jblocks.rows_to_arrays(base, WIDTH))
    t_sorted = tblocks.merge_sorted_arrays(
        tblocks.rows_to_arrays([], WIDTH), tblocks.rows_to_arrays(base, WIDTH))
    jm = jblocks.build_mirror_from_arrays(*j_sorted, None, WIDTH, 7,
                                          n_parts=n_parts, encode=encode)
    tm = tblocks.build_mirror_from_arrays(*t_sorted, "cpu", WIDTH, 7,
                                          n_parts=n_parts, encode=encode)
    return jm, tm


def assert_same_mirror(jm, tm):
    for f in HOST_COLS:
        assert (getattr(jm, f) == getattr(tm, f)).all(), f
    for a, b in zip(jm.val_arena + jm.val_offsets, tm.val_arena + tm.val_offsets):
        assert (a == b).all()
    assert jm.max_rev == tm.max_rev
    # the device columns are the host columns in the kernel layout
    kt, rv, t8 = tscan.prepare_layout(tm.keys_host, tm.revs_host, tm.tomb_host)
    (sh,) = tm.shards
    assert (sh.keys.numpy() == kt).all() and (sh.revs.numpy() == rv).all()
    assert (sh.tomb.numpy() == t8).all()
    assert (sh.ttl.numpy() == tm.ttl_host).all()
    assert (sh.n_valid.numpy() == tm.n_valid).all()


def sealed(delta_cls, rows, encoding, seal_rows=7):
    d = delta_cls(WIDTH, encoding=encoding, seal_rows=seal_rows)
    for b0 in range(0, len(rows), 5):
        d.extend(rows[b0 : b0 + 5])
    return d


@pytest.mark.parametrize("encode", [True, False])
def test_delta_sealing_matches_reference(encode):
    base = version_rows(1, 200)
    jm, tm = mirrors(base, 1, encode)
    rows = version_rows(2, 61, rev0=200)
    jd = sealed(JDelta, rows, jm.encoding)
    td = sealed(TDelta, rows, tm.encoding)
    j_blocks, j_prefix, j_over = jd.snapshot_blocks()
    t_blocks, t_prefix, t_over = td.snapshot_blocks()
    assert j_prefix == t_prefix and j_over == t_over is False
    assert len(j_blocks) == len(t_blocks) == 9
    for jb, tb in zip(j_blocks, t_blocks):
        assert all((a == b).all() for a, b in zip(jb, tb))
    more = version_rows(3, 4, rev0=300)
    jd.extend(more)
    td.extend(more)
    assert jd.tail_rows(len(j_prefix)) == td.tail_rows(len(t_prefix)) == more
    for s, e in [(b"", b""), (b"/events/", b"/events0")]:
        assert jd.overlay(s, e, 10**6) == td.overlay(s, e, 10**6)


@pytest.mark.parametrize("encode,n_parts,delta_n", [
    (False, 1, 40), (True, 1, 40), (False, 3, 40), (True, 3, 40),
    (True, 1, 300), (False, 3, 700)])
def test_merge_partitions_stored_matches_reference(encode, n_parts, delta_n):
    """Stored-domain delta merge; the last two cases outgrow the padded
    capacity and take the memcpy grow path."""
    base = version_rows(4, 300)
    jm, tm = mirrors(base, n_parts, encode)
    (sh,) = tm.shards
    old = [t.clone() for t in (sh.keys, sh.revs, sh.tomb, sh.ttl)]
    rows = version_rows(5, delta_n, rev0=300, keyspace=400)
    j_d7 = jblocks.merge_sorted_stored(
        sealed(JDelta, rows, jm.encoding).snapshot_blocks()[0])
    t_d7 = tblocks.merge_sorted_stored(
        sealed(TDelta, rows, tm.encoding).snapshot_blocks()[0])
    assert all((a == b).all() for a, b in zip(j_d7, t_d7))
    jm2 = jblocks.merge_partitions_stored(jm, j_d7, None, 9)
    tm2 = tblocks.merge_partitions_stored(tm, t_d7, 9)
    assert_same_mirror(jm2, tm2)
    grew = tm2.keys_host.shape[1] > tm.keys_host.shape[1]
    assert grew == (delta_n >= 300)
    assert tm2.encoding is tm.encoding and tm2.snapshot_ts == 9
    for before, now in zip(old, (sh.keys, sh.revs, sh.tomb, sh.ttl)):
        assert torch.equal(before, now)   # readers' mirror untouched


@pytest.mark.parametrize("order", ["shuffle", "survivors", "merge"])
@pytest.mark.parametrize("max_len", [8, 2048])
def test_gather_arena_matches_reference(order, max_len):
    """The run-copy arena gather gives the JAX package's arena and offsets
    for perms of one-row runs, long runs and a merge's interleave, empty
    records included."""
    rng = np.random.RandomState(max_len)
    n = 3000
    lens = rng.randint(0, max_len, n)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.uint64)
    arena = rng.randint(0, 256, int(offsets[-1])).astype(np.uint8)
    if order == "shuffle":
        perm = rng.permutation(n)
    elif order == "survivors":
        perm = np.sort(rng.choice(n, n // 3, replace=False))
    else:  # a sorted run with a few rows moved in, as a delta merge makes
        perm = np.insert(np.arange(n - 40), np.sort(rng.randint(0, n - 40, 40)),
                         np.arange(n - 40, n))
    want = jkeys.gather_arena(arena, offsets, perm)
    got = tkeys.gather_arena(arena, offsets, perm)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert got[0].dtype == np.uint8 and got[1].dtype == np.uint64


@pytest.mark.parametrize("encode", [True, False])
def test_compact_partitions_stored_matches_reference(encode):
    jm, tm = mirrors(version_rows(6, 400), 3, encode)
    rng = np.random.RandomState(0)
    keep = {p: np.sort(rng.choice(int(tm.n_valid[p]), int(tm.n_valid[p]) // 2,
                                  replace=False)) for p in (0, 2)}
    jm2 = jblocks.compact_partitions_stored(jm, keep, None, 11)
    tm2 = tblocks.compact_partitions_stored(tm, keep, 11)
    assert_same_mirror(jm2, tm2)
    assert torch.equal(tm2.shards[0].keys[1], tm.shards[0].keys[1])
    assert tblocks.compact_partitions_stored(tm, {}, 11) is tm


def test_republish_uploads_dirty_partitions_only():
    _jm, tm = mirrors(version_rows(7, 300), 3, True)
    keys_h = tm.keys_host.copy()
    keys_h[1, :5] = 0
    calls = []
    real = tblocks.prepare_layout
    with mock.patch.object(tblocks, "prepare_layout",
                           lambda *a: calls.append(a[0].shape) or real(*a)):
        shards = tblocks._republish(tm, keys_h, tm.revs_host, tm.tomb_host,
                                    tm.ttl_host, tm.n_valid, {1})
    assert calls == [(1, *keys_h.shape[1:])]
    kt = real(keys_h, tm.revs_host, tm.tomb_host)[0]
    keys = shards[0].keys
    assert (keys.numpy() == kt).all()
    assert keys.data_ptr() != tm.shards[0].keys.data_ptr()
    assert not torch.equal(keys[1], tm.shards[0].keys[1])


# ---------------------------------------------------------------- engine
def mk_port(merge_threshold, encode=True, partitions=0):
    store = t_new_storage("cuda", inner="memkv", device="cpu",
                          encode_keys=encode, partitions=partitions,
                          merge_threshold=merge_threshold)
    b = TBackend(store, TConfig(event_ring_capacity=16384))
    b.scanner._host_limit_threshold = 0
    return b, store


def rows(kvs):
    return [(kv.key, kv.value, kv.revision) for kv in kvs]


def host_oracle(store):
    return Scanner(store._inner, get_compact_revision=lambda _s: 0)


def assert_matches_host(b, store, revs=(0,)):
    oracle = host_oracle(store)
    head = b.current_revision()
    try:
        for rev in revs:
            for s, e in [(b"/registry/", b"/registry0"), (b"", b""),
                         (b"/registry/pods/ns-1/", b"/registry/pods/ns-10")]:
                assert rows(b.list_(s, e, rev).kvs) == rows(
                    oracle.range_(s, e, rev or head)[0]), (s, e, rev)
                assert b.count(s, e, rev)[0] == oracle.count(s, e, rev or head)
    finally:
        oracle.close()


@pytest.mark.parametrize("encode,partitions", [(True, 0), (True, 3),
                                                (False, 0), (False, 3)])
def test_incremental_merge_vs_full_rebuild_identity(encode, partitions):
    """Churn through a low merge threshold (many stored-domain merges)
    against a twin whose delta stays live until one rebuild from the store:
    reads agree byte for byte at head and at snapshots, the JAX tpu engine
    agrees too, and the incremental side never rebuilds from the store."""
    inc, inc_s = mk_port(32, encode, partitions)
    full, full_s = mk_port(10**9, encode, partitions)
    ref_s = j_new_storage("tpu", inner="memkv", encode_keys=encode,
                          merge_threshold=32)
    ref = JBackend(ref_s, JConfig(event_ring_capacity=16384))
    ref.scanner._host_limit_threshold = 0
    trio = (inc, full, ref)
    try:
        rng = np.random.RandomState(19)
        live, checkpoints = {}, []
        for i in range(40):
            k = b"/registry/pods/ns-%d/p-%03d" % (i % 4, i)
            live[k] = [be.create(k, b"seed") for be in trio][0]
        for be in trio:
            be.scanner.publish()
        for step in range(300):
            k = b"/registry/pods/ns-%d/p-%03d" % (step % 4, rng.randint(60))
            if k not in live:
                live[k] = [be.create(k, b"v%04d" % step) for be in trio][0]
            elif rng.rand() < 0.6:
                live[k] = [be.update(k, b"u%04d" % step, live[k])
                           for be in trio][0]
            else:
                for be in trio:
                    be.delete(k, live[k])
                live.pop(k)
            if step % 10 == 3:
                inc.count(b"/registry/pods/", b"/registry/pods0")
            if step % 60 == 30:
                checkpoints.append(inc.current_revision())
        inc.scanner.publish()
        full.scanner._force_rebuild = True
        full.scanner.publish()
        sc = inc.scanner
        assert sc.merge_count > 0 and sc.merge_rows_total > 0
        assert sc.full_rebuild_total == 1, "only the first publish rebuilds"
        for ns in range(4):
            s, e = b"/registry/pods/ns-%d/" % ns, b"/registry/pods/ns-%d0" % ns
            for rev in [0, *checkpoints]:
                got = [rows(be.list_(s, e, rev, 0).kvs) for be in trio]
                assert got[0] == got[1] == got[2], (ns, rev)
                assert inc.count(s, e, rev) == full.count(s, e, rev)
        m_inc, m_full = inc.scanner._mirror, full.scanner._mirror
        assert m_inc.rows == m_full.rows
    finally:
        for be, st in ((inc, inc_s), (full, full_s), (ref, ref_s)):
            be.close()
            st.close()


@pytest.mark.parametrize("encode", [True, False])
def test_capacity_grow_stays_incremental(encode):
    b, store = mk_port(64, encode)
    try:
        for i in range(100):
            b.create(b"/registry/pods/ns-1/a%04d" % i, b"seed")
        b.scanner.publish()
        cap0 = b.scanner._mirror.keys_host.shape[1]
        last = 0
        for i in range(600):
            last = b.create(b"/registry/pods/ns-1/b%04d" % i, b"grow")
        assert wait_for_revision(b, last)
        b.scanner.publish()
        sc = b.scanner
        assert sc._mirror.keys_host.shape[1] > cap0
        assert sc.full_rebuild_total == 1 and sc.merge_count > 0
        assert sc._mirror.rows == 700
        assert_matches_host(b, store)
    finally:
        b.close()
        store.close()


def test_encode_overflow_rebuilds_from_store():
    """A delta key the published dictionary cannot express (a suffix past
    its width) marks the delta overflowed; the merge then rebuilds from the
    store, once, with a fresh dictionary."""
    b, store = mk_port(8, encode=True)
    try:
        for i in range(50):
            b.create(b"/registry/pods/ns-1/p%03d" % i, b"seed")
        b.scanner.publish()
        enc0 = b.scanner._mirror.encoding
        long_key = b"/registry/pods/ns-1/" + b"x" * 90
        b.create(long_key, b"long")
        last = 0
        for i in range(10):
            last = b.create(b"/registry/pods/ns-1/q%03d" % i, b"more")
        assert wait_for_revision(b, last)
        b.scanner.publish()
        sc = b.scanner
        assert sc.full_rebuild_total == 2
        assert sc._mirror.encoding is not enc0
        assert long_key in {kv.key for kv in b.list_(b"/registry/", b"").kvs}
        assert_matches_host(b, store)
    finally:
        b.close()
        store.close()


def test_write_kicked_merge_runs_without_reads():
    b, store = mk_port(16)
    try:
        for i in range(20):
            b.create(b"/registry/pods/ns-0/s%03d" % i, b"seed")
        b.scanner.publish()
        last = 0
        for i in range(40):
            last = b.create(b"/registry/pods/ns-0/w%03d" % i, b"w")
        assert wait_for_revision(b, last)
        deadline = time.time() + 10
        while time.time() < deadline and b.scanner.merge_count == 0:
            time.sleep(0.01)
        assert b.scanner.merge_count > 0, "no background merge without a read"
        assert b.scanner.full_rebuild_total == 1
        assert_matches_host(b, store)
    finally:
        b.close()
        store.close()


def test_incremental_merge_runs_off_engine_lock(monkeypatch):
    b, store = mk_port(10**9)
    try:
        for i in range(200):
            b.create(b"/registry/off/k%04d" % i, b"v")
        b.scanner.publish()
        for i in range(300):
            b.create(b"/registry/off/m%04d" % i, b"v")
        sc = b.scanner
        entered, release = threading.Event(), threading.Event()
        real = teng.merge_partitions_stored

        def slow(*a, **kw):
            entered.set()
            release.wait(10)
            return real(*a, **kw)

        monkeypatch.setattr(teng, "merge_partitions_stored", slow)
        merger = threading.Thread(target=sc._merge_delta)
        merger.start()
        assert entered.wait(10)
        done, got = threading.Event(), []

        def read():
            got.append(b.count(b"/registry/off/", b"/registry/off0")[0])
            done.set()

        reader = threading.Thread(target=read)
        reader.start()
        finished = done.wait(8)
        release.set()
        merger.join(30)
        reader.join(10)
        assert finished, "reader stalled behind the off-lock merge"
        assert got == [500]
        assert b.count(b"/registry/off/", b"/registry/off0")[0] == 500
        assert sc.merge_count == 1 and len(sc._delta) == 0
    finally:
        b.close()
        store.close()


def _failing_merge(times):
    real = teng.merge_partitions_stored
    calls = {"n": 0}

    def fn(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= times:
            raise RuntimeError("injected merge failure")
        return real(*a, **kw)

    return fn, calls


@pytest.mark.parametrize("fail_times,escalate", [(1, False), (10**9, True)])
def test_merge_failure_retries_then_escalates(fail_times, escalate):
    """A failing background merge retries with backoff; one that keeps
    failing escalates to quarantine and one rebuild from the store. Reads
    stay exact throughout."""
    b, store = mk_port(8)
    sc = b.scanner
    sc._merge_max_retries = 2
    try:
        for i in range(30):
            b.create(b"/registry/pods/ns-2/s%03d" % i, b"seed")
        sc.publish()
        fn, calls = _failing_merge(fail_times)
        with mock.patch.object(teng, "merge_partitions_stored", fn):
            sc._merge_threshold = 10**9      # the kick below is the only merge
            last = 0
            for i in range(12):
                last = b.create(b"/registry/pods/ns-2/f%03d" % i, b"f")
            assert wait_for_revision(b, last)
            sc._kick_merge()
            deadline = time.time() + 15
            while time.time() < deadline and (
                    sc._merge_kick.locked() or sc._mirror_state != "serving"):
                assert_matches_host(b, store)
                time.sleep(0.02)
        assert not sc._merge_kick.locked() and sc._mirror_state == "serving"
        assert sc.merge_escalations_total == int(escalate)
        assert sc.merge_retries_total == 1
        assert sc.merge_bg_errors == (2 if escalate else 1)
        if escalate:
            assert sc.rebuild_bg_count == 1 and sc.full_rebuild_total == 2
        else:
            assert sc.merge_count == 1 and sc.full_rebuild_total == 1
        assert_matches_host(b, store)
    finally:
        b.close()
        store.close()


def test_quarantined_mirror_serves_host_reads_while_rebuilding():
    b, store = mk_port(10**9)
    sc = b.scanner
    try:
        for i in range(50):
            b.create(b"/registry/pods/ns-3/p%03d" % i, b"seed")
        sc.publish()
        entered, release = threading.Event(), threading.Event()
        real = sc._build_mirror_from_store

        def slow():
            entered.set()
            release.wait(10)
            return real()

        sc._build_mirror_from_store = slow
        store._on_uncertain()
        assert entered.wait(10)
        assert sc._mirror_state == "rebuilding"
        r = b.create(b"/registry/pods/ns-3/late", b"late")
        assert wait_for_revision(b, r)
        launches = sc.full_rebuild_total
        assert_matches_host(b, store)          # served from the host store
        assert sc.full_rebuild_total == launches
        release.set()
        deadline = time.time() + 10
        while time.time() < deadline and sc._mirror_state != "serving":
            time.sleep(0.01)
        assert sc._mirror_state == "serving" and sc.rebuild_bg_count == 1
        assert sc.degraded_seconds_total > 0
        del sc._build_mirror_from_store
        assert_matches_host(b, store)
    finally:
        release.set()
        b.close()
        store.close()
