"""Write-path group commit in the port (``Backend.write_batch`` and the
engines' ``write_batch``: memkv's own, and ``storage/groupwrite.py``'s loop
over native's one-call MVCC paths), each held against the JAX package on
the same op streams over the same engine kind. Byte equality throughout:
every per-op result, final state, watch event and mirror read of the port
equals the JAX package's.

Counterparts of the 13 tests of ``tests/test_write_batch.py`` that need no
request scheduler (the two ``test_scheduler_*`` tests wait for the port's
``sched/``), over memkv and native. The mirror tests run the port's
``cuda`` engine on the CPU against the JAX ``tpu`` engine (jnp scan).
"""

import threading
import time
import types

import numpy as np
import pytest

import kubebrain_tpu.backend as jbackend
import kubebrain_tpu.storage as jstorage
import kubebrain_tpu.storage.errors as jerrors
import kubebrain_tpu.storage.tpu.engine as jengine
import kubebrain_tpu_torch.backend as tbackend
import kubebrain_tpu_torch.storage as tstorage
import kubebrain_tpu_torch.storage.cuda.engine as tengine
import kubebrain_tpu_torch.storage.errors as terrors
from kubebrain_tpu.backend.tso import TSO as JTSO
from kubebrain_tpu_torch.backend.tso import TSO

JAX = types.SimpleNamespace(backend=jbackend, new_storage=jstorage.new_storage,
                            errors=jerrors, engine=jengine, mirror="tpu")
PORT = types.SimpleNamespace(backend=tbackend, new_storage=tstorage.new_storage,
                             errors=terrors, engine=tengine, mirror="cuda")
ENGINES = ["memkv", "native"]


def mk_backend(api, engine, store=None, ring=16384):
    store = store or api.new_storage(engine)
    return store, api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=ring, watch_cache_capacity=4096))


def mk_mirror_backend(api, engine, merge_threshold=64, partitions=0):
    kw = {"device": "cpu"} if api is PORT else {}
    store = api.new_storage(api.mirror, inner=engine, partitions=partitions,
                            merge_threshold=merge_threshold, **kw)
    b = api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=16384))
    b.scanner._host_limit_threshold = 0  # always the device path
    return b, store


def fp_op_result(r):
    """One comparable fingerprint per op result (success value or error)."""
    if isinstance(r, BaseException):
        return (type(r).__name__, str(r))
    if isinstance(r, tuple):  # delete: (rev, KeyValue)
        rev, kv = r
        return ("del", rev, kv.key, kv.value, kv.revision)
    return ("rev", r)


def fp_state(b):
    res = b.list_(b"/registry/", b"/registry0", 0, 0)
    return ([(kv.key, kv.value, kv.revision) for kv in res.kvs],
            res.revision, b.current_revision())


def gen_ops(rng, n, keyspace=24):
    """A random create/update/delete stream with plausible conflicts (the
    generator of ``tests/test_write_batch.py``)."""
    live: dict[bytes, int] = {}
    next_rev = 0
    ops = []
    for step in range(n):
        k = b"/registry/pods/ns-%d/p-%02d" % (step % 3, rng.randint(keyspace))
        roll = rng.rand()
        if k not in live or roll < 0.3:
            ops.append(("create", k, b"c%04d" % step, None, 0))
            kind = "create"
        elif roll < 0.75:
            exp = live[k] if rng.rand() < 0.8 else max(1, live[k] - 1)
            ops.append(("update", k, b"u%04d" % step, exp, None, 0))
            kind = "update" if exp == live[k] else "update-stale"
        else:
            droll = rng.rand()
            exp = 0 if droll < 0.5 else live[k] if droll < 0.8 else live[k] + 7
            ops.append(("delete", k, exp))
            kind = "delete" if exp in (0, live[k]) else "delete-stale"
        next_rev += 1
        if kind == "create" and k not in live:
            live[k] = next_rev
        elif kind == "update":
            live[k] = next_rev
        elif kind == "delete" and exp in (0, live.get(k)):
            live.pop(k, None)
    return ops


def sequential(b, ops):
    out = []
    for op in ops:
        try:
            out.append(fp_op_result(b._apply_single(op)))
        except BaseException as e:
            out.append(fp_op_result(e))
    return out


def _grouped_vs_sequential(api, engine):
    rng = np.random.RandomState(7)
    ops = gen_ops(rng, 240)
    gs, grouped = mk_backend(api, engine)
    ss, seq = mk_backend(api, engine)
    stop = threading.Event()
    reader_errs: list = []

    def reader():
        while not stop.is_set():
            try:
                keys = [kv.key for kv in grouped.list_(
                    b"/registry/", b"/registry0", 0, 0).kvs]
                assert keys == sorted(keys) and len(set(keys)) == len(keys)
            except Exception as e:  # pragma: no cover - surfaced below
                reader_errs.append(e)
                return

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    got, want = [], []
    i = 0
    try:
        while i < len(ops):
            group = ops[i:i + int(rng.randint(1, 9))]
            got.extend(fp_op_result(r) for r in grouped.write_batch(group))
            want.extend(sequential(seq, group))
            i += len(group)
    finally:
        stop.set()
        for t in readers:
            t.join(10)
    try:
        assert not reader_errs, reader_errs[0]
        assert got == want
        assert fp_state(grouped) == fp_state(seq)
        return got, fp_state(grouped)
    finally:
        for x in (grouped, seq, gs, ss):
            x.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_grouped_vs_sequential_randomized_byte_identity(engine):
    """A random op stream in random-size groups against the same stream
    applied one op at a time, readers hammering the grouped backend: equal
    per-op results and state in each package, and the port's equal to the
    JAX package's."""
    assert _grouped_vs_sequential(PORT, engine) == \
        _grouped_vs_sequential(JAX, engine)


def _conflict_demux(api, engine):
    store, b = mk_backend(api, engine)
    try:
        r1 = b.create(b"/registry/a", b"v1")
        r2 = b.update(b"/registry/a", b"v2", r1)
        base = b.current_revision()
        res = b.write_batch([
            ("create", b"/registry/ok", b"x", None, 0),
            ("create", b"/registry/a", b"dup", None, 0),
            ("update", b"/registry/a", b"y", r1, None, 0),
            ("delete", b"/registry/missing", 0),
            ("update", b"/registry/a", b"z", r2, None, 0),
            ("delete", b"/registry/ok", 0),
        ])
        assert res[0] == base + 1
        assert isinstance(res[1], api.backend.KeyExistsError)
        assert res[1].revision == r2
        assert isinstance(res[2], api.backend.CASRevisionMismatchError)
        assert res[2].revision == r2 and res[2].value == b"v2"
        assert isinstance(res[3], api.errors.KeyNotFoundError)
        assert res[4] == base + 5
        assert res[5][0] == base + 6 and res[5][1].value == b"x"
        assert b.current_revision() == base + 6
        return [fp_op_result(r) for r in res], fp_state(b)
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_per_op_conflict_demux_in_one_group(engine):
    """Every conflict kind in one group fails only its own op and consumes
    its dealt revision; the port's results equal the JAX package's."""
    assert _conflict_demux(PORT, engine) == _conflict_demux(JAX, engine)


def _failed_delete(api, engine):
    gs, grouped = mk_backend(api, engine)
    ss, seq = mk_backend(api, engine)
    try:
        for b in (grouped, seq):
            b.create(b"/registry/a", b"v1")
        ops = [("delete", b"/registry/a", 999),
               ("create", b"/registry/b", b"v2", None, 0)]
        got = [fp_op_result(r) for r in grouped.write_batch(ops)]
        want = sequential(seq, ops)
        assert got == want and got[0][0] == "CASRevisionMismatchError"
        assert got[1] == ("rev", 3) and seq.current_revision() == 3
        assert fp_state(grouped) == fp_state(seq)
        return got, fp_state(grouped)
    finally:
        for x in (grouped, seq, gs, ss):
            x.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_failed_delete_consumes_revision_grouped_and_sequential(engine):
    assert _failed_delete(PORT, engine) == _failed_delete(JAX, engine)


def _same_key(api, engine):
    store, b = mk_backend(api, engine)
    try:
        base = b.current_revision()
        res = b.write_batch([
            ("create", b"/registry/k", b"v0", None, 0),
            ("update", b"/registry/k", b"v1", base + 1, None, 0),
            ("update", b"/registry/k", b"v2", base + 2, None, 0),
            ("update", b"/registry/k", b"stale", base + 1, None, 0),
            ("delete", b"/registry/k", base + 3),
            ("create", b"/registry/k", b"reborn", None, 0),
        ])
        assert res[:3] == [base + 1, base + 2, base + 3]
        assert isinstance(res[3], api.backend.CASRevisionMismatchError)
        assert res[4][0] == base + 5 and res[4][1].value == b"v2"
        assert res[5] == base + 6
        return [fp_op_result(r) for r in res], fp_state(b)
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_same_key_in_group_ordering(engine):
    got = _same_key(PORT, engine)
    assert got == _same_key(JAX, engine)
    assert got[1][0] == [(b"/registry/k", b"reborn", 6)]


def _watch_order(api, engine):
    store, b = mk_backend(api, engine)
    wid, q = b.watch(b"/registry/")
    try:
        b.write_batch([
            ("create", b"/registry/w/a", b"1", None, 0),
            ("create", b"/registry/w/b", b"2", None, 0),
            ("create", b"/registry/w/a", b"dup", None, 0),
        ])
        b.create(b"/registry/w/c", b"3")
        b.write_batch([
            ("update", b"/registry/w/a", b"4", 1, None, 0),
            ("delete", b"/registry/w/b", 0),
        ])
        events = []
        deadline = time.time() + 10
        while len(events) < 5 and time.time() < deadline:
            batch = q.get(timeout=5)
            assert batch is not None
            events.extend(batch)
        return [(e.key, e.verb.name, e.revision, e.value) for e in events]
    finally:
        b.unwatch(wid)
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_watch_events_strictly_ordered_across_groups(engine):
    got = _watch_order(PORT, engine)
    assert got == _watch_order(JAX, engine)
    assert [(k, v, r) for k, v, r, _ in got] == [
        (b"/registry/w/a", "CREATE", 1), (b"/registry/w/b", "CREATE", 2),
        (b"/registry/w/c", "CREATE", 4), (b"/registry/w/a", "PUT", 5),
        (b"/registry/w/b", "DELETE", 6)]


class _NoBatchStore:
    """Engine shim hiding ``write_batch``: forces the per-op fallback."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "write_batch":
            raise AttributeError(name)
        return getattr(self._inner, name)


def _no_write_batch(api, engine):
    ops = gen_ops(np.random.RandomState(3), 80)
    inner = api.new_storage(engine)
    _, plain = mk_backend(api, engine, store=_NoBatchStore(inner))
    ss, seq = mk_backend(api, engine)
    try:
        assert plain._engine_write_batch is None
        got = [fp_op_result(r) for r in plain.write_batch(list(ops))]
        assert got == sequential(seq, ops)
        assert fp_state(plain) == fp_state(seq)
        return got, fp_state(plain)
    finally:
        for x in (plain, seq, inner, ss):
            x.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_without_write_batch_falls_back_per_op(engine):
    assert _no_write_batch(PORT, engine) == _no_write_batch(JAX, engine)


def _demux_failure(api, engine):
    store, b = mk_backend(api, engine)
    try:
        r1 = b.create(b"/registry/a", b"v1")
        r2 = b.update(b"/registry/a", b"v2", r1)

        def flaky_read(key, rev):
            raise api.errors.StorageError("transient wire error")

        orig, b._read_object = b._read_object, flaky_read
        try:
            res = b.write_batch([
                ("update", b"/registry/a", b"x", r1, None, 0),
                ("create", b"/registry/b", b"v2", None, 0),
            ])
        finally:
            b._read_object = orig
        assert isinstance(res[0], api.errors.StorageError)
        assert res[1] == r2 + 2
        assert b.create(b"/registry/c", b"v3") == r2 + 3
        return [fp_op_result(r) for r in res], fp_state(b)
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_failure_cannot_strand_the_revision_block(engine):
    """A demux error fails only its op; the block still reaches the ring
    and later writes proceed, in both packages alike."""
    assert _demux_failure(PORT, engine) == _demux_failure(JAX, engine)


@pytest.mark.parametrize("cls", [TSO, JTSO], ids=["port", "jax"])
def test_tso_deal_block_contiguous_under_race(cls):
    """Blocks dealt by racing threads tile the revisions with no overlap
    (the port's TSO and, as the reference, the JAX package's)."""
    tso = cls()
    blocks: list = []
    lock = threading.Lock()

    def dealer():
        for _ in range(50):
            first = tso.deal_block(3)
            with lock:
                blocks.append(first)
            tso.commit(first + 2)

    threads = [threading.Thread(target=dealer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    covered = [r for first in sorted(blocks) for r in range(first, first + 3)]
    assert covered == list(range(1, 601))
    with pytest.raises(ValueError):
        tso.deal_block(0)


# ---------------------------------------------------------- mirror merges
def churn(b, rng, steps, keyspace=60, live=None):
    live = {} if live is None else live
    for step in range(steps):
        k = b"/registry/pods/ns-%d/p-%03d" % (step % 4, rng.randint(keyspace))
        if k not in live:
            live[k] = b.create(k, b"v%04d" % step)
        elif rng.rand() < 0.6:
            live[k] = b.update(k, b"u%04d" % step, live[k])
        else:
            b.delete(k, live.pop(k))


def _merge_vs_rebuild(api, engine, partitions):
    inc, s1 = mk_mirror_backend(api, engine, 32, partitions)
    full, s2 = mk_mirror_backend(api, engine, 10 ** 9, partitions)
    try:
        rng = np.random.RandomState(19)
        live: dict[bytes, int] = {}
        checkpoints: list[int] = []
        for i in range(40):
            k = b"/registry/pods/ns-%d/p-%03d" % (i % 4, i)
            for be in (inc, full):
                r = be.create(k, b"seed")
            live[k] = r
        inc.scanner.publish()
        full.scanner.publish()
        rebuilds0 = inc.scanner.full_rebuild_total
        for step in range(300):
            k = b"/registry/pods/ns-%d/p-%03d" % (step % 4, rng.randint(60))
            if k not in live:
                for be in (inc, full):
                    r = be.create(k, b"v%04d" % step)
                live[k] = r
            elif rng.rand() < 0.6:
                for be in (inc, full):
                    r = be.update(k, b"u%04d" % step, live[k])
                live[k] = r
            else:
                for be in (inc, full):
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
        assert sc.full_rebuild_total == rebuilds0
        out = []
        for ns in range(4):
            s = b"/registry/pods/ns-%d/" % ns
            e = b"/registry/pods/ns-%d0" % ns
            for rev in [0, *checkpoints]:
                a = inc.list_(s, e, rev, 0)
                rows = [(kv.key, kv.value, kv.revision) for kv in a.kvs]
                assert rows == [(kv.key, kv.value, kv.revision)
                                for kv in full.list_(s, e, rev, 0).kvs]
                assert inc.count(s, e, rev) == full.count(s, e, rev)
                out.append((rows, inc.count(s, e, rev)))
        return out
    finally:
        for x in (inc, full, s1, s2):
            x.close()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("partitions", [0, 3])
def test_incremental_merge_vs_full_rebuild_identity(engine, partitions):
    """Churn through a low merge threshold (many incremental stored-domain
    merges) against a twin rebuilt from the store: equal reads at the head
    and at snapshots, no full rebuild on the merging engine, and the port's
    reads equal the JAX engine's (whose partitions follow its mesh)."""
    assert _merge_vs_rebuild(PORT, engine, partitions) == \
        _merge_vs_rebuild(JAX, engine, 0)


@pytest.mark.parametrize("api", [PORT, JAX], ids=["port", "jax"])
def test_incremental_merge_runs_off_engine_lock(api, monkeypatch):
    """A reader completes while another thread sits inside the heavy merge
    step, off the engine lock (the port's engine and the JAX engine)."""
    b, store = mk_mirror_backend(api, "native", merge_threshold=10 ** 9)
    try:
        for i in range(200):
            b.create(b"/registry/off/k%04d" % i, b"v")
        b.scanner.publish()
        for i in range(500):
            b.create(b"/registry/off/m%04d" % i, b"v")
        sc = b.scanner
        entered, release = threading.Event(), threading.Event()
        real = api.engine.merge_partitions_stored

        def slow_merge(*args, **kwargs):
            entered.set()
            release.wait(10)
            return real(*args, **kwargs)

        monkeypatch.setattr(api.engine, "merge_partitions_stored", slow_merge)
        merger = threading.Thread(target=sc._merge_delta)
        merger.start()
        assert entered.wait(10), "merge never started"
        done = threading.Event()
        got: list = []

        def read():
            got.append(b.count(b"/registry/off/", b"/registry/off0"))
            done.set()

        reader = threading.Thread(target=read)
        reader.start()
        finished = done.wait(8)
        release.set()
        merger.join(30)
        reader.join(10)
        assert finished, "reader stalled behind the off-lock merge"
        assert got and got[0][0] == 700
        assert b.count(b"/registry/off/", b"/registry/off0")[0] == 700
    finally:
        b.close()
        store.close()


class MergeRecorder:
    """The metrics surface of the engines, recording the merge counters
    the JAX engine emits."""

    def __init__(self):
        self.counters: dict = {}
        self.histograms: list = []

    def emit_counter(self, name, value=1, **tags):
        self.counters[name] = self.counters.get(name, 0) + value

    def emit_histogram(self, name, value, **tags):
        self.histograms.append((name, tags))

    def register_gauge_fn(self, *a, **k):
        pass

    def unregister_gauge_fn(self, *a, **k):
        pass


def _merge_accounting(api, engine):
    b, store = mk_mirror_backend(api, engine, merge_threshold=16)
    rec = MergeRecorder()
    b.scanner.register_metrics(rec)
    try:
        rng = np.random.RandomState(5)
        seeded = {}
        for ns in range(4):
            for i in range(0, 60, 2):
                k = b"/registry/pods/ns-%d/p-%03d" % (ns, i)
                seeded[k] = b.create(k, b"s")
        b.scanner.publish()
        rebuilds0 = b.scanner.full_rebuild_total
        churn(b, rng, 120, live=seeded)
        b.scanner.publish()
        assert b.scanner.full_rebuild_total == rebuilds0
        return b.scanner.merge_rows_total, b.scanner.merge_count, rec
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_merge_metrics_emitted(engine):
    """The same churn merges the same rows incrementally in both packages:
    the port's ``merge_rows_total`` equals the JAX engine's, whose
    merge-rows counter and incremental merge histogram carry the same
    rows. The port emits no merge metric yet: the metrics
    module and the engine's emits come with the front (ROADMAP item 9)."""
    p_rows, p_merges, _ = _merge_accounting(PORT, engine)
    j_rows, j_merges, rec = _merge_accounting(JAX, engine)
    # how many merges the rows took depends on when the write-kicked
    # background merges ran: counted, not compared
    assert p_rows == j_rows > 0 and p_merges > 0 and j_merges > 0
    assert rec.counters.get("kb.mirror.merge.rows.total") == j_rows
    assert ("kb.mirror.merge.seconds", {"kind": "incremental"}) in rec.histograms


def _post_compact(api, engine):
    b, store = mk_mirror_backend(api, engine, merge_threshold=16)
    try:
        rng = np.random.RandomState(11)
        seeded = {}
        for ns in range(4):
            for i in range(0, 60, 2):
                k = b"/registry/pods/ns-%d/p-%03d" % (ns, i)
                seeded[k] = b.create(k, b"s")
        b.scanner.publish()
        rebuilds0 = b.scanner.full_rebuild_total
        churn(b, rng, 60, live=seeded)
        b.scanner.publish()
        assert b.scanner.full_rebuild_total == rebuilds0
        b.compact(b.current_revision() - 1)
        churn(b, rng, 60, live=seeded)
        b.scanner.publish()
        assert b.scanner.full_rebuild_total == rebuilds0, \
            "post-compact merge took the full-rebuild path"
        assert b.scanner.merge_rows_total > 0
        return fp_state(b), b.scanner.merge_rows_total
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_post_compact_merge_stays_incremental(engine):
    assert _post_compact(PORT, engine) == _post_compact(JAX, engine)


def _group_through_mirror(api, engine):
    b, store = mk_mirror_backend(api, engine, merge_threshold=10 ** 9)
    try:
        b.create(b"/registry/gd/seed", b"s")
        b.scanner.publish()
        base = b.current_revision()
        res = b.write_batch([
            ("create", b"/registry/gd/a", b"1", None, 0),
            ("create", b"/registry/gd/b", b"2", None, 0),
            ("update", b"/registry/gd/a", b"3", base + 1, None, 0),
            ("delete", b"/registry/gd/b", 0),
        ])
        assert res[:3] == [base + 1, base + 2, base + 3]
        got = [(kv.key, kv.value, kv.revision) for kv in b.list_(
            b"/registry/gd/", b"/registry/gd0", 0, 0).kvs]
        assert got == [(b"/registry/gd/a", b"3", base + 3),
                       (b"/registry/gd/seed", b"s", base)]
        revs = [r for (_, r, _) in b.scanner._delta.rows()]
        assert revs == sorted(revs)
        return [fp_op_result(r) for r in res], got, revs
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_group_commit_through_mirror_engine_records_delta_once(engine):
    """A grouped commit lands all its rows in the mirror's delta in
    revision order and device reads see them, as in the JAX engine."""
    assert _group_through_mirror(PORT, engine) == \
        _group_through_mirror(JAX, engine)
