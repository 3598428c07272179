"""The port's ``native`` engine (ctypes over ``native/libkbstore.so``) and
the ``cuda`` engine over it, each held against the JAX package on the same
inputs. Byte equality throughout: every outcome, dump and response of the
port must equal the JAX package's.

Counterparts of ``tests/test_native_engine.py`` (all 9 tests) and
``tests/test_durability.py`` (all 4), each run through both packages, plus
the mirror built by the engine's bulk export (``export_mvcc``) against the
per-row build and the JAX engine's, a bulk-GC compaction against the JAX
``tpu``-over-native engine, and a data dir written through the JAX package
and read back through the port. The JAX ``tpu`` engine runs on the CPU
(``JAX_PLATFORMS=cpu``, its jnp scan), the port with ``device="cpu"``.
"""

import os
import time
import types

import numpy as np
import pytest

import kubebrain_tpu.backend as jbackend
import kubebrain_tpu.storage as jstorage
import kubebrain_tpu.storage.errors as jerrors
import kubebrain_tpu_torch.backend as tbackend
import kubebrain_tpu_torch.storage as tstorage
import kubebrain_tpu_torch.storage.errors as terrors
from kubebrain_tpu import coder as jcoder
from kubebrain_tpu.storage.native import NativeScanner as JNativeScanner
from kubebrain_tpu_torch import coder
from kubebrain_tpu_torch.storage.native import NativeKv, NativeScanner


def _api(backend, storage, errors, coder_mod, cuda):
    return types.SimpleNamespace(
        Backend=backend.Backend, BackendConfig=backend.BackendConfig,
        wait=backend.wait_for_revision, CompactedError=backend.CompactedError,
        new_storage=storage.new_storage, errors=errors, coder=coder_mod,
        cuda=cuda)


JAX = _api(jbackend, jstorage, jerrors, jcoder, "tpu")
PORT = _api(tbackend, tstorage, terrors, coder, "cuda")


def mirror_store(api, inner="native", **kw):
    """The package's mirror engine over ``inner``: the JAX ``tpu`` engine,
    or the port's ``cuda`` engine on the CPU."""
    if api is PORT:
        kw["device"] = "cpu"
    return api.new_storage(api.cuda, inner=inner, **kw)


def both(scenario, *args):
    """``scenario(api, *args)`` through the JAX package, then the port:
    (JAX outcomes, port outcomes)."""
    return scenario(JAX, *args), scenario(PORT, *args)


def put(store, key, value, ttl=0):
    b = store.begin_batch_write()
    b.put(key, value, ttl)
    b.commit()


def attempt(fn, *errors):
    """``fn()``'s result, or the name of the error it raised."""
    try:
        return fn()
    except errors as e:
        return type(e).__name__


def rows_of(backend, start=b"/registry/", end=b"/registry0", rev=0):
    return [(kv.key, kv.value, kv.revision)
            for kv in backend.list_(start, end, revision=rev).kvs]


def raw_dump(store):
    return list(store.iter(b"", b""))


# ------------------------------------------ tests/test_native_engine.py
def _crud(api):
    s = api.new_storage("native")
    nf = api.errors.KeyNotFoundError
    try:
        out = [attempt(lambda: s.get(b"k"), nf)]
        put(s, b"k", b"v1")
        out.append(s.get(b"k"))
        put(s, b"k", b"v2")
        out.append(s.get(b"k"))
        s.delete(b"k")
        out.append(attempt(lambda: s.get(b"k"), nf))
        return out
    finally:
        s.close()


def test_crud():
    j, p = both(_crud)
    assert p == j == ["KeyNotFoundError", b"v1", b"v2", "KeyNotFoundError"]


def _snapshot_isolation(api):
    s = api.new_storage("native")
    nf = api.errors.KeyNotFoundError
    try:
        put(s, b"a", b"1")
        snap = s.get_timestamp_oracle()
        put(s, b"a", b"2")
        put(s, b"b", b"9")
        return [s.get(b"a", snapshot_ts=snap), s.get(b"a"),
                attempt(lambda: s.get(b"b", snapshot_ts=snap), nf),
                list(s.iter(b"", b"", snapshot_ts=snap))]
    finally:
        s.close()


def test_snapshot_isolation():
    j, p = both(_snapshot_isolation)
    assert p == j == [b"1", b"2", "KeyNotFoundError", [(b"a", b"1")]]


def _conditional_batch(api):
    s = api.new_storage("native")
    nf, cas = api.errors.KeyNotFoundError, api.errors.CASFailedError
    out = []
    try:
        b = s.begin_batch_write()
        b.put_if_not_exist(b"k", b"v")
        b.commit()
        b2 = s.begin_batch_write()
        b2.put(b"other", b"x")
        b2.put_if_not_exist(b"k", b"v2")
        try:
            b2.commit()
            out.append("committed")
        except cas as e:
            out.append((e.conflict.index, e.conflict.key, e.conflict.value))
        out.append(attempt(lambda: s.get(b"other"), nf))  # all-or-nothing
        b3 = s.begin_batch_write()
        b3.cas(b"k", b"v2", b"v")
        b3.commit()
        out.append(s.get(b"k"))
        out.append(attempt(lambda: s.del_current(b"k", b"wrong"), cas))
        out.append(attempt(lambda: s.del_current(b"k", b"v2"), cas))
        return out
    finally:
        s.close()


def test_conditional_batch_conflicts():
    j, p = both(_conditional_batch)
    assert p == j
    assert p[:3] == [(1, b"k", b"v"), "KeyNotFoundError", b"v2"]
    assert p[3] == "CASFailedError" and p[4] is None


def _iter_forward_reverse_limit(api):
    s = api.new_storage("native")
    try:
        for k in [b"a", b"b", b"c", b"d"]:
            put(s, k, b"v" + k)
        return [[k for k, _ in s.iter(*args, **kw)] for args, kw in (
            ((b"a", b"c"), {}), ((b"", b""), {}), ((b"a", b""), {"limit": 3}),
            ((b"c", b"a"), {}), ((b"c", b"a"), {"limit": 1}))]
    finally:
        s.close()


def test_iter_forward_reverse_limit():
    j, p = both(_iter_forward_reverse_limit)
    assert p == j == [[b"a", b"b"], [b"a", b"b", b"c", b"d"],
                      [b"a", b"b", b"c"], [b"c", b"b", b"a"], [b"c"]]


def test_native_ttl():
    """Both packages' engines expire a TTL row by themselves."""
    stores = [api.new_storage("native") for api in (JAX, PORT)]
    try:
        for s in stores:
            put(s, b"/events/e1", b"v", ttl=1)
        before = [s.get(b"/events/e1") for s in stores]
        time.sleep(1.1)
        after = [(attempt(lambda: s.get(b"/events/e1"), api.errors.KeyNotFoundError),
                  list(s.iter(b"/events/", b"/events0")))
                 for s, api in zip(stores, (JAX, PORT))]
    finally:
        for s in stores:
            s.close()
    assert before == [b"v", b"v"]
    assert after[1] == after[0] == ("KeyNotFoundError", [])


def _split_keys(api):
    s = api.new_storage("native", partitions=4)
    try:
        for i in range(100):
            put(s, b"key%03d" % i, b"v")
        return [(q.left, q.right) for q in s.get_partitions(b"", b"")]
    finally:
        s.close()


def test_split_keys_partitions():
    j, p = both(_split_keys)
    assert p == j
    assert len(p) == 4 and p[0][0] == b"" and p[-1][1] == b""
    assert all(p[i][1] == p[i + 1][0] for i in range(3))


def _backend_over_native(api, engine):
    store = (api.new_storage("native") if engine == "native"
             else mirror_store(api))
    b = api.Backend(store, api.BackendConfig(event_ring_capacity=4096))
    out = []
    try:
        if engine != "native":
            b.scanner._host_limit_threshold = 0
            b.scanner._merge_threshold = 8
        K = b"/registry/pods/default/nginx"
        r1 = b.create(K, b"v1")
        out.append(b.get(K).value)
        r2 = b.update(K, b"v2", r1)
        out += [r1, r2, b.get(K, revision=r1).value]
        for i in range(10):
            b.create(b"/registry/pods/p%02d" % i, b"x%d" % i)
        out.append(rows_of(b, b"/registry/pods/", b"/registry/pods0"))
        out.append(b.count(b"/registry/pods/", b"/registry/pods0")[0])
        rev, _prev = b.delete(K)
        assert api.wait(b, rev)
        out.append(rows_of(b, b"/registry/pods/", b"/registry/pods0"))
        out.append(b.compact(rev))
        raw = store._inner if engine != "native" else store
        out.append(attempt(lambda: raw.get(api.coder.encode_revision_key(K)),
                           api.errors.KeyNotFoundError))
        out.append(raw_dump(raw))
        return out
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ["native", "mirror-native"])
def test_backend_over_native(engine):
    """MVCC semantics end to end over the C++ engine, and over the mirror
    engine backed by it (the port's ``cuda``, the JAX ``tpu``): every
    response and the engine's raw dump after compaction equal."""
    j, p = both(_backend_over_native, engine)
    assert p == j
    assert len(p[4]) == 11 and p[5] == 11 and len(p[6]) == 10
    assert p[8] == "KeyNotFoundError"


def _compaction_frees_versions(api, engine):
    store = (api.new_storage("native") if engine == "native"
             else mirror_store(api))
    raw = store if engine == "native" else store._inner
    b = api.Backend(store, api.BackendConfig(event_ring_capacity=8192))
    try:
        K = b"/registry/churn/a"
        rev = b.create(K, b"v0")
        for i in range(50):
            rev = b.update(K, b"v%d" % i, rev)
        KD = b"/registry/churn/dead"
        rd = b.create(KD, b"x")
        rdel, _ = b.delete(KD, rd)
        assert api.wait(b, rdel)
        before = raw.version_count()
        b.compact(rdel)
        after = raw.version_count()
        gone = attempt(lambda: raw.get(api.coder.encode_revision_key(KD)),
                       api.errors.KeyNotFoundError)
        live = b.get(K).value
        rev2 = b.update(K, b"post", rev)
        return [before, after, gone, live, rev2, b.get(K).value, raw_dump(raw)]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("engine", ["native", "mirror-native"])
def test_compaction_physically_frees_versions(engine):
    """After compaction the C++ engine's version chains shrink (kb_prune);
    over the mirror engine the victims go through ``kb_bulk_gc``."""
    j, p = both(_compaction_frees_versions, engine)
    assert p == j
    before, after = p[0], p[1]
    assert after < before // 2, f"prune ineffective: {before} -> {after}"
    assert p[2] == "KeyNotFoundError" and p[3] == b"v49" and p[5] == b"post"


def _scanner_differential(api):
    cfg = api.BackendConfig(event_ring_capacity=4096,
                            watch_cache_capacity=4096)
    sn = api.new_storage("native", partitions=4)
    sm = api.new_storage("memkv")
    bn, bm = api.Backend(sn, cfg), api.Backend(sm, cfg)
    rng = np.random.RandomState(7)
    snaps, out = [], []
    try:
        out.append(type(bn.scanner).__name__)
        for i in range(120):
            k = b"/registry/nd/k%03d" % rng.randint(0, 40)
            delete = rng.rand() < 0.25
            for b in (bn, bm):
                try:
                    b.create(k, b"v%d" % i)
                except Exception:
                    kv = b.get(k)
                    if delete:
                        b.delete(k)
                    else:
                        b.update(k, b"u%d" % i, kv.revision)
            if i % 25 == 10:
                snaps.append(bn.current_revision())
        assert bn.current_revision() == bm.current_revision()
        for rev in snaps + [0]:
            rn = rows_of(bn, b"/registry/nd/", b"/registry/nd0", rev)
            assert rn == rows_of(bm, b"/registry/nd/", b"/registry/nd0", rev)
            out.append(rn)
        cn = bn.count(b"/registry/nd/", b"/registry/nd0")[0]
        assert cn == bm.count(b"/registry/nd/", b"/registry/nd0")[0]
        rn = bn.list_(b"/registry/nd/", b"/registry/nd0", limit=7)
        rm = bm.list_(b"/registry/nd/", b"/registry/nd0", limit=7)
        assert rn.more == rm.more
        assert [kv.key for kv in rn.kvs] == [kv.key for kv in rm.kvs]
        s1 = [kv.key for batch in bn.scanner.range_stream(
            b"/", b"", bn.current_revision()) for kv in batch]
        s2 = [kv.key for batch in bm.scanner.range_stream(
            b"/", b"", bm.current_revision()) for kv in batch]
        assert s1 == s2
        bn.scanner.PAGE_ROWS = 3  # the cross-page pending-key carry
        small = [(kv.key, kv.value) for kv in bn.list_(
            b"/registry/nd/", b"/registry/nd0").kvs]
        assert small == [(k, v) for k, v, _r in rows_of(
            bm, b"/registry/nd/", b"/registry/nd0")]
        out += [cn, rn.more, [kv.key for kv in rn.kvs], s1, small]
        return out
    finally:
        bn.close()
        bm.close()
        sn.close()
        sm.close()


def test_native_scanner_differential_vs_generic():
    """The port's ``NativeScanner`` (the C MVCC list pass) equals the port's
    generic scanner over memkv, and every answer equals the JAX package's
    on the same op sequence."""
    j, p = both(_scanner_differential)
    assert p[0] == NativeScanner.__name__ == JNativeScanner.__name__
    assert p == j


# --------------------------------------------- tests/test_durability.py
def _wal_replay(api, d):
    s = api.new_storage("native", data_dir=d)
    put(s, b"a", b"1")
    put(s, b"b", b"2")
    s.delete(b"a")
    ts = s.get_timestamp_oracle()
    s.close()
    s2 = api.new_storage("native", data_dir=d)
    try:
        out = [s2.get_timestamp_oracle() >= ts, s2.get(b"b"),
               attempt(lambda: s2.get(b"a"), api.errors.KeyNotFoundError)]
        put(s2, b"c", b"3")
        return out + [s2.get(b"c"), raw_dump(s2)]
    finally:
        s2.close()


def test_wal_replay_after_reopen(tmp_path):
    j, p = (_wal_replay(api, str(tmp_path / name))
            for api, name in ((JAX, "jax"), (PORT, "port")))
    assert p == j
    assert p[:4] == [True, b"2", "KeyNotFoundError", b"3"]


def _checkpoint(api, d):
    s = api.new_storage("native", data_dir=d)
    for i in range(50):
        put(s, b"k%03d" % i, b"v" * 100)
    wal = os.path.join(d, "wal.kb")
    out = [os.path.getsize(wal) > 0]
    s.checkpoint()
    out += [os.path.getsize(wal),
            os.path.getsize(os.path.join(d, "snapshot.kb")) > 0]
    put(s, b"after", b"x")
    s.close()
    s2 = api.new_storage("native", data_dir=d)
    try:
        return out + [s2.get(b"k049"), s2.get(b"after"), raw_dump(s2)]
    finally:
        s2.close()


def test_checkpoint_truncates_wal(tmp_path):
    j, p = (_checkpoint(api, str(tmp_path / name))
            for api, name in ((JAX, "jax"), (PORT, "port")))
    assert p == j
    assert p[:5] == [True, 0, True, b"v" * 100, b"x"]


def _torn_tail(api, d):
    s = api.new_storage("native", data_dir=d)
    put(s, b"good", b"1")
    s.close()  # close checkpoints: snapshot has "good", wal empty
    with open(os.path.join(d, "wal.kb"), "ab") as f:
        f.write(b"\x31\x57\x42\x4b" + b"\x01\x02")  # valid magic, cut body
    s2 = api.new_storage("native", data_dir=d)
    out = [s2.get(b"good")]
    put(s2, b"more", b"2")
    s2.close()
    s3 = api.new_storage("native", data_dir=d)
    try:
        return out + [s3.get(b"more"), raw_dump(s3)]
    finally:
        s3.close()


def test_torn_wal_tail_ignored(tmp_path):
    j, p = (_torn_tail(api, str(tmp_path / name))
            for api, name in ((JAX, "jax"), (PORT, "port")))
    assert p == j
    assert p[:2] == [b"1", b"2"]


def _restart_durable(api, d, engine):
    open_store = (lambda: api.new_storage("native", data_dir=d)) \
        if engine == "native" else (lambda: mirror_store(api, data_dir=d))
    store = open_store()
    b = api.Backend(store, api.BackendConfig(event_ring_capacity=2048))
    r1 = b.create(b"/registry/pods/a", b"v1")
    r2 = b.update(b"/registry/pods/a", b"v2", r1)
    b.create(b"/registry/pods/b", b"x")
    b.compact(r2)
    b.close()
    store.close()
    store2 = open_store()
    b2 = api.Backend(store2, api.BackendConfig(event_ring_capacity=2048))
    try:
        out = [b2.current_revision() >= r2 + 1,
               b2.get(b"/registry/pods/a").value, b2.compact_revision() == r2]
        r4 = b2.create(b"/registry/pods/c", b"y")
        return out + [r4 > r2, r4, rows_of(b2, b"/registry/pods/",
                                           b"/registry/pods0")]
    finally:
        b2.close()
        store2.close()


@pytest.mark.parametrize("engine", ["native", "mirror-native"])
def test_backend_restart_durable(tmp_path, engine):
    """Versions, the revision watermark and the compact record survive a
    restart, directly over native and under the mirror engine."""
    j, p = (_restart_durable(api, str(tmp_path / name), engine)
            for api, name in ((JAX, "jax"), (PORT, "port")))
    assert p == j
    assert p[:4] == [True, b"v2", True, True] and len(p[5]) == 3


# ------------------------------------------------- the export fast path
def churn(b, n_keys: int = 90):
    """Superseded chains, tombstoned chains, singletons and /events/ rows:
    the live key -> revision map and the last revision."""
    live, last = {}, 0
    for i in range(n_keys):
        k = (b"/events/ns%d/e%04d" % (i % 3, i) if i % 5 == 4
             else b"/registry/pods/ns%d/p%04d" % (i % 4, i))
        r = b.create(k, b"v0-%d" % i)
        if i % 3 == 0:
            for j in range(3):
                r = b.update(k, b"v%d-%d" % (j + 1, i), r)
            live[k] = r
        elif i % 3 == 1:
            r, _ = b.delete(k, r)
        else:
            live[k] = r
        last = max(last, r)
    return live, last


def mirror_rows(m) -> list:
    """Every valid row of a mirror (either package's) in partition order:
    (user key, revision, tombstone, TTL flag, value)."""
    out = []
    for p in range(m.keys_host.shape[0]):
        off = m.val_offsets[p].astype(np.int64)
        for i in range(int(m.n_valid[p])):
            out.append((m.user_key(p, i), int(m.revs_host[p, i]),
                        bool(m.tomb_host[p, i]), bool(m.ttl_host[p, i]),
                        m.val_arena[p][off[i]:off[i + 1]].tobytes()))
    return out


class _WithoutExport:
    """An engine with its bulk export hidden."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "export_mvcc":
            raise AttributeError(name)
        return getattr(self._inner, name)


def mirror_backend(api, **kw):
    store = mirror_store(api, **kw)
    b = api.Backend(store, api.BackendConfig(event_ring_capacity=8192))
    b.scanner._host_limit_threshold = 0
    return b, store


@pytest.mark.parametrize("encode", [False, True], ids=["raw", "encoded"])
def test_export_mirror_equals_per_row_and_jax(encode):
    """The mirror the port builds from the native engine's bulk export
    equals, column for column, the one it builds row by row from the same
    store, and its rows equal the JAX ``tpu``-over-native engine's."""
    port, pstore = mirror_backend(PORT, encode_keys=encode, partitions=2)
    jax, jstore = mirror_backend(JAX, encode_keys=encode)
    try:
        for b in (port, jax):
            churn(b)
            b.scanner.publish()
        sc = port.scanner
        assert sc.mirror_builds == {"export": 1, "rows": 0}
        exported = sc._mirror
        pstore.untracked = lambda: _WithoutExport(pstore._inner)
        try:
            per_row = sc._build_mirror_from_store()
        finally:
            del pstore.untracked
        assert sc.mirror_builds == {"export": 1, "rows": 1}
        for col in ("keys_host", "lens_host", "revs_host", "tomb_host",
                    "ttl_host", "n_valid", "keys_dev", "revs_dev",
                    "tomb_dev", "ttl_dev", "n_valid_dev"):
            a, b = getattr(exported, col), getattr(per_row, col)
            assert np.array_equal(np.asarray(a), np.asarray(b)), col
        for x, y, xo, yo in zip(exported.val_arena, per_row.val_arena,
                                exported.val_offsets, per_row.val_offsets):
            assert np.array_equal(x, y) and np.array_equal(xo, yo)
        assert exported.partitions == 2
        assert (exported.encoding is None) == (not encode)
        assert mirror_rows(exported) == mirror_rows(jax.scanner._mirror)
        assert rows_of(port) == rows_of(jax)
    finally:
        for b, s in ((port, pstore), (jax, jstore)):
            b.close()
            s.close()


def test_every_build_takes_the_export_when_the_engine_has_it():
    """First publish, the background rebuild after an uncertain commit and
    a forced rebuild all take the export over native; an engine without it
    (memkv) and an export that fails with a StorageError build row by row."""
    b, store = mirror_backend(PORT)
    try:
        churn(b, 30)
        b.scanner.publish()
        b.scanner.mark_uncertain()
        deadline = time.monotonic() + 20
        while b.scanner._mirror_state != "serving":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        b.scanner._force_rebuild = True
        b.scanner.publish()
        assert b.scanner.mirror_builds == {"export": 3, "rows": 0}

        def broken(*_a, **_k):
            raise terrors.StorageError("no export here")

        store._inner.export_mvcc = broken
        b.scanner._force_rebuild = True
        b.scanner.publish()
        assert b.scanner.mirror_builds == {"export": 3, "rows": 1}
        del store._inner.export_mvcc
        assert rows_of(b) and b.scanner._mirror_state == "serving"
    finally:
        b.close()
        store.close()
    mb, mstore = mirror_backend(PORT, inner="memkv")
    try:
        churn(mb, 10)
        mb.scanner.publish()
        assert mb.scanner.mirror_builds == {"export": 0, "rows": 1}
    finally:
        mb.close()
        mstore.close()


def test_bulk_gc_compaction_matches_jax_tpu_native(monkeypatch):
    """Compaction over native takes the one-call C GC (``kb_bulk_gc``) and
    the engine prune in both packages, and leaves the same store, the same
    version count and the same victim counts."""
    calls = []
    real = NativeKv.bulk_gc

    def spy(self, *args):
        calls.append(len(args[0]))
        return real(self, *args)

    monkeypatch.setattr(NativeKv, "bulk_gc", spy)
    port, pstore = mirror_backend(PORT)
    jax, jstore = mirror_backend(JAX)
    try:
        stats = []
        for b in (jax, port):
            _live, last = churn(b)
            b.scanner.publish()
            seen = []
            orig = b.scanner.compact
            b.scanner.compact = lambda s, e, r: seen.append(orig(s, e, r)) or seen[-1]
            b.compact(last)
            del b.scanner.compact
            stats.append([(s.deleted_versions, s.deleted_tombstones,
                           s.deleted_rev_records, s.expired_ttl) for s in seen])
        assert calls and calls[0] > 0
        assert stats[1] == stats[0]
        assert raw_dump(pstore._inner) == raw_dump(jstore._inner)
        assert pstore._inner.version_count() == jstore._inner.version_count()
        assert rows_of(port) == rows_of(jax)
    finally:
        for b, s in ((port, pstore), (jax, jstore)):
            b.close()
            s.close()


def test_jax_written_data_dir_reads_back_through_the_port(tmp_path):
    """State carried across packages: a data dir written through the JAX
    ``tpu``-over-native engine and closed, reopened by the port's
    ``cuda``-over-native, answers every Range and Count as the JAX engine
    did before it closed."""
    d = str(tmp_path / "db")
    jax, jstore = mirror_backend(JAX, data_dir=d)
    ranges = [(b"/registry/", b"/registry0"), (b"/events/", b"/events0"),
              (b"/registry/pods/ns1/", b"/registry/pods/ns10"), (b"", b"")]
    try:
        _live, last = churn(jax)
        jax.compact(last // 2)
        revs = [0, last // 2, last * 3 // 4, last]
        want = [(rows_of(jax, s, e, r), jax.count(s, e, revision=r)[0])
                for s, e in ranges for r in revs]
        head = jax.current_revision()
    finally:
        jax.close()
        jstore.close()
    port, pstore = mirror_backend(PORT, data_dir=d)
    try:
        assert port.current_revision() == head
        got = [(rows_of(port, s, e, r), port.count(s, e, revision=r)[0])
               for s, e in ranges for r in revs]
        assert port.scanner.mirror_builds["export"] == 1
        assert got == want
        with pytest.raises(PORT.CompactedError):
            port.list_(b"/registry/", b"/registry0", revision=last // 2 - 1)
    finally:
        port.close()
        pstore.close()


def test_first_use_builds_only_the_engine_library(monkeypatch, tmp_path):
    """The port's loader runs ``make -C native libkbstore.so`` (not the
    ``all`` target, whose HTTP/2 front links nghttp2 and OpenSSL), and a
    failed build raises with make's stderr."""
    import subprocess

    from kubebrain_tpu_torch.storage import native as tnative

    calls = []
    lib = tmp_path / "libkbstore.so"

    def fake_make(cmd, **kw):
        calls.append(cmd)
        lib.write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(tnative.subprocess, "run", fake_make)
    tnative._build_lib(str(lib))
    assert calls == [["make", "-C", str(tmp_path), "libkbstore.so"]]
    default = os.path.abspath(tnative._LIB_PATH)
    assert default == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native", "libkbstore.so")

    def failing_make(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 2, "", "kbstore.cc: error")

    monkeypatch.setattr(tnative.subprocess, "run", failing_make)
    with pytest.raises(terrors.StorageError, match="kbstore.cc: error"):
        tnative._build_lib(str(tmp_path / "missing.so"))
