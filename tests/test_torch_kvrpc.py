"""The port's ``remote`` engine (``kbstored`` over TCP) and the ``cuda``
engine over it, held against the JAX package: each scenario runs through
the JAX package's ``RemoteKvStorage`` and the port's, each against a
``kbstored`` of its own, and every outcome must be equal.

Counterparts of the 11 engine-level tests of ``tests/test_kvrpc.py`` (the
``test_remote_*`` contract, ``test_uncertain_on_connection_death``,
``test_pool_heals_after_server_restart`` and
``test_reverse_scan_pages_past_server_page_cap``), plus ``cuda`` over
remote against the JAX ``tpu`` over remote. The replication and CLI tests
wait for the port's front and ``replica/``. Skipped, like
``tests/test_kvrpc.py``, when ``kbstored`` is not built
(``make -C native``).
"""

import os
import socket
import subprocess
import time
import types

import pytest

import kubebrain_tpu.backend as jbackend
import kubebrain_tpu.storage as jstorage
import kubebrain_tpu.storage.errors as jerrors
import kubebrain_tpu_torch.backend as tbackend
import kubebrain_tpu_torch.storage as tstorage
import kubebrain_tpu_torch.storage.errors as terrors
from kubebrain_tpu_torch.storage.remote import RemoteKvStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORED_BIN = os.path.join(REPO, "native", "kvrpc", "kbstored")

pytestmark = pytest.mark.skipif(
    not os.path.exists(STORED_BIN), reason="kbstored not built (make -C native)"
)

JAX = types.SimpleNamespace(name="jax", backend=jbackend, errors=jerrors,
                            new_storage=jstorage.new_storage, mirror="tpu")
PORT = types.SimpleNamespace(name="port", backend=tbackend, errors=terrors,
                             new_storage=tstorage.new_storage, mirror="cuda")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def start_stored(port):
    proc = subprocess.Popen([STORED_BIN, str(port)], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    assert b"READY" in proc.stdout.readline(), "kbstored failed to start"
    return proc


def _stored_pair():
    """One kbstored per package: {package name: port}."""
    ports = {name: free_port() for name in ("jax", "port")}
    procs = [start_stored(p) for p in ports.values()]
    yield ports
    for proc in procs:
        proc.terminate()
        proc.wait(timeout=5)


stored = pytest.fixture(scope="module")(_stored_pair)
#: fresh daemons: a Backend's revisions and compact record live in the store
fresh_stored = pytest.fixture(_stored_pair)


def remote(api, stored, pool=4):
    return api.new_storage("remote", address=f"127.0.0.1:{stored[api.name]}",
                           pool=pool)


def both(scenario, stored, *args):
    """(JAX outcomes, port outcomes) of ``scenario(api, store, *args)``,
    each over its package's remote engine on its own kbstored."""
    out = []
    for api in (JAX, PORT):
        s = remote(api, stored)
        try:
            out.append(scenario(api, s, *args))
        finally:
            s.close()
    return out


def put(store, key, value, ttl=0):
    b = store.begin_batch_write()
    b.put(key, value, ttl)
    b.commit()


def name_of(fn, *errors):
    try:
        return fn()
    except errors as e:
        return type(e).__name__


# ------------------------------------------------- engine contract over TCP
def _crud(api, s):
    nf = api.errors.KeyNotFoundError
    out = [name_of(lambda: s.get(b"/r/k"), nf)]
    put(s, b"/r/k", b"v1")
    out.append(s.get(b"/r/k"))
    put(s, b"/r/k", b"v2")
    out.append(s.get(b"/r/k"))
    s.delete(b"/r/k")
    return out + [name_of(lambda: s.get(b"/r/k"), nf)]


def test_remote_crud(stored):
    j, p = both(_crud, stored)
    assert p == j == ["KeyNotFoundError", b"v1", b"v2", "KeyNotFoundError"]


def _snapshot(api, s):
    put(s, b"/rs/a", b"1")
    snap = s.get_timestamp_oracle()
    put(s, b"/rs/a", b"2")
    put(s, b"/rs/b", b"9")
    return [s.get(b"/rs/a", snapshot_ts=snap), s.get(b"/rs/a"),
            name_of(lambda: s.get(b"/rs/b", snapshot_ts=snap),
                    api.errors.KeyNotFoundError)]


def test_remote_snapshot_isolation(stored):
    j, p = both(_snapshot, stored)
    assert p == j == [b"1", b"2", "KeyNotFoundError"]


def _conflict(api, s):
    b = s.begin_batch_write()
    b.put_if_not_exist(b"/rc/k", b"v")
    b.commit()
    b2 = s.begin_batch_write()
    b2.put(b"/rc/other", b"x")
    b2.put_if_not_exist(b"/rc/k", b"v2")
    try:
        b2.commit()
        out = ["committed"]
    except api.errors.CASFailedError as e:
        out = [(e.conflict.index, e.conflict.value)]
    out.append(name_of(lambda: s.get(b"/rc/other"), api.errors.KeyNotFoundError))
    b3 = s.begin_batch_write()
    b3.cas(b"/rc/k", b"v2", b"v")
    b3.commit()
    return out + [s.get(b"/rc/k")]


def test_remote_conditional_batch_conflict_carries_value(stored):
    j, p = both(_conflict, stored)
    assert p == j == [(1, b"v"), "KeyNotFoundError", b"v2"]


def _iter(api, s):
    for i in range(10):
        put(s, b"/ri/%02d" % i, b"v%d" % i)
    return [[k for k, _ in s.iter(b"/ri/", b"/ri0")],
            [k for k, _ in s.iter(b"/ri/", b"/ri0", limit=3)],
            [k for k, _ in s.iter(b"/ri/99", b"/ri/", limit=2)]]


def test_remote_iter_forward_reverse_limit(stored):
    j, p = both(_iter, stored)
    assert p == j
    assert p[0] == [b"/ri/%02d" % i for i in range(10)]
    assert len(p[1]) == 3 and p[2] == [b"/ri/09", b"/ri/08"]


def _paged(api, s):
    batch = s.begin_batch_write()
    for i in range(3000):  # past SCAN_PAGE_CAP (2048)
        batch.put(b"/rp/%06d" % i, b"x")
    batch.commit()
    rows = list(s.iter(b"/rp/", b"/rp0"))
    return len(rows), rows[0][0], rows[-1][0]


def test_remote_paged_scan(stored):
    j, p = both(_paged, stored)
    assert p == j == (3000, b"/rp/000000", b"/rp/002999")


def _partitions(api, s):
    return [(q.left, q.right) for q in s.get_partitions(b"/rp/", b"/rp0")]


def test_remote_partitions(stored):
    j, p = both(_partitions, stored)
    assert p == j
    assert p[0][0] == b"/rp/" and p[-1][1] == b"/rp0"
    assert all(a[1] == b[0] for a, b in zip(p, p[1:]))


def test_remote_ttl(stored):
    stores = [remote(api, stored) for api in (JAX, PORT)]
    try:
        for s in stores:
            assert s.support_ttl()
            b = s.begin_batch_write()
            b.put(b"/rt/k", b"v", ttl_seconds=1)
            b.commit()
        before = [s.get(b"/rt/k") for s in stores]
        time.sleep(1.2)
        after = [name_of(lambda: s.get(b"/rt/k"), api.errors.KeyNotFoundError)
                 for s, api in zip(stores, (JAX, PORT))]
    finally:
        for s in stores:
            s.close()
    assert before == [b"v", b"v"] and after == ["KeyNotFoundError"] * 2


def _backend_semantics(api, s):
    b = api.backend.Backend(s, api.backend.BackendConfig(
        event_ring_capacity=4096, watch_cache_capacity=4096))
    try:
        r1 = b.create(b"/registry/rk/a", b"v1")
        r2 = b.update(b"/registry/rk/a", b"v2", r1)
        kv = b.get(b"/registry/rk/a")
        out = [r1, r2, kv.value, kv.revision,
               [x.key for x in b.list_(b"/registry/rk/", b"/registry/rk0").kvs]]
        b.delete(b"/registry/rk/a", r2)
        return out + [name_of(lambda: b.get(b"/registry/rk/a"),
                              api.errors.KeyNotFoundError)]
    finally:
        b.close()


def test_remote_backend_semantics(stored):
    j, p = both(_backend_semantics, stored)
    assert p == j
    assert p[2:] == [b"v2", p[1], [b"/registry/rk/a"], "KeyNotFoundError"]


def test_uncertain_on_connection_death(stored):
    """A commit whose transport dies mid-flight is uncertain, not failed,
    in both packages."""
    out = []
    for api in (JAX, PORT):
        s = remote(api, stored, pool=1)
        try:
            s._pool[0].sock.shutdown(socket.SHUT_RDWR)
            b = s.begin_batch_write()
            b.put(b"/ru/k", b"v")
            out.append(name_of(b.commit, api.errors.UncertainResultError))
        finally:
            s.close()
    assert out == ["UncertainResultError"] * 2


def _heals(api):
    port = free_port()
    proc = start_stored(port)
    s = api.new_storage("remote", address=f"127.0.0.1:{port}", pool=3)
    try:
        put(s, b"/hr/a", b"v")
        proc.terminate()
        proc.wait(timeout=5)
        proc = start_stored(port)
        recovered = 0
        for i in range(12):
            try:
                put(s, b"/hr/k%d" % i, b"v")
                recovered += 1
            except api.errors.UncertainResultError:
                pass
        return recovered, s.get(b"/hr/k11")
    finally:
        s.close()
        proc.terminate()
        proc.wait(timeout=5)


def test_pool_heals_after_server_restart():
    """Each failed write on a dead slot heals it: the pool recovers once
    kbstored is back, with the same count of healed writes in both."""
    j, p = _heals(JAX), _heals(PORT)
    assert p == j
    assert p[0] >= 6 and p[1] == b"v"


def _reverse_pages(api, s):
    n = 2048 + 700
    b = s.begin_batch_write()
    for i in range(n):
        b.put(b"/rvp/%06d" % i, b"v%d" % i)
    b.commit()
    fwd = list(s.iter(b"/rvp/", b"/rvp0"))
    rev = list(s.iter(b"/rvp/\xff", b"/rvp/"))
    rev_l = list(s.iter(b"/rvp/\xff", b"/rvp/", limit=2500))
    assert len(fwd) == n and rev == fwd[::-1] and rev_l == fwd[::-1][:2500]
    return fwd, rev, rev_l


def test_reverse_scan_pages_past_server_page_cap(stored):
    j, p = both(_reverse_pages, stored)
    assert p == j


# ------------------------------------------------- the mirror over remote
def _mirror_over_remote(api, stored, encode):
    kw = {"device": "cpu"} if api is PORT else {}
    store = api.new_storage(api.mirror, inner="remote",
                            address=f"127.0.0.1:{stored[api.name]}", pool=4,
                            encode_keys=encode, **kw)
    b = api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=8192))
    b.scanner._host_limit_threshold = 0
    prefix = b"/registry/mr%d/" % encode
    try:
        live, last = {}, 0
        for i in range(60):
            k = prefix + b"ns%d/p%03d" % (i % 3, i)
            r = b.create(k, b"v0-%d" % i)
            if i % 3 == 0:
                for j in range(2):
                    r = b.update(k, b"v%d-%d" % (j + 1, i), r)
                live[k] = r
            elif i % 3 == 1:
                r, _ = b.delete(k, r)
            last = max(last, r)
        assert api.backend.wait_for_revision(b, last)
        end = prefix[:-1] + b"0"
        reads = [[(kv.key, kv.value, kv.revision)
                  for kv in b.list_(prefix, end, revision=rev).kvs]
                 for rev in (0, last // 2)]
        reads.append(b.count(prefix, end)[0])
        reads.append([r if isinstance(r, BaseException) else
                      [(kv.key, kv.revision) for kv in r.kvs]
                      for r in b.list_batch([("list", prefix, end, 0, 0),
                                             ("list", prefix, end, last // 2, 0)])])
        b.compact(last)
        reads.append([(kv.key, kv.value, kv.revision)
                      for kv in b.list_(prefix, end).kvs])
        reads.append(list(store._inner.iter(prefix, end)))
        if api is PORT:
            assert b.scanner.mirror_builds["export"] >= 1
            assert b.scanner.mirror_builds["rows"] == 0
        return reads
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("encode", [False, True], ids=["raw", "encoded"])
def test_cuda_over_remote_matches_tpu_over_remote(fresh_stored, encode):
    """``cuda`` over remote (mirror built by the wire export, compaction's
    GC through batch deletes: remote has no bulk GC) answers every Range,
    Count and ``list_batch`` and leaves the same store after compaction as
    the JAX ``tpu`` over remote."""
    assert not hasattr(RemoteKvStorage, "bulk_gc")
    j = _mirror_over_remote(JAX, fresh_stored, encode)
    p = _mirror_over_remote(PORT, fresh_stored, encode)
    assert p == j
    assert len(p[0]) == 40 and p[2] == 40
