"""The port's chaos plane (``kubebrain_tpu_torch/faults/``) and what it
drives in the ``cuda`` engine, held against the JAX package on the same
schedules, seeds and op sequences: outcomes, store dumps and counters must
be equal.

Counterparts of the 17 tests of ``tests/test_faults.py`` that need no gRPC
front or client (all but ``test_chaos_smoke_end_to_end`` and
``test_classify_rpc_error_three_way``) and of the 5 tests of
``tests/test_compact_faults.py``. Each scenario runs through
the JAX ``tpu`` engine (CPU, jnp scan) and the port's ``cuda`` engine
(``device="cpu"``), with ``FaultyStorage`` under the mirror through the
factories' ``inner_wrap``.

Two divergences kept on purpose, each pinned by a test here:

- an uncertain one-call write (``mvcc_write``/``mvcc_delete``) quarantines
  the port's mirror; the JAX engine's does not, and serves a revision the
  store disagrees with until the retry FIFO rewrites the key;
- a delta row the mirror already holds (a write recorded after a
  background rebuild's snapshot took it) is merged once in the port; the
  JAX engine keeps both copies, and its next compaction deletes the live
  row from the store;
- a head read (revision 0) that a compaction passes while it resolves its
  revision or before its scan resolves again in the port's Backend; the
  JAX Backend answers it ``CompactedError``, which etcd never does.
"""

import threading
import time
import types

import numpy as np
import pytest

import kubebrain_tpu.backend as jbackend
import kubebrain_tpu.faults as jfaults
import kubebrain_tpu.lease as jlease
import kubebrain_tpu.storage as jstorage
import kubebrain_tpu.storage.errors as jerrors
import kubebrain_tpu_torch.backend as tbackend
import kubebrain_tpu_torch.faults as tfaults
import kubebrain_tpu_torch.lease as tlease
import kubebrain_tpu_torch.storage as tstorage
import kubebrain_tpu_torch.storage.errors as terrors
from kubebrain_tpu import coder as jcoder
from kubebrain_tpu.backend import scanner as jscanner_mod
from kubebrain_tpu.backend.scanner import Scanner as JScanner
from kubebrain_tpu_torch import coder
from kubebrain_tpu_torch.backend import scanner as tscanner_mod
from kubebrain_tpu_torch.backend.scanner import Scanner as TScanner

JAX = types.SimpleNamespace(
    name="jax", backend=jbackend, faults=jfaults, errors=jerrors,
    new_storage=jstorage.new_storage, coder=jcoder, mirror="tpu",
    scanner_mod=jscanner_mod, Scanner=JScanner, lease=jlease)
PORT = types.SimpleNamespace(
    name="port", backend=tbackend, faults=tfaults, errors=terrors,
    new_storage=tstorage.new_storage, coder=coder, mirror="cuda",
    scanner_mod=tscanner_mod, Scanner=TScanner, lease=tlease)


def both(scenario, *args):
    """(JAX outcomes, port outcomes) of ``scenario(api, *args)``."""
    return scenario(JAX, *args), scenario(PORT, *args)


def plane(api, preset="none", seed=0, horizon=30.0, armed=False):
    p = api.faults.FaultPlane(api.faults.generate(preset, seed, horizon))
    if armed:
        p.arm()
    return p


def scripted(api, script):
    """A plane that pops one decision per storage WRITE call (None = no
    fault); reads stay clean (``tests/test_faults.py``'s script plane)."""

    class Scripted(api.faults.FaultPlane):
        def __init__(self):
            super().__init__(api.faults.generate("none", 0, 30.0))
            self.script = list(script)
            self.arm()

        def decide_storage(self, write):
            if not write or not self.script:
                return None
            d = self.script.pop(0)
            if d is not None:
                self._count("scripted_" + d[0])
            return d

    return Scripted()


def mirror_backend(api, inner="memkv", plane_=None, merge_threshold=64,
                   **kw):
    """The package's mirror engine over ``inner``, wrapped by
    ``FaultyStorage(plane_)`` through ``inner_wrap`` when a plane is
    given, and a Backend over it."""
    if api is PORT:
        kw["device"] = "cpu"
    if plane_ is not None:
        kw["inner_wrap"] = lambda s: api.faults.FaultyStorage(s, plane_)
    store = api.new_storage(api.mirror, inner=inner,
                            merge_threshold=merge_threshold, **kw)
    return api.backend.Backend(store, api.backend.BackendConfig()), store


def name_of(fn, *errors):
    try:
        return fn()
    except errors as e:
        return type(e).__name__


def scan(b, start=b"/t/", end=b"/t0"):
    kvs, _ = b.scanner.range_(start, end, b.current_revision())
    return [(kv.key, kv.value, kv.revision) for kv in kvs]


def wait_serving(scanner, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and scanner._mirror_state != "serving":
        time.sleep(0.02)
    assert scanner._mirror_state == "serving", "the rebuild never completed"


# -------------------------------------------------------------- schedule
def test_schedule_deterministic_sha():
    """Same (preset, seed, horizon): byte-identical schedules, in each
    package and across them."""
    for args in (("smoke", 7, 12.0), ("full", 7, 12.0), ("storage", 3, 9.0),
                 ("merge", 3, 9.0), ("replica", 1, 5.0)):
        a, b = tfaults.generate(*args), jfaults.generate(*args)
        assert a.trace_bytes() == b.trace_bytes()
        assert a.sha256() == b.sha256() == tfaults.generate(*args).sha256()
    a = tfaults.generate("smoke", 7, 12.0)
    assert a.sha256() != tfaults.generate("smoke", 8, 12.0).sha256()
    assert a.sha256() != tfaults.generate("full", 7, 12.0).sha256()
    assert a.sha256() != tfaults.generate("smoke", 7, 13.0).sha256()


def test_schedule_windows_inside_horizon():
    for api in (PORT, JAX):
        s = api.faults.generate("full", 3, 9.0)
        assert s.windows
        for w in s.windows:
            assert 0 <= w.t0_ms < w.t1_ms <= s.horizon_ms
            assert 0.0 < w.rate <= 1.0
        assert set(s.kinds()) == set(api.faults.ALL_KINDS) - set(
            api.faults.REPLICA_KINDS)
        r = api.faults.generate("replica", 3, 9.0)
        assert set(r.kinds()) == set(api.faults.REPLICA_KINDS)
    assert tfaults.ALL_KINDS == jfaults.ALL_KINDS
    assert tfaults.PRESETS == jfaults.PRESETS


def test_schedule_none_is_empty_and_unknown_preset_rejected():
    for api in (PORT, JAX):
        assert api.faults.generate("none", 0, 5.0).windows == ()
        with pytest.raises(ValueError):
            api.faults.generate("nope", 0, 5.0)
        with pytest.raises(ValueError):
            api.faults.generate("smoke", 0, 0.0)


def test_merge_windows_disjoint():
    for seed in range(10):
        s = tfaults.generate("smoke", seed, 20.0)
        assert s.trace_bytes() == jfaults.generate("smoke", seed, 20.0).trace_bytes()
        fail = [w for w in s.windows if w.kind == tfaults.MERGE_FAIL]
        supp = [w for w in s.windows if w.kind == tfaults.MERGE_SUPPRESS]
        for f in fail:
            for sup in supp:
                assert f.t1_ms <= sup.t0_ms or sup.t1_ms <= f.t0_ms


# ----------------------------------------------------------------- plane
def test_plane_inert_until_armed():
    p = plane(PORT, "full", 1, 30.0)
    for _ in range(200):
        assert p.decide_storage(write=True) is None
        assert p.decide_storage(write=False) is None
        assert not p.conn_drop()
        assert not p.merge_fault()
        assert not p.merges_suppressed()
        assert not p.encode_overflow()
        assert not p.compact_fault()
    assert p.snapshot() == {}


def _decisions(api):
    p = plane(api, "full", 1, 30.0, armed=True)
    out = []
    for ms in range(0, 30000, 37):
        p._t0 = time.monotonic() - ms / 1000.0
        out.append((p.decide_storage(write=False), p.decide_storage(write=True)))
    return out, p.snapshot()


def test_plane_reads_never_uncertain():
    """Over the whole horizon no read decision is uncertain; the port's
    plane draws the same decisions as the JAX one from the same seed."""
    j, p = both(_decisions)
    assert all(r is None or r[0] in ("latency", "error") for r, _w in p[0])
    assert any(w and w[0].startswith("uncertain") for _r, w in p[0])
    assert p == j


# ------------------------------------------------- inertness (FAULTS=none)
def drive(api, backend) -> list:
    """A fixed single-threaded op sequence: every revision, value and
    error it observes."""
    out = []
    for i in range(30):
        key = b"/inert/k-%02d" % (i % 7)
        try:
            out.append(("create", backend.create(key, b"v%d" % i)))
        except api.backend.KeyExistsError as e:
            out.append(("exists", e.revision))
    kvs, _ = backend.scanner.range_(b"/inert/", b"/inert0",
                                    backend.current_revision())
    out.append([(kv.key, kv.value, kv.revision) for kv in kvs])
    for i in range(7):
        key = b"/inert/k-%02d" % i
        kv = backend.get(key)
        out.append(("get", kv.key, kv.value, kv.revision))
        out.append(("update", backend.update(key, b"u%d" % i, kv.revision)))
    for i in range(3):
        key = b"/inert/k-%02d" % i
        rev, prev = backend.delete(key)
        out.append(("delete", rev, prev.value))
        out.append(name_of(lambda: backend.get(key).value,
                           api.errors.KeyNotFoundError))
    out.append(("final_rev", backend.current_revision()))
    return out


def _inert(api):
    plain, ps = mirror_backend(api)
    faulty, fs = mirror_backend(api, plane_=plane(api, "none", 5, armed=True))
    try:
        a, b = drive(api, plain), drive(api, faulty)
        assert a == b
        return a
    finally:
        for x in (plain, faulty, ps, fs):
            x.close()


def test_faults_none_is_byte_identical():
    """An armed, windowless plane under the mirror changes nothing: the
    same revisions and responses as a bare engine, and as the JAX
    package's."""
    j, p = both(_inert)
    assert p == j


# ----------------------------------------------- storage fault taxonomy
def _definite_error(api, inner):
    b, store = mirror_backend(api, inner, scripted(api, [("error", 0.0)]))
    try:
        out = [name_of(lambda: b.create(b"/f/k1", b"v"),
                       api.errors.StorageError),
               name_of(lambda: b.get(b"/f/k1"), api.errors.KeyNotFoundError)]
        rev = b.create(b"/f/k2", b"v2")
        return out + [rev, b.get(b"/f/k2").revision, scan(b, b"/f/", b"/f0")]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_definite_error_nothing_applied_and_sequencer_advances(inner):
    j, p = both(_definite_error, inner)
    assert p == j
    assert p[:2] == ["FaultInjectedError", "KeyNotFoundError"]
    assert p[2] >= 2 and p[3] == p[2]


def _uncertain_applied(api, inner):
    b, store = mirror_backend(api, inner,
                              scripted(api, [("uncertain_applied", 0.0)]))
    try:
        out = [name_of(lambda: b.create(b"/u/k1", b"vv"),
                       api.errors.UncertainResultError),
               b.get(b"/u/k1").value, len(b.retry),
               b.retry.min_revision() >= 1]
        old_rev = b.get(b"/u/k1").revision
        resolved = b.retry.process_ready(now=time.monotonic() + 60.0)
        kv = b.get(b"/u/k1")
        return out + [resolved, len(b.retry), kv.value,
                      kv.revision > old_rev, scan(b, b"/u/", b"/u0")]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_uncertain_applied_resolves_via_retry_fifo(inner):
    j, p = both(_uncertain_applied, inner)
    assert p == j
    assert p[:4] == ["UncertainResultError", b"vv", 1, True]
    assert p[4:8] == [1, 0, b"vv", True]


def _uncertain_dropped(api, inner):
    b, store = mirror_backend(api, inner,
                              scripted(api, [("uncertain_dropped", 0.0)]))
    nf = api.errors.KeyNotFoundError
    try:
        out = [name_of(lambda: b.create(b"/u/k2", b"vv"),
                       api.errors.UncertainResultError),
               name_of(lambda: b.get(b"/u/k2"), nf), len(b.retry),
               b.retry.process_ready(now=time.monotonic() + 60.0),
               name_of(lambda: b.get(b"/u/k2"), nf)]
        return out + [scan(b, b"/u/", b"/u0")]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_uncertain_dropped_resolves_to_nothing(inner):
    j, p = both(_uncertain_dropped, inner)
    assert p == j
    assert p == ["UncertainResultError", "KeyNotFoundError", 1, 1,
                 "KeyNotFoundError", []]


def _group_uncertainty(api, inner):
    script = [None, ("uncertain_applied", 0.0), ("error", 0.0), None]
    b, store = mirror_backend(api, inner, scripted(api, script))
    try:
        ops = [("create", b"/g/k%d" % i, b"v%d" % i, None, 0)
               for i in range(4)]
        res = b.write_batch(ops)
        out = [r if isinstance(r, int) else type(r).__name__ for r in res]
        out += [b.get(b"/g/k0").revision, b.get(b"/g/k3").revision,
                 name_of(lambda: b.get(b"/g/k2"), api.errors.KeyNotFoundError),
                 b.get(b"/g/k1").value, len(b.retry),
                 b.retry.process_ready(now=time.monotonic() + 60.0),
                 b.get(b"/g/k1").revision > res[3],
                 b.create(b"/g/tail", b"t") > res[3],
                 scan(b, b"/g/", b"/g0")]
        return out
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_group_commit_per_op_uncertainty_no_orphaned_riders(inner):
    """One poisoned member of a commit group fails alone (native through
    ``storage/groupwrite.py``), in both packages alike."""
    j, p = both(_group_uncertainty, inner)
    assert p == j
    r0 = p[0]
    assert p[1:4] == ["UncertainResultError", "FaultInjectedError", r0 + 3]
    assert p[4:9] == [r0, r0 + 3, "KeyNotFoundError", b"v1", 1]
    assert p[9:12] == [1, True, True]


def _latency(api):
    b, store = mirror_backend(api, "memkv", scripted(api, [("latency", 0.15)]))
    try:
        t0 = time.monotonic()
        rev = b.create(b"/l/k", b"v")
        return [time.monotonic() - t0 >= 0.14, rev, b.get(b"/l/k").revision]
    finally:
        b.close()
        store.close()


def test_injected_latency_delays_but_preserves_semantics():
    j, p = both(_latency)
    assert p == j == [True, 1, 1]


# --------------------------------------- the mirror's degradation machinery
def _quarantine(api):
    b, store = mirror_backend(api)
    try:
        for i in range(30):
            b.create(b"/t/k-%03d" % i, b"v%d" % i)
        before = scan(b)
        sc = b.scanner
        rebuilds = sc.full_rebuild_total
        sc.mark_uncertain()
        during = scan(b)
        b.create(b"/t/new", b"nv")
        wait_serving(sc)
        after = scan(b)
        assert during == before
        assert [r for r in after if r[0] != b"/t/new"] == before
        return [before, after, sc.rebuild_bg_count >= 1,
                sc.degraded_seconds_total > 0, sc.full_rebuild_total - rebuilds]
    finally:
        b.close()
        store.close()


def test_quarantine_serves_host_store_then_recovers():
    j, p = both(_quarantine)
    assert p == j
    assert p[2] and p[3]


class AlwaysFail:
    def merge_fault(self):
        return True

    def merge_fail_active(self):
        return True

    def merges_suppressed(self):
        return False

    def encode_overflow(self):
        return False


def _merge_failure(api):
    b, store = mirror_backend(api, merge_threshold=16)
    try:
        sc = b.scanner
        for i in range(10):
            b.create(b"/t/a-%03d" % i, b"v%d" % i)
        baseline = scan(b)
        sc.set_fault_plane(AlwaysFail())
        for i in range(40):
            b.create(b"/t/b-%03d" % i, b"w%d" % i)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and sc.merge_escalations_total == 0:
            time.sleep(0.02)
        wait_serving(sc)
        got = scan(b)
        assert sc.merge_bg_errors > 0 and sc.merge_retries_total >= 1
        assert sc.merge_escalations_total >= 1
        assert sc._merge_bg_last_error is not None
        assert [r for r in got if r[0].startswith(b"/t/a-")] == baseline
        return got
    finally:
        b.close()
        store.close()


def test_merge_failure_bounded_retry_then_escalation():
    """A merge that always fails retries, then escalates to a rebuild from
    the store; reads stay exact and equal the JAX engine's."""
    j, p = both(_merge_failure)
    assert p == j and len(p) == 50


def _reader_identity(api):
    b, store = mirror_backend(api, merge_threshold=16)
    try:
        sc = b.scanner
        fail = [True]

        class Plane(AlwaysFail):
            def merge_fault(self):
                return fail[0]

            def merge_fail_active(self):
                return fail[0]

        for i in range(8):
            b.create(b"/t/k-%03d" % i, b"v%d" % i)
        scan(b)
        sc.set_fault_plane(Plane())
        stop = threading.Event()
        diffs = []

        def reader():
            while not stop.is_set():
                rev = b.current_revision()
                got, _ = b.scanner.range_(b"/t/", b"/t0", rev)
                want, _ = api.Scanner.range_(b.scanner, b"/t/", b"/t0", rev)
                if [(kv.key, kv.value, kv.revision) for kv in got] != \
                        [(kv.key, kv.value, kv.revision) for kv in want]:
                    diffs.append(rev)
                    return
                time.sleep(0.005)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for i in range(60):
            b.create(b"/t/m-%03d" % i, b"x%d" % i)
            time.sleep(0.002)
        fail[0] = False
        time.sleep(0.5)
        stop.set()
        t.join(timeout=10)
        assert not diffs, f"reader diverged from the host oracle at {diffs}"
        wait_serving(sc)
        return scan(b)
    finally:
        b.close()
        store.close()


def test_reader_byte_identity_during_merge_failures():
    j, p = both(_reader_identity)
    assert p == j and len(p) == 68


def _encode_overflow(api):
    b, store = mirror_backend(api, merge_threshold=16)
    try:
        sc = b.scanner
        once = [True]

        class Plane(AlwaysFail):
            def merge_fault(self):
                return False

            def merge_fail_active(self):
                return False

            def encode_overflow(self):
                hit, once[0] = once[0], False
                return hit

        for i in range(8):
            b.create(b"/t/k-%03d" % i, b"v%d" % i)
        before = scan(b)
        rebuilds = sc.full_rebuild_total
        sc.set_fault_plane(Plane())
        for i in range(40):
            b.create(b"/t/o-%03d" % i, b"y%d" % i)
        sc.publish()
        got = scan(b)
        assert [r for r in got if r[0].startswith(b"/t/k-")] == before
        return got, sc.full_rebuild_total - rebuilds >= 1
    finally:
        b.close()
        store.close()


def test_forced_encode_overflow_takes_full_rebuild_path():
    j, p = both(_encode_overflow)
    assert p == j and p[1] and len(p[0]) == 48


def _suppression(api):
    b, store = mirror_backend(api, merge_threshold=16)
    try:
        sc = b.scanner
        seen = []

        class Plane(AlwaysFail):
            def merge_fault(self):
                return False

            def merge_fail_active(self):
                return False

            def merges_suppressed(self):
                return True

            def note_suppressed_merge(self):
                seen.append(1)

        for i in range(8):
            b.create(b"/t/k-%03d" % i, b"v%d" % i)
        scan(b)
        sc.set_fault_plane(Plane())
        for i in range(50):
            b.create(b"/t/s-%03d" % i, b"z%d" % i)
        assert seen and len(sc._delta) >= 50
        return scan(b), len(sc._delta), sc.merge_count
    finally:
        b.close()
        store.close()


def test_merge_suppression_grows_delta_and_reads_stay_exact():
    j, p = both(_suppression)
    assert p == j and len(p[0]) == 58


# ------------------------------------------- tests/test_compact_faults.py
class FailNthDelete:
    """Engine decorator: the Nth call that deletes (a batch holding a
    delete, or the one-call bulk GC) fails; ``fail_on`` 0 fails every one
    (``tests/test_compact_faults.py``'s decorator, with the bulk GC that
    the mirror engines' compaction calls on memkv counted as a delete)."""

    def __init__(self, store, errors, fail_on=1):
        self._store = store
        self._errors = errors
        self.calls = 0
        self.fail_on = fail_on

    def __getattr__(self, name):
        return getattr(self._store, name)

    def exclusive_client(self):
        return self

    def _deleting(self):
        self.calls += 1
        if self.fail_on in (0, self.calls):
            raise self._errors.StorageError("injected delete failure")

    def bulk_gc(self, *args):
        self._deleting()
        return self._store.bulk_gc(*args)

    def begin_batch_write(self):
        real = self._store.begin_batch_write()
        outer = self

        class B:
            has_delete = False

            def __getattr__(self, name):
                if name == "delete":
                    def d(key):
                        self.has_delete = True
                        real.delete(key)
                    return d
                return getattr(real, name)

            def commit(self):
                if self.has_delete:
                    outer._deleting()
                real.commit()

        return B()


def _compact_after_failure(api, fail_on):
    holder = {}

    def wrap(s):
        holder["w"] = FailNthDelete(s, api.errors, fail_on)
        return holder["w"]

    kw = {"device": "cpu"} if api is PORT else {}
    store = api.new_storage(api.mirror, inner="memkv", inner_wrap=wrap, **kw)
    b = api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=2048))
    inner = holder["w"]._store
    K = b"/registry/pods/a"
    try:
        r1 = b.create(K, b"v1")
        r2 = b.update(K, b"v2", r1)
        assert api.backend.wait_for_revision(b, r2)
        out = [name_of(lambda: b.compact(r2), api.errors.StorageError)]
        out.append(name_of(lambda: b.get(K, revision=r1).value,
                           api.backend.CompactedError))
        out.append(b.get(K).value)
        if fail_on:  # the failure was transient: the next compaction GCs
            r3 = b.create(b"/registry/pods/b", b"x")
            assert api.backend.wait_for_revision(b, r3)
            out.append(name_of(lambda: b.compact(r3), api.errors.StorageError))
        out.append(name_of(
            lambda: inner.get(api.coder.encode_object_key(K, r1)),
            api.errors.KeyNotFoundError))
        return out + [holder["w"].calls, list(inner.iter(b"", b""))]
    finally:
        b.close()
        store.close()


def test_compact_retries_through_transient_failure():
    """A GC that fails once: the mirror engines' compaction raises it (the
    device path has no per-partition retry) with the watermark already
    persisted; the next compaction GCs the superseded version. Equal
    outcomes and stores in both packages."""
    j, p = both(_compact_after_failure, 1)
    assert p == j
    assert p[:5] == ["StorageError", "CompactedError", b"v2", p[3],
                     "KeyNotFoundError"] and isinstance(p[3], int)


def test_compact_consistence_after_permanent_failure():
    """A GC that always fails: reads stay consistent, the watermark fences
    stale reads and the live data survives, in both packages alike."""
    j, p = both(_compact_after_failure, 0)
    assert p == j
    assert p[:4] == ["StorageError", "CompactedError", b"v2", b"v1"]


def _ttl_expiry(api):
    kw = {"device": "cpu"} if api is PORT else {}
    store = api.new_storage(api.mirror, inner="memkv", ttl_supported=False,
                            **kw)
    b = api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=2048))
    nf = api.errors.KeyNotFoundError
    KE, KN = b"/events/ev1", b"/registry/pods/a"
    mod, ttl0 = api.scanner_mod, api.scanner_mod.EVENTS_TTL_SECONDS
    try:
        b.create(KE, b"event-payload")
        r2 = b.create(KN, b"pod")
        assert api.backend.wait_for_revision(b, r2)
        out = [b.compact(r2), b.get(KE).value]
        hist = b.scanner.compact_history
        mod.EVENTS_TTL_SECONDS = 0.5
        with hist._lock:
            hist._entries = [(rev, t - 3600) for rev, t in hist._entries]
        r3 = b.create(b"/registry/pods/b", b"x")
        assert api.backend.wait_for_revision(b, r3)
        b.compact(r3)
        return out + [name_of(lambda: b.get(KE), nf),
                      name_of(lambda: store.get(
                          api.coder.encode_revision_key(KE)), nf),
                      b.get(KN).value, list(store.iter(b"", b""))]
    finally:
        mod.EVENTS_TTL_SECONDS = ttl0
        b.close()
        store.close()


def test_ttl_expiry_via_compaction():
    """An engine without TTL: /events/ keys expire through the compaction
    history's cutoff (K3's TTL rule in the port), as in the JAX engine."""
    j, p = both(_ttl_expiry)
    assert p == j
    assert p[1:5] == [b"event-payload", "KeyNotFoundError", "KeyNotFoundError",
                      b"pod"]


def _skip_prefixes(api, inner):
    kw = {"device": "cpu"} if api is PORT else {}
    store = api.new_storage(api.mirror, inner=inner, **kw)
    b = api.backend.Backend(store, api.backend.BackendConfig(
        event_ring_capacity=2048, skip_prefixes=[b"/skipme/"]))
    try:
        r1 = b.create(b"/registry/a", b"v1")
        b.update(b"/registry/a", b"v2", r1)
        s1 = b.create(b"/skipme/x", b"s1")
        s2 = b.update(b"/skipme/x", b"s2", s1)
        assert api.backend.wait_for_revision(b, s2)
        b.compact(s2)
        raw = store._inner
        return [name_of(lambda: raw.get(api.coder.encode_object_key(
                    b"/registry/a", r1)), api.errors.KeyNotFoundError),
                raw.get(api.coder.encode_object_key(b"/skipme/x", s1)),
                list(raw.iter(b"", b""))]
    finally:
        b.close()
        store.close()


def _lease_compact(api, inner):
    b, store = mirror_backend(api, inner)
    reg = api.lease.ensure_lease(b, reap_interval=0.05,
                                 checkpoint_interval=60.0)
    key = b"/registry/pods/leased-compact"
    try:
        lease = reg.grant(0.3)
        r1 = b.create(key, b"v1", lease=lease.id)
        r2 = b.create(b"/registry/pods/other", b"x")
        assert api.backend.wait_for_revision(b, r2)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and reg.ids():
            time.sleep(0.05)
        assert name_of(lambda: b.get(key),
                       api.errors.KeyNotFoundError) == "KeyNotFoundError"
        r_del = b.current_revision()
        assert r_del > r2  # the expiry consumed a real revision
        r3 = b.create(b"/registry/pods/after", b"y")
        assert api.backend.wait_for_revision(b, r3)
        assert b.compact(r3) == r3
        fenced = name_of(lambda: b.get(key, revision=r1),
                         api.backend.CompactedError)
        # the version chain is gone from the store: record and object rows
        gone = [name_of(lambda k=k: store.get(k), api.errors.KeyNotFoundError)
                for k in (api.coder.encode_revision_key(key),
                          api.coder.encode_object_key(key, r1))]
        return (r1, r2, r_del, r3, fenced, gone,
                scan(b, b"/registry/", b"/registry0"),
                b.scanner.compact_count)
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_lease_expiry_deletes_compact_correctly(inner):
    """A lease's expiry is an ordinary revision-stamped tombstone: a
    compaction past it fences the old revision and GCs the key's record
    and object rows like a user delete, through the mirror's device
    compaction, exactly as in the JAX engine."""
    want, got = both(_lease_compact, inner)
    assert got == want
    assert got[4] == "CompactedError"
    assert got[5] == ["KeyNotFoundError"] * 2
    assert [r[0] for r in got[6]] == [b"/registry/pods/after",
                                      b"/registry/pods/other"]


@pytest.mark.parametrize("inner", ["memkv", "native"])
def test_skip_prefixes_excluded_from_compaction(inner):
    j, p = both(_skip_prefixes, inner)
    assert p == j
    assert p[:2] == ["KeyNotFoundError", b"s1"]


# --------------------------------------------- the GC fast paths, wrapped
def _gc_paths(api, monkeypatch):
    calls = []
    native_mod = type(api.new_storage("native"))
    for name in ("bulk_gc", "prune_versions"):
        real = getattr(native_mod, name)

        def spy(self, *args, _real=real, _name=name):
            calls.append(_name)
            return _real(self, *args)

        monkeypatch.setattr(native_mod, name, spy)
    out = []
    for wrapped in (False, True):
        calls.clear()
        p = plane(api, "none", armed=True) if wrapped else None
        b, store = mirror_backend(api, "native", p)
        try:
            r = b.create(b"/registry/a", b"v1")
            r = b.update(b"/registry/a", b"v2", r)
            d = b.create(b"/registry/d", b"x")
            d, _ = b.delete(b"/registry/d", d)
            b.compact(d)
            out.append((wrapped, sorted(set(calls)),
                        list(store._inner.iter(b"", b"")) if not wrapped
                        else list(store._inner._inner.iter(b"", b""))))
        finally:
            b.close()
            store.close()
    return out


def test_gc_fast_paths_reach_native_through_untracked_and_faulty(monkeypatch):
    """Compaction over native reaches ``kb_bulk_gc`` and ``kb_prune``
    through ``untracked()``; under a ``FaultyStorage`` (``inner_wrap``),
    which mirrors ``prune_versions`` but not ``bulk_gc``, the victims go
    through batch deletes and the prune still runs. The same in both
    packages, with the same stores after."""
    p = _gc_paths(PORT, monkeypatch)
    monkeypatch.undo()
    j = _gc_paths(JAX, monkeypatch)
    assert p == j
    assert p[0][1] == ["bulk_gc", "prune_versions"]
    assert p[1][1] == ["prune_versions"]
    assert p[0][2] == p[1][2]


# ------------------------------------------------- divergences, pinned
def _uncertain_single_write(api):
    b, store = mirror_backend(api, "native",
                              scripted(api, [None, ("uncertain_applied", 0.0)]))
    try:
        b.create(b"/t/a", b"1")
        b.scanner.publish()
        with pytest.raises(api.errors.UncertainResultError):
            b.create(b"/t/b", b"2")
        rev = b.current_revision()
        quarantined = b.scanner._mirror_state != "serving" or \
            b.scanner.rebuild_bg_count > 0
        wait_serving(b.scanner)
        served = [(kv.key, kv.revision) for kv in
                  b.scanner.range_(b"/t/", b"/t0", rev)[0]]
        host = [(kv.key, kv.revision) for kv in
                api.Scanner.range_(b.scanner, b"/t/", b"/t0", rev)[0]]
        return quarantined, served, host
    finally:
        b.close()
        store.close()


def test_uncertain_single_write_quarantines_the_port_mirror():
    """An uncertain one-call write that landed: the port quarantines its
    mirror, and its answer at that revision then equals the store's; the
    JAX engine's mirror stays serving without the row."""
    quarantined, served, host = _uncertain_single_write(PORT)
    assert quarantined and served == host == [(b"/t/a", 1), (b"/t/b", 2)]
    quarantined, served, host = _uncertain_single_write(JAX)
    assert not quarantined and served == [(b"/t/a", 1)] and host != served


def _recorded_twice(api):
    b, store = mirror_backend(api, "memkv", merge_threshold=10 ** 9)
    try:
        for i in range(6):
            b.create(b"/t/k%d" % i, b"v%d" % i)
        b.scanner.publish()
        # a write the published mirror already holds, recorded again (as
        # one committed before a background rebuild's snapshot and recorded
        # after its start lands in the rebuilt mirror and the kept delta)
        kv = b.get(b"/t/k3")
        b.scanner.record_version_rows([(kv.key, kv.revision, kv.value)])
        b.scanner.publish()  # merges the delta
        b.compact(b.current_revision())
        return scan(b), [(kv.key, kv.value, kv.revision) for kv in
                         api.Scanner.range_(b.scanner, b"/t/", b"/t0",
                                            b.current_revision())[0]]
    finally:
        b.close()
        store.close()


def test_a_row_recorded_twice_is_merged_once():
    """The port merges a delta row the mirror holds once, and compaction
    keeps the live row in the store; the JAX engine keeps both copies and
    its compaction deletes the live row from the store (its mirror still
    shows it)."""
    served, host = _recorded_twice(PORT)
    assert served == host and len(served) == 6
    served, host = _recorded_twice(JAX)
    assert len(served) == 6 and b"/t/k3" not in [k for k, _v, _r in host]


def _head_read_across_compaction(api, window, kind):
    """A head read of ``kind`` through which a compaction to a newer head
    lands at ``window``: between the read's two resolution steps (the
    watermark and the committed head) or between its resolution and its
    scan. Returns (what the read answered, whether the compaction ran)."""
    b, store = mirror_backend(api)
    main = threading.current_thread()
    armed = [True]
    try:
        r1 = b.create(b"/t/a", b"v1")
        r2 = b.update(b"/t/a", b"v2", r1)
        assert api.backend.wait_for_revision(b, r2)

        def hooked(orig):
            def call(*a, **kw):
                if armed[0] and threading.current_thread() is main:
                    armed[0] = False
                    r = b.create(b"/t/b", b"x")
                    assert api.backend.wait_for_revision(b, r)
                    assert b.compact(r) == r
                return orig(*a, **kw)
            return call

        if window == "resolve":
            owner, name = b, "_compact_revision_cached"
        else:
            owner, name = b.scanner, {"list": "range_", "count": "count",
                                      "batch": "scan_batch"}[kind]
        setattr(owner, name, hooked(getattr(owner, name)))

        def answer(res):
            if isinstance(res, BaseException):
                return type(res).__name__
            if isinstance(res, tuple):
                return res[0]
            return [(kv.key, kv.value) for kv in res.kvs]

        if kind == "batch":
            got = [answer(r) for r in b.list_batch([
                ("list", b"/t/", b"/t0", 0, 0), ("count", b"/t/", b"/t0", 0)])]
        else:
            read = b.list_ if kind == "list" else b.count
            got = name_of(lambda: answer(read(b"/t/", b"/t0")),
                          api.backend.CompactedError)
        return got, not armed[0]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("kind", ["list", "count", "batch"])
@pytest.mark.parametrize("window", ["resolve", "scan"])
def test_head_read_resolves_again_past_a_compaction(window, kind):
    """etcd serves a revision-0 Range at the current revision and never
    fails it with ErrCompacted. The JAX Backend fails a head read that a
    compaction passes while it resolves (it reads the committed head before
    the watermark) or before its scan; the port's resolves it again and
    answers at the newer head. A kept divergence (ROADMAP section 3)."""
    rows = [(b"/t/a", b"v2"), (b"/t/b", b"x")]
    want = {"list": rows, "count": 2, "batch": [rows, 2]}[kind]
    (jax_got, jax_ran), (port_got, port_ran) = both(
        _head_read_across_compaction, window, kind)
    assert jax_ran and port_ran
    assert port_got == want
    if kind == "batch":
        assert "CompactedError" in jax_got
    else:
        assert jax_got == "CompactedError"


MIRROR_COLUMNS = ("keys_host", "lens_host", "revs_host", "tomb_host",
                  "ttl_host", "n_valid")


def test_gc_failing_midway_quarantines_and_rebuilds():
    """A compaction whose gc fails at its second batch commit, after the
    first batch of deletes landed: ``compact`` raises, the mirror is
    quarantined, so no read returns a row the gc deleted from the store,
    the error is counted, and the one background rebuild leaves a mirror
    equal to a fresh build from the store."""
    script = scripted(PORT, [])
    b, store = mirror_backend(PORT, plane_=script, merge_threshold=4096)
    sc = b.scanner
    inner = store.untracked()
    host = TScanner(inner, get_compact_revision=lambda _s: 0)
    keys = [b"/t/k%04d" % i for i in range(600)]
    try:
        created = {k: b.create(k, b"v1-" + k) for k in keys}
        for k in keys:
            b.update(k, b"v2-" + k, created[k])
        head = b.current_revision()
        assert tbackend.wait_for_revision(b, head)
        r_old = max(created.values())
        sc.publish()
        epoch = sc._poison_epoch
        # hold the rebuild back so the quarantine is observed before it
        assert sc._rebuild_kick.acquire(blocking=False)
        # 600 superseded versions: gc batches of 256; the second fails
        script.script = [None, ("error", 0.0)]
        with pytest.raises(terrors.StorageError, match="injected"):
            sc.compact(b"", b"", head)
        gone = [k for k in keys if name_of(
            lambda: inner.get(coder.encode_object_key(k, created[k])),
            terrors.KeyNotFoundError) == "KeyNotFoundError"]
        assert len(gone) == 256  # the first batch's deletes stand
        assert sc._mirror_state == "quarantined"
        assert sc._poison_epoch == epoch + 1 and sc.compact_errors == 1
        assert isinstance(sc._compact_last_error, terrors.StorageError)
        for rev in (r_old, head):
            kvs, _ = sc.range_(b"/t/", b"/t0", rev)
            want, _ = host.range_(b"/t/", b"/t0", rev)
            got = [(kv.key, kv.value, kv.revision) for kv in kvs]
            assert got == [(kv.key, kv.value, kv.revision) for kv in want]
            assert not [r for r in got if r[0] in gone and r[2] == created[r[0]]]
        assert sc.count(b"/t/", b"/t0", r_old) == host.count(
            b"/t/", b"/t0", r_old)
        sc._rebuild_kick.release()
        sc._kick_rebuild()
        wait_serving(sc)
        assert sc.rebuild_bg_count == 1
        fresh = sc._build_mirror_from_store()
        with sc._mlock:
            rebuilt = sc._mirror
        for col in MIRROR_COLUMNS:
            assert np.array_equal(getattr(rebuilt, col), getattr(fresh, col)), col
        kvs, _ = sc.range_(b"/t/", b"/t0", head)
        assert [kv.value for kv in kvs] == [b"v2-" + k for k in keys]
    finally:
        b.close()
        store.close()
