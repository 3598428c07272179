"""The port's request scheduler (``kubebrain_tpu_torch/sched``) against the
JAX package's.

Counterparts of the 10 tests of ``tests/test_sched.py`` that need no
endpoint (``test_shed_returns_resource_exhausted_on_wire`` waits for the
port's gRPC front) and of the 7 tests of ``tests/test_sched_batch.py``. The
backend-level tests run the port's ``cuda`` engine on the CPU (its K1/K2
plain path) and hold every answer against the JAX package's on the same
population; the mesh cases of the JAX tests become the port's one device,
and the Pallas-interpret case compares the port's K2 plain path with the
JAX engine's Pallas kernel in interpret mode. Last, a differential: the
same seeded stream of reads and writes, queued in the same order behind a
plugged slot, goes through the JAX scheduler over the JAX ``tpu`` engine
and through the port's over ``cuda``; every response and the final store
are equal, and both schedulers batch reads and group writes.
"""

import random
import threading
import time

import pytest

import kubebrain_tpu.sched as jsched
from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.parallel.mesh import make_mesh
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.errors import CompactedError
from kubebrain_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from kubebrain_tpu_torch.sched import (
    Lane,
    RequestScheduler,
    SchedConfig,
    SchedOverloadError,
    classify,
    classify_write,
    ensure_scheduler,
)
from kubebrain_tpu_torch.sched.scheduler import _LaneQueue, _Request
from kubebrain_tpu_torch.storage import new_storage


def _snapshot(res):
    """Byte-string fingerprint of a RangeResult (order included)."""
    out = [b"%d|%d|%d" % (res.revision, res.count, int(res.more))]
    for kv in res.kvs:
        out.append(kv.key + b"\x00" + kv.value + b"\x00%d" % kv.revision)
    return b"\xff".join(out)


def _kvs(kvs):
    return [(kv.key, kv.value, kv.revision) for kv in kvs]


def _cuda_backend(host_limit_threshold=0, merge_threshold=10 ** 9,
                  mesh=None):
    """The port's ``cuda`` engine over memkv on the CPU: the device path
    for every unpaged read, the delta kept as a live overlay; ``mesh``
    splits its mirror over CPU slots."""
    store = new_storage("cuda", inner="memkv", device="cpu", mesh=mesh)
    backend = Backend(store, BackendConfig(event_ring_capacity=8192,
                                           watch_cache_capacity=4096))
    backend.scanner._host_limit_threshold = host_limit_threshold
    backend.scanner._merge_threshold = merge_threshold
    return store, backend


def _tpu_backend(n_devices=1, scan_kernel="jnp", host_limit_threshold=0,
                 merge_threshold=10 ** 9):
    """The JAX ``tpu`` engine over memkv, set up as ``test_sched_batch``
    sets it up."""
    mesh = make_mesh(n_devices=n_devices)
    store = j_new_storage("tpu", inner="memkv", mesh=mesh)
    backend = JBackend(store, JConfig(event_ring_capacity=8192,
                                      watch_cache_capacity=4096))
    sc = backend.scanner
    sc._host_limit_threshold = host_limit_threshold
    sc._merge_threshold = merge_threshold
    if scan_kernel != "jnp":
        sc._scan_kernel = scan_kernel
        sc._kernel_mesh = mesh
    return store, backend


def _memkv_backend(api):
    if api == "port":
        store = new_storage("memkv")
        return store, Backend(store, BackendConfig(event_ring_capacity=8192))
    store = j_new_storage("memkv")
    return store, JBackend(store, JConfig(event_ring_capacity=8192))


def _populate(backend, rng, n_keys=50, n_ops=120):
    """Create/update/delete churn (``test_sched_batch``'s); returns (keys,
    revision checkpoints). The same seed gives the same operations on any
    backend in the same state."""
    keys = [b"/registry/%s/obj-%04d" % (
        rng.choice([b"pods", b"services", b"secrets"]), i)
        for i in range(n_keys)]
    checkpoints = []
    for k in keys:
        backend.create(k, b"v0-" + k)
    checkpoints.append(backend.current_revision())
    for _ in range(n_ops):
        k = rng.choice(keys)
        try:
            kv = backend.get(k)
            if rng.random() < 0.2:
                backend.delete(k, kv.revision)
            else:
                backend.update(k, b"v%d" % rng.randrange(10 ** 6), kv.revision)
        except Exception:
            try:
                backend.create(k, b"re-" + k)
            except Exception:
                pass
        if rng.random() < 0.1:
            checkpoints.append(backend.current_revision())
    checkpoints.append(backend.current_revision())
    return keys, checkpoints


def _overlay_churn(backend, rng, keys, n=20, new=b"overlay-new"):
    for k in rng.sample(keys, n):
        try:
            kv = backend.get(k)
            if rng.random() < 0.3:
                backend.delete(k, kv.revision)
            else:
                backend.update(k, b"overlay", kv.revision)
        except Exception:
            try:
                backend.create(k, new)
            except Exception:
                pass


def _workloads(rng, keys, checkpoints, n=40):
    bounds = sorted(rng.sample(keys, min(16, len(keys)))) + \
        [b"/registry/", b"/registry0"]
    out = []
    for _ in range(n):
        a, b = rng.choice(bounds), rng.choice(bounds)
        if a > b:
            a, b = b, a
        if a == b:
            b = a + b"\xff"
        rev = rng.choice([0] + checkpoints)
        if rng.random() < 0.25:
            out.append(("count", a, b, rev))
        else:
            out.append(("list", a, b, rev, rng.choice([0, 0, 3, 25, 500])))
    return out


def _plug(sched):
    """Plug a depth-1 scheduler's slot: returns the release event."""
    release = threading.Event()
    sched.submit_async(release.wait, Lane.SYSTEM)
    time.sleep(0.15)
    return release


# ---------------------------------------------------------------- lanes
def test_classify_lanes():
    assert classify(b"/registry/leases/kube-system/x", b"", 0) is Lane.SYSTEM
    assert classify(b"/registry/masterleases/1.2.3.4", b"", 0) is Lane.SYSTEM
    assert classify(b"/registry/pods/", b"/registry/pods0", 500) is Lane.NORMAL
    assert classify(b"/registry/pods/", b"/registry/pods0", 0) is Lane.BACKGROUND
    assert classify(b"/registry/pods/", b"/registry/pods0",
                    count_only=True) is Lane.NORMAL
    assert classify(b"", b"", 0) is Lane.BACKGROUND
    assert classify(b"/registry/pods/a", b"", limit=10) is Lane.NORMAL
    # the same lane as the JAX scheduler for every shape
    starts = [b"", b"/registry/leases/a", b"/registry/pods/", b"compact_rev_key",
              b"/registry/services/endpoints/kube-system/x", b"/events/x"]
    for s in starts:
        assert classify_write(s).value == jsched.classify_write(s).value
        for limit in (0, 1, 500):
            for count_only in (False, True):
                assert classify(s, b"", limit, count_only).value == \
                    jsched.classify(s, b"", limit, count_only).value


# --------------------------------------------------- generic submit layer
def test_submit_runs_and_returns():
    s = RequestScheduler(None, SchedConfig(depth=2))
    try:
        assert s.submit(lambda: 41 + 1) == 42
    finally:
        s.close()


def test_submit_propagates_exceptions():
    s = RequestScheduler(None, SchedConfig(depth=2))
    try:
        with pytest.raises(ValueError):
            s.submit(lambda: (_ for _ in ()).throw(ValueError("boom")))
    finally:
        s.close()


def test_queue_full_sheds_immediately():
    s = RequestScheduler(None, SchedConfig(depth=1, queue_limit=2))
    release = threading.Event()
    try:
        s.submit_async(release.wait, Lane.NORMAL)  # occupies the one slot
        time.sleep(0.1)
        sheds = 0
        for _ in range(4):
            try:
                s.submit_async(lambda: None, Lane.NORMAL)
            except SchedOverloadError:
                sheds += 1
        assert sheds >= 1
        assert s.shed_counts[Lane.NORMAL] == sheds
    finally:
        release.set()
        s.close()


def test_deadline_shed_on_stale_requests():
    s = RequestScheduler(None, SchedConfig(depth=1, shed_ms=50.0))
    release = threading.Event()
    try:
        s.submit_async(release.wait, Lane.NORMAL)
        time.sleep(0.1)
        stale = s.submit_async(lambda: "ran", Lane.NORMAL)
        time.sleep(0.2)
        release.set()
        with pytest.raises(SchedOverloadError):
            stale.wait(5.0)
        assert s.shed_counts[Lane.NORMAL] >= 1
    finally:
        release.set()
        s.close()


def test_lane_queue_round_robin_fair_after_drain_cycles():
    lq = _LaneQueue()

    def mk(c):
        return _Request(lambda: None, Lane.NORMAL, c, None)

    for _ in range(5):
        lq.push(mk("A"))
        assert lq.pop().client == "A"
    for _ in range(6):
        lq.push(mk("A"))
        lq.push(mk("B"))
    got = [lq.pop().client for _ in range(12)]
    assert got == ["A", "B"] * 6, got
    assert lq.pop() is None
    assert not lq.order and not lq.clients and lq.size == 0


# ------------------------------------------------------------- priority
def test_no_priority_inversion_under_background_flood():
    s = RequestScheduler(None, SchedConfig(depth=1, queue_limit=256))
    done: list[str] = []
    lock = threading.Lock()

    def record(tag):
        def fn():
            time.sleep(0.01)
            with lock:
                done.append(tag)
        return fn

    release = threading.Event()
    try:
        s.submit_async(release.wait, Lane.NORMAL)
        time.sleep(0.1)
        bg = [s.submit_async(record(f"bg{i}"), Lane.BACKGROUND)
              for i in range(30)]
        sys_req = s.submit_async(record("system"), Lane.SYSTEM)
        release.set()
        sys_req.wait(10.0)
        for r in bg:
            r.wait(10.0)
        assert "system" in done[:2], done[:5]
    finally:
        release.set()
        s.close()


def test_overload_high_priority_p99_bounded_at_10x():
    qlimit = 16
    s = RequestScheduler(None, SchedConfig(depth=2, queue_limit=qlimit,
                                           shed_ms=30_000.0))
    stop = threading.Event()
    shed = 0
    shed_lock = threading.Lock()
    admitted = []
    try:
        def flood():
            nonlocal shed
            while not stop.is_set():
                try:
                    req = s.submit_async(lambda: time.sleep(0.005),
                                         Lane.BACKGROUND)
                    with shed_lock:
                        admitted.append(req)
                except SchedOverloadError:
                    with shed_lock:
                        shed += 1
        flooders = [threading.Thread(target=flood, daemon=True)
                    for _ in range(4)]
        for t in flooders:
            t.start()
        time.sleep(0.2)
        lat = []
        for _ in range(20):
            t0 = time.monotonic()
            s.submit(lambda: None, Lane.SYSTEM)
            lat.append(time.monotonic() - t0)
        stop.set()
        for t in flooders:
            t.join(5.0)
        assert not any(t.is_alive() for t in flooders)
        lat.sort()
        assert lat[-1] < 2.0, f"system p99 {lat[-1]:.3f}s under background flood"
        assert shed > len(admitted), (shed, len(admitted))
        assert s.shed_counts[Lane.BACKGROUND] == shed
    finally:
        stop.set()
        s.close()


# ------------------------------------------------- backend-level parity
def _fixed_population(backend, seed=20260803):
    rng = random.Random(seed)
    keys = []
    checkpoints = []
    for i in range(60):
        k = b"/registry/%s/obj-%04d" % (
            rng.choice([b"pods", b"services", b"secrets"]), i)
        keys.append(k)
        backend.create(k, b"v0-%d" % i)
    checkpoints.append(backend.current_revision())
    for k in rng.sample(keys, 30):
        backend.update(k, b"v1-" + k, backend.get(k).revision)
    checkpoints.append(backend.current_revision())
    for k in rng.sample(keys, 10):
        try:
            backend.delete(k)
        except Exception:
            pass
    checkpoints.append(backend.current_revision())
    return rng, keys, checkpoints


def test_scheduled_results_byte_identical_randomized():
    """Randomized Range workloads through the port's scheduler over the
    ``cuda`` engine: byte-identical to its unscheduled answers and to the
    JAX package's unscheduled answers on the same population."""
    store, backend = _cuda_backend(merge_threshold=64)
    jstore, jbackend = _memkv_backend("jax")
    sched = ensure_scheduler(backend, SchedConfig(depth=4))
    try:
        rng, keys, checkpoints = _fixed_population(backend)
        _fixed_population(jbackend)
        bounds = sorted(rng.sample(keys, 20)) + [b"/registry/", b"/registry0"]
        workloads = []
        for _ in range(40):
            a, b = rng.choice(bounds), rng.choice(bounds)
            if a > b:
                a, b = b, a
            if a == b:
                b = a + b"\xff"
            workloads.append((a, b, rng.choice([0] + checkpoints),
                              rng.choice([0, 0, 7, 100])))
        results: dict[int, bytes] = {}

        def run(i, w):
            results[i] = _snapshot(sched.list_(*w))

        threads = [threading.Thread(target=run, args=(i, w))
                   for i, w in enumerate(workloads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        for i, w in enumerate(workloads):
            assert results[i] == _snapshot(backend.list_(*w)), w
            assert results[i] == _snapshot(jbackend.list_(*w)), w
        for a, b, rev, _ in workloads[:10]:
            assert sched.count(a, b, rev) == backend.count(a, b, rev) == \
                jbackend.count(a, b, rev)
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_coalescing_preserves_read_revision_visibility():
    """Identical queued requests coalesce into one execution; requests at
    different explicit revisions never share results; every answer equals
    the JAX package's on the same history."""
    store, backend = _cuda_backend()
    jstore, jbackend = _memkv_backend("jax")
    sched = ensure_scheduler(backend, SchedConfig(depth=1, queue_limit=256))
    release = threading.Event()
    try:
        for b in (backend, jbackend):
            for i in range(20):
                b.create(b"/registry/co/k%03d" % i, b"v0")
        r1 = backend.current_revision()
        for b in (backend, jbackend):
            for i in range(20):
                k = b"/registry/co/k%03d" % i
                b.update(k, b"v1", b.get(k).revision)
        r2 = backend.current_revision()
        assert jbackend.current_revision() == r2

        release = _plug(sched)
        outs: dict[int, object] = {}
        revs = [r1, r2, r1, r2, r1, r2, r1, r1]

        def run(i):
            outs[i] = sched.list_(b"/registry/co/", b"/registry/co0", revs[i], 0)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(revs))]
        for t in threads:
            t.start()
        time.sleep(0.3)
        release.set()
        for t in threads:
            t.join(20.0)
        assert sched.coalesced > 0
        for i, rev in enumerate(revs):
            want = jbackend.list_(b"/registry/co/", b"/registry/co0", rev, 0)
            assert _snapshot(outs[i]) == _snapshot(want), rev
        assert _snapshot(outs[0]) != _snapshot(outs[1])
    finally:
        release.set()
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


# ------------------------------------------------ batched device scans
def test_batched_vs_sequential_byte_identical_randomized():
    """Randomized Range/Count workloads executed as scheduler batches
    (plugged single slot) over a live delta overlay are byte-identical to
    sequential unscheduled execution, and to the JAX ``tpu`` engine's
    sequential answers on the same history."""
    rng = random.Random(20260803)
    jrng = random.Random(20260803)
    store, backend = _cuda_backend()
    jstore, jbackend = _tpu_backend()
    sc = backend.scanner
    sched = ensure_scheduler(backend, SchedConfig(depth=1, queue_limit=512,
                                                  batch=8))
    release = threading.Event()
    try:
        keys, checkpoints = _populate(backend, rng)
        assert (keys, checkpoints) == _populate(jbackend, jrng)
        sc.publish()
        jbackend.scanner.publish()
        _overlay_churn(backend, rng, keys)
        _overlay_churn(jbackend, jrng, keys)
        checkpoints.append(backend.current_revision())
        assert len(sc._delta) > 0, "test needs a live overlay"

        workloads = _workloads(rng, keys, checkpoints, n=48)
        sc._host_limit_threshold = 4  # limit-3 lists take the host path
        jbackend.scanner._host_limit_threshold = 4
        release = _plug(sched)
        results: dict[int, object] = {}

        def run(i, w):
            try:
                if w[0] == "count":
                    results[i] = sched.count(w[1], w[2], w[3], client=f"c{i%5}")
                else:
                    results[i] = sched.list_(w[1], w[2], w[3], w[4],
                                             client=f"c{i%5}")
            except BaseException as e:  # surfaced to the assert below
                results[i] = e

        threads = [threading.Thread(target=run, args=(i, w))
                   for i, w in enumerate(workloads)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        release.set()
        for t in threads:
            t.join(60.0)
        assert sched.batched > 0, "no batches formed"
        assert len(sc._delta) > 0, "overlay merged away mid-test"
        for i, w in enumerate(workloads):
            assert not isinstance(results[i], BaseException), (w, results[i])
            if w[0] == "count":
                assert results[i] == backend.count(w[1], w[2], w[3]) == \
                    jbackend.count(w[1], w[2], w[3]), w
            else:
                want = _snapshot(jbackend.list_(w[1], w[2], w[3], w[4]))
                assert _snapshot(results[i]) == want, w
                assert _snapshot(backend.list_(w[1], w[2], w[3], w[4])) == want
    finally:
        release.set()
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


SPECS = lambda head: [  # noqa: E731
    ("range", b"/registry/pods/", b"/registry/pods0", head, 0),
    ("count", b"/registry/", b"/registry0", head),
    ("range", b"/registry/", b"/registry0", head, 0),
    ("count", b"/registry/pods/", b"/registry/pods0", head),
]


def _scan_results(res):
    return [r if isinstance(r, int) else (_kvs(r[0]), r[1]) for r in res]


def test_count_rides_the_same_launch_as_range():
    """A mixed Range+Count batch costs exactly one ``_dev_mask_batch``
    call (one K2 launch on the card) and no single-query ``_dev_mask``
    (K1); the answers equal the JAX engine's ``scan_batch``."""
    store, backend = _cuda_backend()
    jstore, jbackend = _tpu_backend()
    sc = backend.scanner
    try:
        _populate(backend, random.Random(7), n_keys=30, n_ops=40)
        _populate(jbackend, random.Random(7), n_keys=30, n_ops=40)
        sc.publish()
        jbackend.scanner.publish()
        head = backend.current_revision()
        calls = {"batch": 0, "single": 0}
        orig_batch, orig_single = sc._dev_mask_batch, sc._dev_mask

        def count_batch(*a, **kw):
            calls["batch"] += 1
            return orig_batch(*a, **kw)

        def count_single(*a, **kw):
            calls["single"] += 1
            return orig_single(*a, **kw)

        sc._dev_mask_batch, sc._dev_mask = count_batch, count_single
        got = sc.scan_batch(SPECS(head))
        assert calls == {"batch": 1, "single": 0}, calls
        sc._dev_mask_batch, sc._dev_mask = orig_batch, orig_single
        assert _scan_results(got) == \
            _scan_results(jbackend.scanner.scan_batch(SPECS(head)))
        for spec, g in zip(SPECS(head), got):
            if spec[0] == "count":
                assert g == sc.count(spec[1], spec[2], spec[3]), spec
            else:
                kvs, more = sc.range_(spec[1], spec[2], spec[3], spec[4])
                assert g[1] == more and _kvs(g[0]) == _kvs(kvs), spec
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_batched_plain_k2_matches_jax_pallas_interpret():
    """The port's batched path (K2's plain version on the CPU) against the
    JAX engine's batched Pallas kernel in interpret mode on its
    every-device mesh: the same ``scan_batch`` answers on the same op
    sequence."""
    store, backend = _cuda_backend()
    jstore, jbackend = _tpu_backend(n_devices=None,
                                    scan_kernel="pallas_interpret")
    try:
        for b in (backend, jbackend):
            _populate(b, random.Random(3), n_keys=24, n_ops=30)
            b.scanner.publish()
        head = backend.current_revision()
        assert jbackend.current_revision() == head
        specs = [
            ("range", b"/registry/", b"/registry0", head, 0),
            ("count", b"/registry/", b"/registry0", head),
            ("range", b"/registry/pods/", b"/registry/pods0", head, 10),
        ]
        got = backend.scanner.scan_batch(specs)
        assert _scan_results(got) == \
            _scan_results(jbackend.scanner.scan_batch(specs))
        assert got[1] == len(got[0][0]) > 0
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_batched_plain_k2_over_a_port_mesh_matches_jax_pallas_interpret():
    """The same, with the port's mirror split over 8 CPU slots as the JAX
    engine's is over its 8 devices: one K2 call per slot, the same
    ``scan_batch`` answers."""
    store, backend = _cuda_backend(mesh=t_make_mesh(8, device="cpu"))
    jstore, jbackend = _tpu_backend(n_devices=None,
                                    scan_kernel="pallas_interpret")
    try:
        for b in (backend, jbackend):
            _populate(b, random.Random(3), n_keys=24, n_ops=30)
            b.scanner.publish()
        head = backend.current_revision()
        assert jbackend.current_revision() == head
        specs = [
            ("range", b"/registry/", b"/registry0", head, 0),
            ("count", b"/registry/", b"/registry0", head),
            ("range", b"/registry/pods/", b"/registry/pods0", head, 10),
        ]
        got = backend.scanner.scan_batch(specs)
        assert _scan_results(got) == \
            _scan_results(jbackend.scanner.scan_batch(specs))
        assert got[1] == len(got[0][0]) > 0
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_per_query_error_demux_compacted_revision():
    """One compacted read revision inside a batch fails only its own
    waiter; the rest of the batch serves normally."""
    store, backend = _cuda_backend()
    sched = ensure_scheduler(backend, SchedConfig(depth=1, queue_limit=256,
                                                  batch=8))
    release = threading.Event()
    try:
        keys, checkpoints = _populate(backend, random.Random(5), n_keys=20,
                                      n_ops=40)
        old = checkpoints[0]
        assert checkpoints[-1] > old
        backend.compact(checkpoints[-1])
        head = backend.current_revision()

        out = backend.list_batch([
            ("list", b"/registry/", b"/registry0", head, 0),
            ("list", b"/registry/", b"/registry0", old, 0),
            ("count", b"/registry/", b"/registry0", old),
        ])
        assert not isinstance(out[0], BaseException)
        assert isinstance(out[1], CompactedError)
        assert isinstance(out[2], CompactedError)

        release = _plug(sched)
        results: dict[str, object] = {}

        def good():
            results["good"] = sched.list_(b"/registry/", b"/registry0", head, 0)

        def bad():
            try:
                sched.list_(b"/registry/", b"/registry0", old, 0)
                results["bad"] = None
            except CompactedError as e:
                results["bad"] = e

        threads = [threading.Thread(target=good), threading.Thread(target=bad)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        release.set()
        for t in threads:
            t.join(30.0)
        assert sched.batched > 0
        assert isinstance(results["bad"], CompactedError)
        assert _snapshot(results["good"]) == \
            _snapshot(backend.list_(b"/registry/", b"/registry0", head, 0))
    finally:
        release.set()
        backend.close()
        store.close()


def test_host_visible_batch_matches_per_key_oracle():
    """The port's ``_host_visible_batch`` (one searchsorted pass per
    partition) agrees with the JAX engine's per-key ``_host_visible``
    oracle on the same history, for every key: present, deleted,
    superseded and absent."""
    store, backend = _cuda_backend()
    jstore, jbackend = _tpu_backend()
    try:
        keys, checkpoints = _populate(backend, random.Random(13), n_keys=40,
                                      n_ops=80)
        _populate(jbackend, random.Random(13), n_keys=40, n_ops=80)
        backend.scanner.publish()
        jbackend.scanner.publish()
        probes = keys + [b"/registry/absent/x%d" % i for i in range(5)]
        jsc = jbackend.scanner
        for rev in (checkpoints[0], checkpoints[len(checkpoints) // 2],
                    checkpoints[-1]):
            got = backend.scanner._host_visible_batch(
                backend.scanner._mirror, probes, rev)
            want = [jsc._host_visible(jsc._mirror, uk, rev) for uk in probes]
            assert got == want, rev
        assert any(got) and not all(got)
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_count_overlay_correction_batched():
    """count() with a live overlay (adds, deletes, supersedes) matches a
    freshly published mirror's count at every checkpoint, and the JAX
    engine's."""
    store, backend = _cuda_backend()
    jstore, jbackend = _tpu_backend()
    sc = backend.scanner
    try:
        got = {}
        for b, name in ((backend, "port"), (jbackend, "jax")):
            rng = random.Random(17)
            keys, _ = _populate(b, rng, n_keys=30, n_ops=30)
            b.scanner.publish()
            mid = b.current_revision()
            _overlay_churn(b, rng, keys, n=12, new=b"ov-new")
            head = b.current_revision()
            assert len(b.scanner._delta) > 0
            got[name] = (mid, head, b.scanner.count(b"/registry/",
                                                   b"/registry0", mid),
                         b.scanner.count(b"/registry/", b"/registry0", head))
        mid, head = got["port"][:2]
        sc.publish()  # merge the overlay: the pure mirror's counts as oracle
        assert (mid, head, sc.count(b"/registry/", b"/registry0", mid),
                sc.count(b"/registry/", b"/registry0", head)) == got["port"]
        assert got["port"] == got["jax"]
    finally:
        backend.close()
        store.close()
        jbackend.close()
        jstore.close()


def test_batching_does_not_starve_system_lane_at_10x_overload():
    """10x queue oversubscription of batchable BACKGROUND lists: SYSTEM
    reads keep a bounded p99 and batches form under the flood."""
    store, backend = _cuda_backend()
    qlimit = 16
    sched = ensure_scheduler(backend, SchedConfig(depth=2, queue_limit=qlimit,
                                                  shed_ms=30_000.0, batch=8))
    try:
        _populate(backend, random.Random(23), n_keys=30, n_ops=30)
        backend.scanner.publish()
        for i in range(3):
            backend.create(b"/registry/leases/kube-system/l%d" % i, b"x")
        sched.list_(b"/registry/leases/", b"/registry/leases0", 0, 10)
        stop = threading.Event()
        shed = 0
        shed_lock = threading.Lock()

        def flood():
            nonlocal shed
            i = 0
            pending = []
            while not stop.is_set():
                i += 1
                a, b = b"/registry/", b"/registry0"
                lim = 1000 + (i % 64)
                try:
                    pending.append(sched.submit_async(
                        lambda lim=lim: backend.list_(a, b, 0, lim),
                        Lane.BACKGROUND, client=f"f{i % 4}",
                        key=("list", a, b, 0, lim, i),
                        bargs=("list", a, b, 0, lim)))
                except SchedOverloadError:
                    with shed_lock:
                        shed += 1
                if len(pending) >= 64:
                    try:
                        pending[0].wait(30.0)
                    except SchedOverloadError:
                        pass
                    del pending[0]
            for r in pending:
                try:
                    r.wait(30.0)
                except SchedOverloadError:
                    pass

        flooders = [threading.Thread(target=flood, daemon=True)
                    for _ in range(4)]
        for t in flooders:
            t.start()
        time.sleep(0.3)
        lat = []
        for _ in range(20):
            t0 = time.monotonic()
            sched.list_(b"/registry/leases/", b"/registry/leases0", 0, 10)
            lat.append(time.monotonic() - t0)
        stop.set()
        for t in flooders:
            t.join(30.0)
        assert not any(t.is_alive() for t in flooders)
        lat.sort()
        assert lat[-1] < 2.0, f"system p99 {lat[-1]:.3f}s under batched flood"
        assert sched.batched > 0, "flood never formed a batch"
        assert shed > 0, "flood never oversubscribed the queue"
    finally:
        backend.close()
        store.close()


# ------------------------------------------- the differential with JAX
def _queued(sched) -> int:
    return sum(lq.size for lq in sched._queues.values()) + sched.coalesced


def _stream(seed, keys, revs, checkpoints):
    """A seeded stream of reads and writes: Range (paged and not) and
    Count at the head and at checkpoints, creates of new keys, updates
    against the pre-stream revision (some stale after an earlier write in
    the stream) and deletes."""
    rng = random.Random(seed)
    out = []
    spans = [(b"/registry/", b"/registry0"), (b"/registry/pods/", b"/registry/pods0"),
             (b"/registry/services/", b"/registry/services0")]
    for i in range(64):
        roll = rng.random()
        client = "c%d" % rng.randrange(6)
        if roll < 0.55:
            s, e = rng.choice(spans)
            rev = rng.choice([0, 0] + checkpoints)
            if rng.random() < 0.3:
                out.append(("count", (s, e, rev), client))
            else:
                out.append(("list", (s, e, rev, rng.choice([0, 0, 0, 5])),
                            client))
        elif roll < 0.7:
            out.append(("create", (b"/registry/pods/new-%03d" % i, b"n%d" % i),
                        client))
        elif roll < 0.9:
            k = rng.choice(keys)
            out.append(("update", (k, b"u%d" % i, revs[k]), client))
        else:
            k = rng.choice(keys)
            out.append(("delete", (k, rng.choice([0, revs[k]])), client))
    return out


def _fp(res):
    if isinstance(res, BaseException):
        return (type(res).__name__, str(res))
    if isinstance(res, tuple):  # delete: (rev, KeyValue); count: (n, rev)
        a, b = res
        return (a, (b.key, b.value, b.revision) if hasattr(b, "key") else b)
    if isinstance(res, int):
        return res
    return (res.revision, res.count, res.more, _kvs(res.kvs))


def _run_stream(api):
    if api == "port":
        store, backend = _cuda_backend(merge_threshold=32)
        sched = ensure_scheduler(backend, SchedConfig(depth=1, batch=8,
                                                      write_batch=8))
    else:
        store, backend = _tpu_backend(merge_threshold=32)
        sched = jsched.ensure_scheduler(backend, jsched.SchedConfig(
            depth=1, batch=8, write_batch=8))
    release = threading.Event()
    try:
        keys, checkpoints = _populate(backend, random.Random(29), n_keys=30,
                                      n_ops=60)
        backend.scanner.publish()
        revs = {}
        for k in keys:
            try:
                revs[k] = backend.get(k).revision
            except Exception:
                revs[k] = checkpoints[-1]
        stream = _stream(31, keys, revs, checkpoints)
        # one plug runs, a second waits in the dispatcher's hand: every
        # request of the stream then queues, in the order given
        sched.submit_async(release.wait, jsched.Lane.SYSTEM if api == "jax"
                           else Lane.SYSTEM)
        sched.submit_async(release.wait, jsched.Lane.SYSTEM if api == "jax"
                           else Lane.SYSTEM)
        deadline = time.monotonic() + 10
        while _queued(sched) and time.monotonic() < deadline:
            time.sleep(0.005)
        results: list = [None] * len(stream)

        def call(i, op, args, client):
            try:
                results[i] = getattr(sched, op if op != "list" else "list_")(
                    *args, client=client)
            except BaseException as e:  # compared below
                results[i] = e

        threads = []
        for i, (op, args, client) in enumerate(stream):
            t = threading.Thread(target=call, args=(i, op, args, client))
            t.start()
            threads.append(t)
            while _queued(sched) < i + 1:
                assert time.monotonic() < deadline + 30, "request never queued"
                time.sleep(0.001)
        release.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        final = backend.list_(b"/registry/", b"/registry0", 0, 0)
        return ([_fp(r) for r in results],
                (_kvs(final.kvs), backend.current_revision()),
                sched.batched, sched.write_batched)
    finally:
        release.set()
        backend.close()
        store.close()


def test_scheduled_stream_equals_the_jax_scheduler():
    """The same seeded stream of concurrent reads and writes, queued in the
    same order, through the JAX scheduler over the JAX ``tpu`` engine and
    through the port's over ``cuda`` (the same ``SchedConfig``): every
    response and the final store are equal, and both batch reads and
    group writes."""
    got, store, batched, write_batched = _run_stream("port")
    want, jstore, jbatched, jwrite_batched = _run_stream("jax")
    assert store == jstore
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert batched > 0 and write_batched > 0
    assert jbatched > 0 and jwrite_batched > 0
    assert any(isinstance(r, tuple) and isinstance(r[0], str) for r in got), \
        "the stream has no conflicting write"
