"""The port's device mesh on the CPU, held against the JAX package's
(counterparts of ``tests/test_multichip.py``, of the mesh cases of
``tests/test_fanout_device.py`` and ``tests/test_fanout_integration.py``,
and of ``tests/test_graft_entry.py:23``).

A port mesh on the CPU is ``n`` slots of the one CPU device (conftest's 8
virtual XLA host devices stand in for cards on the JAX side): each slot
holds its own tensors, and every kernel wrapper runs once per slot. The
tolerance is exact everywhere: the results are integers and bytes.

- the part-sharded ``cuda`` engine (8 slots; 4 slots of 2 partitions)
  returns what the one-slot engine and the JAX sharded engine (jnp and
  Pallas interpret) return, byte for byte, under live delta overlays;
- a scan pulls O(visible rows): a slot without a visible row pulls only
  its counts;
- a merge re-uploads only the slots that hold a dirty partition, also
  under concurrent writers; ``partitions`` must be a multiple of the
  slots; ``kb.mirror.bytes`` has one series per distinct device;
- the CLI's and the workload spec's mesh knobs validate as the JAX ones;
- the wat-sharded watcher table (``DeviceFanout``, ``FanoutMatcher``)
  delivers the unsharded pairs in the same order, through the hub too;
- ``entry.dryrun_multichip(n)`` serves through the scheduler at mesh
  sizes {1, n} and prints its tail.
"""

import json
import threading
import time

import numpy as np
import pytest

from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.backend.common import WatchEvent as JWatchEvent
from kubebrain_tpu.fanout.matcher import DeviceFanout as JDeviceFanout
from kubebrain_tpu.ops.fanout import FanoutMatcher as JFanoutMatcher
from kubebrain_tpu.parallel.mesh import make_mesh as j_make_mesh
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu.storage.tpu.engine import TpuKvStorage
from kubebrain_tpu_torch import coder, entry
from kubebrain_tpu_torch.backend import Backend, BackendConfig
from kubebrain_tpu_torch.backend.common import WatchEvent
from kubebrain_tpu_torch.device import TRANSFER_METER, _pow2_bucket
from kubebrain_tpu_torch.fanout import DeviceFanout, match_oracle
from kubebrain_tpu_torch.fanout.table import WatcherTable
from kubebrain_tpu_torch.ops.fanout import FanoutMatcher
from kubebrain_tpu_torch.parallel.mesh import Mesh, make_mesh
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.cuda.engine import CudaKvStorage, TorchScanner

from test_torch_fanout_device import _events, _population

NSR = [(b"/registry/pods/ns-%02d/" % ns, b"/registry/pods/ns-%02d0" % ns)
       for ns in range(8)]


def port_backend(slots, partitions=0, merge_threshold=8, mesh=None):
    store = CudaKvStorage(new_storage("memkv"),
                          mesh=mesh or make_mesh(slots, device="cpu"),
                          partitions=partitions)
    b = Backend(store, BackendConfig(event_ring_capacity=8192))
    b.scanner._host_limit_threshold = 0  # always the device path
    b.scanner._merge_threshold = merge_threshold
    return b


def jax_backend(ndev, partitions=0, kernel="jnp", merge_threshold=8):
    mesh = j_make_mesh(n_devices=ndev)
    store = TpuKvStorage(j_new_storage("memkv"), mesh=mesh,
                         partitions=partitions)
    b = JBackend(store, JConfig(event_ring_capacity=8192))
    b.scanner._host_limit_threshold = 0
    b.scanner._merge_threshold = merge_threshold
    b.scanner._scan_kernel = kernel
    b.scanner._kernel_mesh = mesh if kernel != "jnp" else None
    return b


def fp_result(res):
    return [(kv.key, kv.value, kv.revision) for kv in res.kvs] + \
        [(res.revision, res.count, res.more)]


def fp_batch(out):
    fps = []
    for r in out:
        assert not isinstance(r, BaseException), r
        fps.append(r if isinstance(r, tuple) else fp_result(r))
    return fps


def close(*backends):
    for b in backends:
        store = b.store
        b.close()
        store.close()


@pytest.mark.parametrize("kernel", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("ndev,parts", [(8, 0), (4, 8)])
def test_sharded_vs_single_byte_identity_live_overlays(kernel, ndev, parts):
    """A random mixed workload on the one-slot port engine, the sharded one
    (a partition per slot, and two per slot) and the JAX sharded engine
    (``kernel``); every read — head and snapshot Ranges, Counts, mixed
    ``list_batch`` — agrees byte for byte while the sharded engines still
    hold a LIVE delta overlay (their merge threshold is out of reach)."""
    rng = np.random.RandomState(11)
    ref = port_backend(1, merge_threshold=4)
    shard = port_backend(ndev, partitions=parts, merge_threshold=10**9)
    jshard = jax_backend(ndev, partitions=parts, kernel=kernel,
                         merge_threshold=10**9)
    trio = (ref, shard, jshard)
    try:
        live: dict[bytes, int] = {}
        checkpoints = []
        for step in range(160):
            ns = rng.randint(8)
            k = b"/registry/pods/ns-%02d/p-%04d" % (ns, rng.randint(40))
            op = rng.rand()
            if k not in live:
                action = "create"
            elif op < 0.45:
                action = "recreate"
            elif op < 0.85:
                action = "update"
            else:
                action = "delete"
            revs = set()
            for be in trio:
                if action == "create":
                    r = be.create(k, b"v%03d" % step)
                elif action == "recreate":
                    be.delete(k)
                    r = be.create(k, b"v%03d" % step)
                elif action == "update":
                    r = be.update(k, b"u%03d" % step, live[k])
                else:
                    r, _ = be.delete(k)
                revs.add(r)
            assert len(revs) == 1
            if action == "delete":
                live.pop(k)
            else:
                live[k] = r
            if step % 40 == 17:
                checkpoints.append(ref.current_revision())
            if step % 10 == 3:  # reads interleaved with the writes
                s, e = NSR[ns]
                want = fp_result(ref.list_(s, e))
                assert fp_result(shard.list_(s, e)) == want
                assert fp_result(jshard.list_(s, e)) == want
                assert ref.count(s, e) == shard.count(s, e) == \
                    jshard.count(s, e)

        assert len(shard.scanner._delta) > 0  # still overlay-serving
        mirror = shard.scanner._mirror
        assert mirror.partitions == (parts or ndev)
        assert len(mirror.shards) == ndev
        assert [sh.lo for sh in mirror.shards] == list(
            range(0, mirror.partitions, mirror.partitions // ndev))

        want = fp_result(ref.list_(b"/registry/", b"/registry0"))
        for be in (shard, jshard):
            assert fp_result(be.list_(b"/registry/", b"/registry0")) == want
        for rev in checkpoints:
            for s, e in NSR[:4]:
                want = fp_result(ref.list_(s, e, revision=rev))
                assert fp_result(shard.list_(s, e, revision=rev)) == want
                assert fp_result(jshard.list_(s, e, revision=rev)) == want

        # mixed Range/Count batches through the batch executor: one K2
        # launch per slot on the sharded engine, the same demux
        queries = [("count", s, e, 0) if i % 3 == 2 else ("list", s, e, 0, 0)
                   for i, (s, e) in enumerate(NSR)]
        want = fp_batch(ref.list_batch(queries))
        assert fp_batch(shard.list_batch(queries)) == want
        assert fp_batch(jshard.list_batch(queries)) == want
    finally:
        close(*trio)


def _scanner_over_rows(n_rows, slots=8, partitions=0):
    """A published port scanner over ``n_rows`` single-revision keys
    written straight into the host engine."""
    store = CudaKvStorage(new_storage("memkv"),
                          mesh=make_mesh(slots, device="cpu"),
                          partitions=partitions)
    rev = 0
    for base in range(0, n_rows, 2000):
        b = store.begin_batch_write()
        for i in range(base, min(base + 2000, n_rows)):
            rev += 1
            b.put(coder.encode_object_key(b"/registry/pods/p%07d" % i, rev),
                  b"v" * 16)
        b.commit()
    scanner = store.make_scanner(get_compact_revision=lambda _s: 0)
    scanner._host_limit_threshold = 0
    scanner.publish()
    return store, scanner, rev


def test_host_transfer_budget_bounded_by_visible_rows():
    """Per-scan device→host bytes scale with VISIBLE rows, never with the
    dataset: within the JAX test's budget (P·pow2(max per partition)·8
    bytes of indices plus the counts), and tighter: a slot without a
    visible row pulls its counts only."""
    P = 8
    n_rows = 16_384
    store, scanner, head = _scanner_over_rows(n_rows, slots=P)
    try:
        n_pad = scanner._mirror.keys_host.shape[1]
        mask_bytes = P * n_pad
        key_bytes = P * n_pad * scanner._mirror.raw_key_width

        def measured(fn):
            fn()
            b0, _ = TRANSFER_METER.snapshot()
            out = fn()
            b1, _ = TRANSFER_METER.snapshot()
            return out, b1 - b0

        s, e = b"/registry/pods/p0000000", b"/registry/pods/p0000064"
        (kvs, _more), cost = measured(lambda: scanner.range_(s, e, head))
        assert len(kvs) == 64
        budget = P * _pow2_bucket(64, n_pad) * 8 + 16 * P + 64
        assert cost <= budget, (cost, budget)
        # one slot's block of 64 int32 indices and every slot's counts
        assert cost == 64 * 4 + 4 * P, cost
        assert cost < mask_bytes and cost < key_bytes // 100

        (kvs_all, _), cost_all = measured(lambda: scanner.range_(
            b"/registry/pods/", b"/registry/pods0", head))
        assert len(kvs_all) == n_rows
        per_shard = -(-n_rows // P)
        assert cost_all <= P * _pow2_bucket(per_shard, n_pad) * 8 + 16 * P + 64
        assert cost_all < key_bytes // 10

        def batched():
            return scanner.scan_batch([
                ("range", s, e, head, 0),
                ("count", b"/registry/pods/", b"/registry/pods0", head),
                ("range", b"/registry/pods/p0001000",
                 b"/registry/pods/p0001032", head, 0),
            ])
        out, cost_b = measured(batched)
        assert out[1] == n_rows and len(out[0][0]) == 64 \
            and len(out[2][0]) == 32
        qpad = 4
        budget_b = qpad * P * _pow2_bucket(64, n_pad) * 8 + qpad * P * 8 + 64
        assert cost_b <= budget_b, (cost_b, budget_b)
        assert cost_b < mask_bytes
    finally:
        store.close()


def _slots_kept(before, after) -> list[int]:
    """The slots whose shard ``after`` carried over from ``before``: the
    same object, the same tensors."""
    kept = []
    for i, (a, b) in enumerate(zip(before.shards, after.shards)):
        if a is b:
            assert a.keys.data_ptr() == b.keys.data_ptr()
            kept.append(i)
    return kept


def test_dirty_shard_only_republish_on_mesh():
    """Delta merges re-upload ONLY the slots holding dirty partitions:
    clean slots keep the previous mirror's shard (object and tensor
    identity), also with writers hammering one partition while a reader
    scans; the readers' old mirror keeps its tensors."""
    P = 8
    store, scanner, head = _scanner_over_rows(4096, slots=P)
    try:
        scanner._merge_threshold = 1  # every publish merges the delta
        mirror1 = scanner._mirror
        old_last = mirror1.shards[-1].keys.clone()
        b = store.begin_batch_write()
        for i in range(16):  # above every key: the LAST partition
            b.put(coder.encode_object_key(b"/registry/pods/zzz-%03d" % i,
                                          head + 1 + i), b"w")
        b.commit()
        scanner.publish()
        mirror2 = scanner._mirror
        assert mirror2 is not mirror1
        assert _slots_kept(mirror1, mirror2) == list(range(P - 1))
        assert (mirror1.shards[-1].keys == old_last).all()

        stop = threading.Event()
        errors: list = []

        def writer():
            for i in range(120):
                if stop.is_set():
                    return
                bw = store.begin_batch_write()
                bw.put(coder.encode_object_key(
                    b"/registry/pods/zzz-live-%04d" % i, head + 100 + i), b"c")
                bw.commit()
                time.sleep(0.002)

        def reader():
            try:
                while not stop.is_set():
                    kvs, _ = scanner.range_(b"/registry/pods/p0000000",
                                            b"/registry/pods/p0000064", head)
                    assert len(kvs) == 64
            except Exception as e:  # surfaced to the main thread
                errors.append(e)

        threads = [threading.Thread(target=writer),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for _ in range(5):
            time.sleep(0.05)
            scanner.publish()
        stop.set()
        for t in threads:
            t.join(10.0)
        assert not errors, errors
        assert len(_slots_kept(mirror2, scanner._mirror)) >= P - 2
    finally:
        store.close()


def test_partitions_multiple_of_devices_enforced():
    with pytest.raises(ValueError, match="multiple of the mesh"):
        TorchScanner(new_storage("memkv"), get_compact_revision=lambda _s: 0,
                     mesh=make_mesh(4, device="cpu"), partitions=6)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        new_storage("cuda", inner="memkv", mesh=make_mesh(4, device="cpu"),
                     partitions=6)


class _Gauges:
    def __init__(self):
        self.fns = {}

    def register_gauge_fn(self, name, fn, **tags):
        self.fns[(name, tuple(sorted(tags.items())))] = fn

    def unregister_gauge_fn(self, name, **tags):
        self.fns.pop((name, tuple(sorted(tags.items()))), None)

    def sample(self, name):
        return {dict(t)["device"]: fn() for (n, t), fn in self.fns.items()
                if n == name and "device" in dict(t)}


def test_mirror_bytes_gauge_per_device():
    """``kb.mirror.bytes{device=}``: one scrape-time series per distinct
    device of the mesh, summing its slots. Eight slots named as eight CPU
    devices give eight series, each at most half the total; eight slots of
    the one CPU device give one series, the whole mirror."""
    store, scanner, _head = _scanner_over_rows(4096, slots=8)
    named = CudaKvStorage(new_storage("memkv"),
                          mesh=Mesh([f"cpu:{i}" for i in range(8)]))
    try:
        rows = [(b"/registry/pods/p%07d" % i, i + 1, b"v" * 16)
                for i in range(4096)]
        b = named.begin_batch_write()
        for k, r, v in rows:
            b.put(coder.encode_object_key(k, r), v)
        b.commit()
        sc = named.make_scanner(get_compact_revision=lambda _s: 0)
        sc.publish()
        whole = 0
        for sh in scanner._mirror.shards:
            for t in (sh.keys, sh.revs, sh.tomb, sh.ttl, sh.n_valid):
                whole += t.numel() * t.element_size()
        reg = _Gauges()
        scanner.register_metrics(reg)
        assert reg.sample("kb.mirror.bytes") == {"cpu": float(whole)}
        reg = _Gauges()
        sc.register_metrics(reg)
        values = reg.sample("kb.mirror.bytes")
        assert sorted(values) == [f"cpu:{i}" for i in range(8)]
        total = sum(values.values())
        assert total == whole
        assert all(0 < v <= total * 0.5 for v in values.values())
        raw = reg.sample("kb.mirror.raw.bytes")
        assert all(raw[d] >= values[d] for d in values)
        sc.close()
        scanner.close()
    finally:
        named.close()
        store.close()


def test_cli_mesh_flags_validate():
    """The flags' own checks at parse time; a partition count the mesh
    can't split is refused at boot, where the mesh is built (with no
    ``--mesh-part`` its size is the number of visible cards)."""
    from kubebrain_tpu_torch.cli import build_backend, build_parser, validate_args

    p = build_parser()
    validate_args(p.parse_args(["--mesh-part", "4", "--scan-partitions", "8"]))
    validate_args(p.parse_args(["--mesh-wat", "2", "--tpu-fanout"]))
    for bad in (["--storage", "memkv", "--mesh-part", "4"],  # needs cuda
                ["--mesh-part", "-1"],
                ["--mesh-wat", "2"],  # needs --tpu-fanout
                ["--mesh-wat", "-1", "--tpu-fanout"]):
        with pytest.raises(SystemExit):
            validate_args(p.parse_args(bad))
    with pytest.raises(SystemExit, match="multiple of the mesh"):
        build_backend(["--storage", "cuda", "--inner-storage", "memkv",
                       "--device", "cpu", "--mesh-part", "4",
                       "--scan-partitions", "6"])


def test_workload_spec_mesh_knobs_validate():
    from kubebrain_tpu_torch.workload.runner import WorkloadRunner
    from kubebrain_tpu_torch.workload.spec import WorkloadSpec

    spec = WorkloadSpec.for_smoke(4, storage="cuda", mesh_part=2,
                                  scan_partitions=4, tpu_fanout=True,
                                  mesh_wat=2)
    spec.validate()
    assert WorkloadRunner(spec, write_report=False)._mesh_args() == [
        "--mesh-part", "2", "--scan-partitions", "4", "--tpu-fanout",
        "--mesh-wat", "2"]
    with pytest.raises(ValueError, match="storage='cuda'"):
        WorkloadSpec.for_smoke(4, mesh_part=2).validate()
    with pytest.raises(ValueError, match=">= 0"):
        WorkloadSpec.for_smoke(4, storage="cuda", mesh_part=-1).validate()
    with pytest.raises(ValueError, match="multiple of mesh_part"):
        WorkloadSpec.for_smoke(4, storage="cuda", mesh_part=4,
                               scan_partitions=6).validate()


# ---------------------------------------------------------------- fan-out
def _jevents(events):
    return [JWatchEvent(revision=e.revision, key=e.key, value=e.value)
            for e in events]


def test_sharded_wat_table_byte_identical():
    """The wat-sharded table delivers the exact events of the unsharded
    table, of the oracle and of the JAX sharded table, in the same order;
    70 watchers is no multiple of 8: the capacity bucket absorbs it."""
    mesh = make_mesh(8, axes=("wat",), device="cpu")
    rng = np.random.RandomState(11)
    plain = DeviceFanout(device="cpu")
    sharded = DeviceFanout(mesh=mesh)
    jsharded = JDeviceFanout(mesh=j_make_mesh(axes=("wat",)))
    specs = _population(rng, 70)
    for round_ in range(3):
        events = _events(rng, 24, rev0=95 + 20 * round_)
        a = plain.deliver(events, specs, version=round_ + 1)
        b = sharded.deliver(events, specs, version=round_ + 1)
        assert a == b, round_
        assert list(a) == list(b)  # watcher order too
        j = jsharded.deliver(_jevents(events), specs, version=round_ + 1)
        assert {w: [(e.key, e.revision) for e in evs] for w, evs in b.items()} \
            == {w: [(e.key, e.revision) for e in evs] for w, evs in j.items()}
        assert (match_oracle(events, specs)
                == sharded(events, specs, version=round_ + 1)).all()
        specs = specs[10:] + _population(rng, 10, wid0=500 + 100 * round_)
    assert sharded.table.stats()["sharded"] is True
    assert sharded.table.stats()["devices"] == 8
    assert sharded.table.stats()["capacity"] % 8 == 0


def _by_watcher(slots, eidx, wids) -> dict:
    out: dict = {}
    for s, e in zip(slots.tolist(), eidx.tolist()):
        out.setdefault(int(wids[s]), []).append(e)
    return out


def test_sharded_table_pairs_keep_the_unsharded_order():
    """``_match`` on 2, 3 and 8 slots returns the one-slot table's pairs:
    watcher-major and ascending, element for element where the capacity
    bucket is the same (2 and 8 slots; 3 slots round 256 up to 258, which
    numbers the slots differently), each watcher's events in block order
    on every mesh; over a block longer than the int32 flat index allows in
    one piece too."""
    from kubebrain_tpu_torch.ops import fanout as fanout_ops

    rng = np.random.RandomState(5)
    specs = _population(rng, 200)
    events = _events(rng, 300)
    want = DeviceFanout(device="cpu")._match(events, specs, 1)
    for n in (2, 3, 8):
        got = DeviceFanout(mesh=make_mesh(n, axes=("wat",), device="cpu"))
        slots, eidx, wids = got._match(events, specs, 1)
        assert (np.diff(slots) >= 0).all()
        assert _by_watcher(slots, eidx, wids) == _by_watcher(*want)
        if n != 3:
            assert (slots == want[0]).all() and (eidx == want[1]).all()
            assert (wids == want[2]).all()
        orig = fanout_ops.MAX_FLAT
        fanout_ops.MAX_FLAT = 256 * 64  # pieces of 64 events at 256 slots
        try:
            pieced = got._match(events, specs, 2)
        finally:
            fanout_ops.MAX_FLAT = orig
        assert (pieced[0] == slots).all() and (pieced[1] == eidx).all()


def test_table_capacity_rounds_to_device_multiple():
    for n in (2, 3, 8):
        t = WatcherTable(mesh=make_mesh(n, axes=("wat",), device="cpu"))
        for w in (1, 65, 1025, 10_016):
            assert t._capacity_for(w) % n == 0
            assert t._capacity_for(w) >= w
        t.sync([(i, b"/registry/a%03d/" % i, b"/registry/a%03d0" % i, 0)
                for i in range(70)], version=1)
        shards, wids, _v = t.shard_views()
        assert [lo for lo, *_c in shards] == [i * len(wids) // n
                                               for i in range(n)]


def test_matcher_with_sharded_watcher_table():
    """The legacy matcher over a sharded table gives the unsharded mask,
    the JAX sharded matcher's and the oracle's; its W bucket is a slot
    multiple."""
    specs = [(i, b"/registry/ns%02d/" % (i % 16),
              coder.prefix_end(b"/registry/ns%02d/" % (i % 16)), 0)
             for i in range(70)]
    events = [WatchEvent(revision=i + 1, key=b"/registry/ns%02d/pod" % (i % 16))
              for i in range(32)]
    plain = FanoutMatcher(device="cpu")
    for n in (3, 8):
        sharded = FanoutMatcher(mesh=make_mesh(n, axes=("wat",), device="cpu"))
        m1 = plain(events, specs)
        m2 = sharded(events, specs)
        assert (m1 == m2).all() and m2.sum() > 0
        assert (m2 == match_oracle(events, specs)).all()
        assert sum(c[0].shape[0] for c, _i in sharded._shards) % n == 0
    jm = JFanoutMatcher(mesh=j_make_mesh())
    assert (np.asarray(jm(_jevents(events), specs)) == m2).all()


def test_backend_watches_through_a_sharded_table():
    """A Backend whose hub holds a wat-sharded ``DeviceFanout`` delivers
    every watcher exactly the events of one with an unsharded table, in
    order; the hub's index is made dense with broad watchers so that the
    blocks reach the matcher."""
    got = {}
    for name, mesh in (("plain", None),
                       ("sharded", make_mesh(4, axes=("wat",), device="cpu"))):
        matcher = DeviceFanout(device="cpu", mesh=mesh)
        store = new_storage("memkv")
        b = Backend(store, BackendConfig(event_ring_capacity=8192,
                                         fanout_matcher=matcher))
        try:
            queues = [b.watch(b"/registry/")[1] for _ in range(70)]
            queues += [b.watch_range(b"/registry/pods/ns%02d/" % i,
                                     b"/registry/pods/ns%02d0" % i)[1]
                       for i in range(70)]
            for i in range(300):
                b.create(b"/registry/pods/ns%02d/p%04d" % (i % 70, i), b"v")
            seen = []
            for q in queues:
                evs = []
                deadline = time.monotonic() + 10
                want = 300 if len(seen) < 70 else 300 // 70 + (
                    1 if (len(seen) - 70) < 300 % 70 else 0)
                while len(evs) < want and time.monotonic() < deadline:
                    try:
                        evs += [(e.key, e.revision) for e in q.get(timeout=1)]
                    except Exception:
                        pass
                seen.append(evs)
            assert matcher.stats["blocks"] > 0
            got[name] = seen
        finally:
            b.close()
            store.close()
    assert got["plain"] == got["sharded"]
    assert all(len(s) > 0 for s in got["sharded"])


# ------------------------------------------------------------------ entry
@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_serves_and_emits_metric(n, capsys):
    """J6 on a (part, wat) mesh, then the served phase at mesh sizes {1,
    n}: byte-identical answers, the ``multichip_rows_per_sec`` tail."""
    entry.dryrun_multichip(n, device="cpu")
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "multichip_rows_per_sec"
    assert rec["value"] > 0
    assert rec["platform"]["platform"] == "cpu"
    assert rec["detail"]["mesh_sizes"] == [1, n]
    assert rec["detail"]["byte_identical"] is True
    assert rec["detail"]["served_through_scheduler"] is True
    assert str(n) in rec["detail"]["rows_per_sec"]
