"""The port's ``cuda`` engine on the CPU (``device="cpu"``) against the JAX
package's ``tpu`` engine and its ``memkv`` engine, fed the same seeded
operation sequence: Range, Count, ``list_batch`` and ``range_stream`` must
be byte-identical at head and at snapshot revisions, with a live delta
overlay, after threshold merges, with key encoding on and off."""

import random
import time

import numpy as np
import pytest
import torch

from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu.storage.tpu import blocks as jblocks
from kubebrain_tpu.storage.tpu.engine import _DeltaIndex as JDelta
from kubebrain_tpu_torch.backend import Backend as TBackend
from kubebrain_tpu_torch.backend import BackendConfig as TConfig
from kubebrain_tpu_torch.device import TRANSFER_METER
from kubebrain_tpu_torch.storage import new_storage as t_new_storage
from kubebrain_tpu_torch.storage.cuda import blocks as tblocks
from kubebrain_tpu_torch.storage.cuda.engine import (
    TorchScanner,
    _DeltaIndex,
    _part_indices_of_mask,
)

QUERIES = [
    (b"/registry/", b"/registry0"),
    (b"/registry/pods/", b"/registry/pods0"),
    (b"/registry/pods/ns1/", b"/registry/pods/ns10"),
    (b"/registry/events/ns2/obj-010", b"/registry/events/ns3/"),
    (b"/registry/pods/ns0/obj-007\x00", b"/registry/pods0"),  # continuation
    (b"", b""),
    (b"/registry/svc/ns9/", b"/registry/svc/ns90"),  # empty
]


class Trio:
    """The port's backend and the two JAX reference backends, driven in
    lock step."""

    def __init__(self, encode: bool, merge_threshold: int, partitions: int = 0):
        self.port_store = t_new_storage(
            "cuda", inner="memkv", device="cpu", encode_keys=encode,
            merge_threshold=merge_threshold, partitions=partitions)
        self.tpu_store = j_new_storage(
            "tpu", inner="memkv", encode_keys=encode,
            merge_threshold=merge_threshold)
        self.mem_store = j_new_storage("memkv")
        self.port = TBackend(self.port_store, TConfig(event_ring_capacity=8192))
        self.tpu = JBackend(self.tpu_store, JConfig(event_ring_capacity=8192))
        self.mem = JBackend(self.mem_store, JConfig(event_ring_capacity=8192))
        for b in (self.port, self.tpu):
            b.scanner._host_limit_threshold = 0  # always the device path
        self.live: dict[bytes, int] = {}
        self.checkpoints: list[int] = []

    def all(self):
        return (self.port, self.tpu, self.mem)

    def drive(self, rng: random.Random, n_ops: int) -> None:
        for step in range(n_ops):
            k = b"/registry/%s/ns%d/obj-%03d" % (
                rng.choice([b"pods", b"events", b"svc"]), rng.randrange(3),
                rng.randrange(25))
            op = rng.random()
            val = b"v%d-" % step + bytes(rng.randrange(1, 40))
            results = []
            for b in self.all():
                try:
                    if k not in self.live or op < 0.1:
                        r = b.create(k, val)
                    elif op < 0.7:
                        r = b.update(k, val, self.live[k])
                    else:
                        r = b.delete(k, self.live[k])[0]
                    results.append(r)
                except Exception as e:
                    results.append(type(e).__name__)
            assert results[0] == results[1] == results[2], results
            r = results[0]
            if isinstance(r, int):
                if k in self.live and op >= 0.7:
                    self.live.pop(k)
                else:
                    self.live[k] = r
            if step % 25 == 24:
                self.checkpoints.append(self.mem.current_revision())

    def assert_reads_agree(self) -> None:
        head = self.mem.current_revision()
        assert self.port.current_revision() == head
        for rev in [0] + self.checkpoints[-3:]:
            for s, e in QUERIES:
                ranges = [rows(b.list_(s, e, revision=rev).kvs) for b in self.all()]
                assert ranges[0] == ranges[1] == ranges[2], (s, e, rev)
                counts = [b.count(s, e, revision=rev)[0] for b in self.all()]
                assert counts[0] == counts[1] == counts[2] == len(ranges[0])
            streams = [
                [kv for chunk in b.list_by_stream(b"/registry/", b"", rev)[1]
                 for kv in rows(chunk)] for b in self.all()]
            assert streams[0] == streams[1] == streams[2]
        batch = []
        for i, (s, e) in enumerate(QUERIES):
            rev = ([0] + self.checkpoints)[i % (1 + len(self.checkpoints))]
            batch.append(("count", s, e, rev) if i % 3 == 2
                         else ("list", s, e, rev, 0))
        outs = [[norm(r) for r in b.list_batch(batch)] for b in self.all()]
        assert outs[0] == outs[1] == outs[2]

    def close(self) -> None:
        for b in self.all():
            b.close()
        for s in (self.port_store, self.tpu_store, self.mem_store):
            s.close()


def rows(kvs):
    return [(kv.key, kv.value, kv.revision) for kv in kvs]


def norm(r):
    if isinstance(r, BaseException):
        return type(r).__name__
    if isinstance(r, tuple):
        return r
    return (rows(r.kvs), r.revision, r.more, r.count)


@pytest.mark.parametrize("encode", [True, False])
def test_live_delta_overlay_matches_reference(encode):
    trio = Trio(encode, merge_threshold=100_000)
    try:
        rng = random.Random(3)
        trio.drive(rng, 120)
        trio.assert_reads_agree()            # publishes the mirror
        assert trio.port.scanner.full_rebuild_total == 1
        trio.drive(rng, 80)                  # rows land in the delta only
        assert len(trio.port.scanner._delta) > 0
        trio.assert_reads_agree()
        assert trio.port.scanner.full_rebuild_total == 1
    finally:
        trio.close()


@pytest.mark.parametrize("encode,partitions", [(True, 0), (False, 3)])
def test_threshold_rebuild_matches_reference(encode, partitions):
    """A delta past the threshold merges into the mirror in the stored
    domain (write-kicked or on the next read), with no rebuild from the
    store, and every read still matches the references."""
    trio = Trio(encode, merge_threshold=8, partitions=partitions)
    try:
        rng = random.Random(5)
        trio.drive(rng, 60)
        trio.assert_reads_agree()
        before = trio.port.scanner.full_rebuild_total
        trio.drive(rng, 40)                  # well past the threshold
        trio.assert_reads_agree()
        sc = trio.port.scanner
        sc.publish()
        assert sc.merge_count > 0 and sc.merge_rows_total > 0
        assert not sc._force_rebuild
        assert sc.full_rebuild_total == before
        assert sc._mirror.partitions == (partitions or 1)
        trio.assert_reads_agree()
    finally:
        trio.close()


def test_uncertain_commit_forces_rebuild():
    """An uncertain commit quarantines the mirror: reads go to the host
    store at once, and a background rebuild from the store brings the
    mirror back to serving."""
    store = t_new_storage("cuda", inner="memkv", device="cpu")
    b = TBackend(store, TConfig(event_ring_capacity=1024))
    try:
        b.scanner._host_limit_threshold = 0
        r = b.create(b"/registry/a", b"1")
        assert rows(b.list_(b"/registry/", b"").kvs) == [(b"/registry/a", b"1", r)]
        store._on_uncertain()
        assert b.scanner._mirror_state != "serving" or b.scanner.rebuild_bg_count
        assert [kv.key for kv in b.list_(b"/registry/", b"").kvs] == [b"/registry/a"]
        deadline = time.time() + 10
        while time.time() < deadline and (b.scanner._mirror_state != "serving"
                                          or not b.scanner.rebuild_bg_count):
            time.sleep(0.01)
        assert b.scanner._mirror_state == "serving"
        assert b.scanner.rebuild_bg_count == 1
        assert b.scanner.full_rebuild_total == 1  # the first publish only
        assert [kv.key for kv in b.list_(b"/registry/", b"").kvs] == [b"/registry/a"]
    finally:
        b.close()
        store.close()


def test_host_transfer_scales_with_visible_rows():
    store = t_new_storage("cuda", inner="memkv", device="cpu")
    b = TBackend(store, TConfig(event_ring_capacity=4096))
    try:
        b.scanner._host_limit_threshold = 0
        for i in range(600):
            b.create(b"/registry/pods/p%04d" % i, b"x")
        b.scanner.publish()
        b.list_(b"/registry/pods/p0000", b"/registry/pods/p0002")  # warm
        before = TRANSFER_METER.snapshot()[0]
        kvs = b.list_(b"/registry/pods/p0000", b"/registry/pods/p0002").kvs
        moved = TRANSFER_METER.snapshot()[0] - before
        assert len(kvs) == 2
        # counts (4·P bytes) + a [P, 2] int32 index block — not the mask
        assert moved <= 64, moved
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("encode", [True, False])
def test_mirror_from_reference_scans_identically(encode):
    j_store = j_new_storage("tpu", inner="memkv", encode_keys=encode)
    jb = JBackend(j_store, JConfig(event_ring_capacity=4096))
    mem = t_new_storage("memkv")
    try:
        rng = random.Random(9)
        for i in range(150):
            k = b"/registry/pods/ns%d/pod-%03d" % (rng.randrange(4), rng.randrange(60))
            try:
                rev = jb.create(k, b"a%d" % i)
                if rng.random() < 0.5:
                    jb.update(k, b"b%d" % i, rev)
                if rng.random() < 0.2:
                    jb.delete(k)
            except Exception:
                pass
        jb.scanner.publish()
        jm = jb.scanner._mirror
        enc = jm.encoding
        arrays = dict(
            keys_host=jm.keys_host, lens_host=jm.lens_host, revs_host=jm.revs_host,
            tomb_host=jm.tomb_host, n_valid=jm.n_valid, val_arena=jm.val_arena,
            val_offsets=jm.val_offsets, snapshot_ts=jm.snapshot_ts,
            max_rev=jm.max_rev, key_width=jm.key_width, ttl_host=jm.ttl_host,
            encoding=None if enc is None else dict(
                boundaries=enc.boundaries, strips=enc.strips,
                suffix_width=enc.suffix_width, raw_width=enc.raw_width))
        tm = tblocks.mirror_from_reference(arrays, torch.device("cpu"))
        assert (tm.encoding is None) == (not encode)
        ts = TorchScanner(mem, get_compact_revision=lambda _s: 0, device="cpu")
        head = jb.current_revision()
        n_rows = jm.keys_host.shape[1]
        for s, e in QUERIES:
            for rev in (head, head // 2):
                j_mask, j_counts = jb.scanner._dev_mask(jm, s, e, rev)
                t_mask, t_counts = ts._dev_mask(tm, s, e, rev)
                assert (t_mask[0].numpy() == np.asarray(j_mask)).all()
                assert (t_counts[0].numpy() == np.asarray(j_counts)).all()
                _, j_idx = jb.scanner._dev_visible_indices(j_mask, j_counts, n_rows)
                _, t_idx = ts._dev_visible_indices(t_mask, t_counts, n_rows)
                assert (t_idx == j_idx).all()
                assert rows(ts._materialize_visible(tm, t_idx, {})) == rows(
                    jb.scanner._materialize_visible(jm, j_idx, {}))
        ts.close()
    finally:
        jb.close()
        j_store.close()
        mem.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_index_compaction_matches_nonzero(seed):
    rng = np.random.RandomState(seed)
    mask = rng.rand(3, 4, 700) < 0.05
    counts = mask.sum(axis=-1)
    size = 1
    while size < counts.max():
        size *= 2
    got = _part_indices_of_mask(torch.from_numpy(mask), size).numpy()
    for q in range(3):
        for p in range(4):
            nz = np.nonzero(mask[q, p])[0]
            want = np.full(size, 700)
            want[: len(nz)] = nz
            assert (got[q, p] == want).all()
    # a block narrower than the count keeps the first ``size`` rows
    small = _part_indices_of_mask(torch.from_numpy(mask), 2).numpy()
    assert (small == got[..., :2]).all()


def test_delta_overlay_matches_reference():
    rng = random.Random(4)
    batches = []
    rev = 100
    for _ in range(30):
        batch = []
        for _ in range(rng.randrange(1, 5)):
            rev += 1
            k = b"/registry/k%02d" % rng.randrange(20)
            batch.append((k, rev, b"" if rng.random() < 0.2 else b"v%d" % rev))
        batches.append(batch)
    jd, td = JDelta(), _DeltaIndex()
    for batch in batches:
        jd.extend(batch)
        td.extend(batch)
    assert len(jd) == len(td) and jd.rows() == td.rows()
    for s, e in [(b"", b""), (b"/registry/k05", b"/registry/k12")]:
        for read_rev in (100, 120, rev):
            assert jd.overlay(s, e, read_rev) == td.overlay(s, e, read_rev)


@pytest.mark.parametrize("encode,n_parts", [(False, 1), (True, 3)])
def test_build_mirror_host_arrays_match_reference(encode, n_parts):
    rng = random.Random(2)
    rows_ = []
    rev = 0
    for i in range(300):
        rev += 1
        k = b"/%s/ns%d/o-%03d" % (rng.choice([b"registry/pods", b"events"]),
                                  rng.randrange(3), rng.randrange(80))
        rows_.append((k, rev, b"" if rng.random() < 0.1 else b"v" * rng.randrange(5)))
    j_raw = jblocks.rows_to_arrays(rows_, 128)
    t_raw = tblocks.rows_to_arrays(rows_, 128)
    assert all((a == b).all() for a, b in zip(j_raw, t_raw))
    empty = tblocks.rows_to_arrays([], 128)
    j_sorted = jblocks.merge_sorted_arrays(jblocks.rows_to_arrays([], 128), j_raw)
    t_sorted = tblocks.merge_sorted_arrays(empty, t_raw)
    assert all((a == b).all() for a, b in zip(j_sorted, t_sorted))
    assert (jblocks.compute_ttl_flags(j_sorted[0], j_sorted[1])
            == tblocks.compute_ttl_flags(t_sorted[0], t_sorted[1])).all()
    jm = jblocks.build_mirror_from_arrays(*j_sorted, None, 128, 7,
                                          n_parts=n_parts, encode=encode)
    tm = tblocks.build_mirror_from_arrays(*t_sorted, "cpu", 128, 7,
                                          n_parts=n_parts, encode=encode)
    for f in ("keys_host", "lens_host", "revs_host", "tomb_host", "n_valid",
              "ttl_host"):
        assert (getattr(jm, f) == getattr(tm, f)).all(), f
    for a, b in zip(jm.val_arena + jm.val_offsets, tm.val_arena + tm.val_offsets):
        assert (a == b).all()
    (sh,) = tm.shards
    assert sh.keys.shape == (n_parts, tm.keys_host.shape[2], tm.keys_host.shape[1])
    assert sh.revs.dtype == torch.int64 and sh.tomb.dtype == torch.int8
