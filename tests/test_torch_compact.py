"""The port's compaction on the CPU (``device="cpu"``) against the JAX
package.

- The plain PyTorch victim mask (``ops/compact.py``, reached through the K3
  wrapper on CPU tensors) against the jnp ``victim_mask`` with the engine's
  range restriction (chains of at most 64 rows, the jnp cap) and against
  the Pallas kernel ``victim_mask_pallas`` in interpret mode (any chain
  length). Masks are booleans, so every comparison is exact.
- ``Backend.compact`` on the port's ``cuda`` engine against the JAX ``tpu``
  engine and the JAX ``memkv`` engine, driven in lock step: store dumps,
  ``version_count()``, the ``CompactStats`` victim fields and every read at
  head and at snapshots above the compact floor must agree.
- The port's counterparts of ``tests/test_compact_device.py``.
"""

import random
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubebrain_tpu.backend import Backend as JBackend
from kubebrain_tpu.backend import BackendConfig as JConfig
from kubebrain_tpu.ops import compact_pallas as cp
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.ops import scan_pallas as sp
from kubebrain_tpu.ops.compact import victim_mask as j_victim_mask
from kubebrain_tpu.ops.scan import lex_geq, lex_less
from kubebrain_tpu.storage import new_storage as j_new_storage
from kubebrain_tpu_torch import coder
from kubebrain_tpu_torch.backend import Backend as TBackend
from kubebrain_tpu_torch.backend import BackendConfig as TConfig
from kubebrain_tpu_torch.backend import scanner as scanner_mod
from kubebrain_tpu_torch.backend import wait_for_revision
from kubebrain_tpu_torch.backend.scanner import Scanner
from kubebrain_tpu_torch.ops import compact_kernels
from kubebrain_tpu_torch.ops import scan as tscan
from kubebrain_tpu_torch.storage import new_storage as t_new_storage
from kubebrain_tpu_torch.storage.cuda import blocks as tblocks
from kubebrain_tpu_torch.storage.cuda import engine as teng
from kubebrain_tpu_torch.storage.cuda.encode import build_encoding
from kubebrain_tpu_torch.storage.memkv import MemKv

WIDTH = 128
TILE = sp.LANE_TILE


# ------------------------------------------------------------ kernel level
def corpus(seed, n_keys=250, revs_max=6, ttl_frac=0.3):
    """Sorted version rows under /events/ (TTL keys) and /reg/: chains of
    1..revs_max-1 rows, 20% tombstones, revision gaps of 1-2."""
    rng = np.random.RandomState(seed)
    named = sorted(
        {(b"/events/" if rng.rand() < ttl_frac else b"/reg/")
         + bytes(rng.randint(97, 123, rng.randint(2, 18), dtype=np.uint8))
         for _ in range(n_keys)})
    rows, rev = [], 0
    for k in named:
        for _ in range(rng.randint(1, revs_max)):
            rev += int(rng.randint(1, 3))
            rows.append((k, rev, rng.rand() < 0.2))
    return rows_arrays([r[0] for r in rows], [r[1] for r in rows],
                       [r[2] for r in rows])


def rows_arrays(keys, revs, tomb):
    u8 = np.zeros((len(keys), WIDTH), np.uint8)
    lens = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        u8[i, : len(k)] = np.frombuffer(k, np.uint8)
        lens[i] = len(k)
    ttl = tblocks.compute_ttl_flags(u8, lens)
    return u8, lens, np.asarray(revs, np.uint64), np.asarray(tomb, bool), ttl


def stored_domain(u8, lens, encoded):
    """(stored key chunks uint32[N, C], port KeyEncoding or None)."""
    if not encoded:
        return jkeys.bytes_to_chunks(u8), None
    enc = build_encoding(u8, lens, raw_width=WIDTH)
    return jkeys.bytes_to_chunks(enc.encode_keys(u8, lens)[0]), enc


def jnp_victims(chunks, revs, tomb, ttl, crev, tcut, s_row, e_row, unb):
    """The JAX engine's ``_victim_batch`` for one partition: jnp
    ``victim_mask`` ANDed with the range restriction."""
    hi, lo = jkeys.split_revs(revs)
    chi, clo = jkeys.split_revs(np.array([crev], np.uint64))
    thi, tlo = jkeys.split_revs(np.array([tcut], np.uint64))
    mask = np.asarray(j_victim_mask(
        jnp.asarray(chunks), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(tomb), jnp.asarray(ttl), jnp.asarray(np.int32(len(chunks))),
        jnp.asarray(chi[0]), jnp.asarray(clo[0]), jnp.asarray(thi[0]),
        jnp.asarray(tlo[0]), with_ttl=tcut > 0))
    keys = jnp.asarray(chunks)
    rng = np.asarray(lex_geq(keys, jnp.asarray(s_row))
                     & (jnp.asarray(unb) | lex_less(keys, jnp.asarray(e_row))))
    return mask & rng


def pallas_victims(chunks, revs, tomb, ttl, crev, tcut, s_row, e_row, unb):
    """``victim_mask_pallas`` in interpret mode over one partition."""
    keys_t, rh31, rl31, tomb8, n = sp.prepare_blocks(chunks, revs, tomb)
    ttl8 = np.zeros(keys_t.shape[1], np.int8)
    ttl8[:n] = ttl.astype(np.int8)
    chi, clo = sp.split_revs31(np.array([crev], np.uint64))
    thi, tlo = sp.split_revs31(np.array([tcut], np.uint64))
    return np.asarray(cp.victim_mask_pallas(
        jnp.asarray(keys_t), jnp.asarray(rh31), jnp.asarray(rl31),
        jnp.asarray(tomb8), jnp.asarray(ttl8), np.int32(n),
        jnp.asarray(sp.pack_bound_flipped(s_row)),
        jnp.asarray(sp.pack_bound_flipped(e_row)), np.int32(unb),
        np.int32(chi[0]), np.int32(clo[0]), np.int32(thi[0]), np.int32(tlo[0]),
        with_ttl=tcut > 0, interpret=True))[:n]


def port_victims(chunks, revs, tomb, ttl, crev, tcut, s_row, e_row, unb,
                 parts=1):
    """The K3 wrapper on CPU tensors over ``parts`` key-aligned partitions
    padded to a common capacity; returns the valid rows in order."""
    n, c = chunks.shape
    cuts = [0]
    for p in range(1, parts):
        pos = p * n // parts
        while 0 < pos < n and (chunks[pos] == chunks[pos - 1]).all():
            pos += 1
        cuts.append(max(pos, cuts[-1]))
    cuts.append(n)
    cap = max(np.diff(cuts)) + 37
    k = np.zeros((parts, cap, c), np.uint32)
    r = np.zeros((parts, cap), np.uint64)
    t = np.zeros((parts, cap), bool)
    x = np.zeros((parts, cap), np.int8)
    nv = np.zeros(parts, np.int32)
    for p in range(parts):
        lo, hi = cuts[p], cuts[p + 1]
        k[p, : hi - lo], r[p, : hi - lo] = chunks[lo:hi], revs[lo:hi]
        t[p, : hi - lo], x[p, : hi - lo] = tomb[lo:hi], ttl[lo:hi]
        nv[p] = hi - lo
    kt, rv, t8 = tscan.prepare_layout(k, r, t)
    mask, counts = compact_kernels.victim_mask_batch(
        torch.from_numpy(kt), torch.from_numpy(rv), torch.from_numpy(t8),
        torch.from_numpy(x), torch.from_numpy(nv),
        torch.from_numpy(tscan.flip_sign(s_row)),
        torch.from_numpy(tscan.flip_sign(e_row)), unb, crev, tcut)
    mask = mask.numpy()
    assert not mask[np.arange(cap)[None, :] >= nv[:, None]].any()
    assert counts.dtype == torch.int32
    assert (counts.numpy() == mask.sum(axis=1)).all()
    return np.concatenate([mask[p, : nv[p]] for p in range(parts)])


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("bounds", [(b"", b""), (b"/events/m", b"/reg/q")])
@pytest.mark.parametrize("with_ttl", [False, True])
@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("compact_at", [0.75, 0.25])
def test_plain_victims_match_jnp_and_pallas(compact_at, seed, with_ttl, bounds,
                                            encoded):
    """With the compact revision below the TTL cutoff (0.25), rows of an
    expired group that are not superseded expire by the group's verdict
    alone."""
    u8, lens, revs, tomb, ttl = corpus(seed)
    chunks, enc = stored_domain(u8, lens, encoded)
    s_row, e_row, unb = teng.bound_rows(enc, WIDTH, *bounds)
    top = int(revs.max())
    args = (chunks, revs, tomb, ttl, int(top * compact_at),
            top // 2 if with_ttl else 0, s_row, e_row, unb)
    want = jnp_victims(*args)
    assert want.any()
    got = port_victims(*args, parts=1 if seed == 0 else 3)
    assert (got == want).all(), np.nonzero(got != want)[0][:10]
    assert (got == pallas_victims(*args)).all()
    assert compact_kernels.victim_mask_batch.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("expire", [True, False])
def test_ttl_chain_longer_than_1000_rows(expire, encoded):
    """A TTL chain of 4096 rows (past the jnp cap of 64, across two of the
    kernel's 2,048-row tiles) expires whole when its last revision is at or
    below the cutoff, and no row of it expires when the last revision is
    past the cutoff; the Pallas kernel agrees row for row."""
    half = TILE
    keys = [b"/events/a%07d" % i for i in range(half)] + [
        b"/events/huge-chain"] * half
    u8, lens, revs, tomb, ttl = rows_arrays(
        keys, np.arange(1, 2 * half + 1), np.zeros(2 * half, bool))
    assert ttl.all()
    chunks, enc = stored_domain(u8, lens, encoded)
    s_row, e_row, unb = teng.bound_rows(enc, WIDTH, b"", b"")
    cutoff = 2 * half if expire else half + half // 2
    args = (chunks, revs, tomb, ttl, 0, cutoff, s_row, e_row, unb)
    got = port_victims(*args)
    assert (got == pallas_victims(*args)).all()
    assert got[:half].all()                      # the singletons expire
    assert got[half:].all() if expire else not got[half:].any()


def test_wrapper_checks_its_inputs():
    kt = torch.zeros((1, 2, 8), dtype=torch.int32)
    good = dict(revs=torch.zeros((1, 8), dtype=torch.int64),
                tomb=torch.zeros((1, 8), dtype=torch.int8),
                ttl=torch.zeros((1, 8), dtype=torch.int8),
                n_valid=torch.zeros(1, dtype=torch.int32),
                start=torch.zeros(2, dtype=torch.int32),
                end=torch.zeros(2, dtype=torch.int32))
    assert compact_kernels._check_layout(kt, *good.values()) == (1, 2, 8)
    for name in good:
        bad = dict(good)
        bad[name] = good[name].to(torch.float32)
        with pytest.raises(ValueError, match="victim kernel wants"):
            compact_kernels._check_layout(kt, *bad.values())
    meta = {k: v.to("meta") for k, v in good.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        compact_kernels.victim_mask_batch(kt.to("meta"), *meta.values(),
                                          True, 1, 0)
    assert compact_kernels.victim_mask_batch.launches == 0


# ------------------------------------------------------------ engine level
def rows(kvs):
    return [(kv.key, kv.value, kv.revision) for kv in kvs]


def dump(store):
    lo, hi = coder.internal_range(b"", b"")
    return list(store.iter(lo, hi))


def victim_fields(st):
    return (st.deleted_versions, st.deleted_tombstones,
            st.deleted_rev_records, st.expired_ttl)


def compact_with_stats(backend, rev):
    """``Backend.compact`` with the scanner's summed CompactStats victim
    fields captured (the Backend drops them)."""
    seen = []
    orig = backend.scanner.compact

    def spy(start, end, r):
        seen.append(orig(start, end, r))
        return seen[-1]

    backend.scanner.compact = spy
    try:
        done = backend.compact(rev)
    finally:
        del backend.scanner.compact
    return done, tuple(map(sum, zip(*(victim_fields(s) for s in seen)))), seen


class Trio:
    """The port's cuda engine, the JAX tpu engine and the JAX memkv engine,
    driven in lock step, with compaction interleaved."""

    def __init__(self, encode: bool, partitions: int, ttl: bool):
        kw = {} if not ttl else {"ttl_supported": False}
        self.port_store = t_new_storage(
            "cuda", inner="memkv", device="cpu", encode_keys=encode,
            partitions=partitions, merge_threshold=48, **kw)
        self.tpu_store = j_new_storage("tpu", inner="memkv", encode_keys=encode,
                                       merge_threshold=48, **kw)
        self.mem_store = j_new_storage("memkv", **kw)
        cfg = dict(event_ring_capacity=8192)
        self.port = TBackend(self.port_store, TConfig(**cfg))
        self.tpu = JBackend(self.tpu_store, JConfig(**cfg))
        self.mem = JBackend(self.mem_store, JConfig(**cfg))
        for b in (self.port, self.tpu):
            b.scanner._host_limit_threshold = 0
        self.live: dict[bytes, int] = {}
        self.floor = 0
        self.checkpoints: list[int] = []

    def all(self):
        return (self.port, self.tpu, self.mem)

    def inners(self):
        return (self.port_store._inner, self.tpu_store._inner, self.mem_store)

    def drive(self, rng: random.Random, n_ops: int) -> None:
        for step in range(n_ops):
            k = b"/%s/ns%d/obj-%03d" % (
                rng.choice([b"registry/pods", b"events", b"registry/svc"]),
                rng.randrange(3), rng.randrange(25))
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
            if step % 20 == 19:
                self.checkpoints.append(self.mem.current_revision())

    def age_history(self, rev: int) -> None:
        """The same CompactHistory entry on every side, old enough that
        /events/ rows at or below ``rev`` expire by TTL."""
        old = time.time() - 2 * scanner_mod.EVENTS_TTL_SECONDS
        for b in self.all():
            b.scanner.compact_history.log(rev, now=old)

    def compact(self, rev: int):
        outs = [compact_with_stats(b, rev) for b in self.all()]
        assert outs[0][0] == outs[1][0] == outs[2][0]
        assert outs[0][1] == outs[1][1], [o[1] for o in outs]
        # the JAX engines disagree on one class: the device path counts a
        # superseded tombstone as a tombstone, the host scanner as a version
        merged = [(v + t, r, x) for v, t, r, x in (o[1] for o in outs)]
        assert merged[0] == merged[2], [o[1] for o in outs]
        self.floor = outs[0][0]
        return outs

    def assert_agree(self) -> None:
        dumps = [dump(s) for s in self.inners()]
        assert dumps[0] == dumps[1] == dumps[2]
        counts = [s.version_count() for s in self.inners()]
        assert counts[0] == counts[1] == counts[2], counts
        queries = [(b"/registry/", b"/registry0"), (b"/events/", b"/events0"),
                   (b"/registry/pods/ns1/", b"/registry/pods/ns10"), (b"", b"")]
        revs = [0] + [c for c in self.checkpoints[-3:] if c >= self.floor]
        for rev in revs:
            for s, e in queries:
                got = [rows(b.list_(s, e, revision=rev).kvs) for b in self.all()]
                assert got[0] == got[1] == got[2], (s, e, rev)
                cnt = [b.count(s, e, revision=rev)[0] for b in self.all()]
                assert cnt[0] == cnt[1] == cnt[2] == len(got[0])
        batch = [("list", s, e, revs[-1], 0) for s, e in queries] + [
            ("count", b"/registry/", b"/registry0", 0)]
        outs = [[r if isinstance(r, tuple) else (rows(r.kvs), r.revision)
                 for r in b.list_batch(batch)] for b in self.all()]
        assert outs[0] == outs[1] == outs[2]

    def close(self) -> None:
        for b in self.all():
            b.close()
        for s in (self.port_store, self.tpu_store, self.mem_store):
            s.close()


@pytest.mark.parametrize("encode,partitions", [(True, 0), (True, 3),
                                                (False, 0), (False, 3)])
def test_compact_interleaved_matches_reference(encode, partitions):
    """Compaction interleaved with writes, TTL expiry by the compact history
    included: the port, the JAX tpu engine and the JAX memkv engine leave
    the same store and answer every read alike; the port's steady path
    never rebuilds from the store."""
    trio = Trio(encode, partitions, ttl=True)
    try:
        rng = random.Random(7 + partitions)
        trio.drive(rng, 100)
        trio.assert_agree()
        rebuilds = trio.port.scanner.full_rebuild_total
        trio.age_history(trio.checkpoints[1])
        outs = trio.compact(trio.checkpoints[-1])
        assert outs[0][1][3] > 0, "no /events/ row expired"
        assert {s.mirror_path for s in outs[0][2]} == {"stored_incremental"}
        trio.assert_agree()
        trio.drive(rng, 80)                  # merges and a pending delta
        trio.compact(trio.mem.current_revision() - 5)
        trio.assert_agree()
        trio.drive(rng, 30)
        trio.compact(trio.mem.current_revision())
        trio.assert_agree()
        sc = trio.port.scanner
        assert sc.full_rebuild_total == rebuilds
        assert sc.compact_count == 3 and sc.compact_errors == 0
        assert sc._mirror.partitions == (partitions or 1)
    finally:
        trio.close()


@pytest.mark.parametrize("encode", [True, False])
def test_compact_prunes_history_like_the_reference(encode):
    """The same seeded operations and one ``compact``: the port's inner
    memkv keeps exactly the JAX tpu engine's versions (its GC deletes go
    through the untracked inner engine, whose ``prune_versions`` frees the
    history), the store dumps are equal and so are the victim fields."""
    trio = Trio(encode, 0, ttl=False)
    try:
        trio.drive(random.Random(21), 150)
        trio.port.list_(b"/registry/", b"")   # a published mirror
        head = trio.mem.current_revision()
        before = [s.version_count() for s in trio.inners()]
        assert before[0] == before[1] == before[2]
        outs = trio.compact(head)
        assert sum(outs[0][1]) > 0
        after = [s.version_count() for s in trio.inners()]
        assert after[0] == after[1] == after[2] < before[0]
        assert trio.port.scanner._mirror_state == "serving"
        assert trio.port.scanner.full_rebuild_total == 1
        trio.assert_agree()
    finally:
        trio.close()


# ------------------------------------------------- device-path counterparts
@pytest.fixture
def tb():
    store = t_new_storage("cuda", inner="memkv", device="cpu")
    b = TBackend(store, TConfig(event_ring_capacity=8192,
                                watch_cache_capacity=4096))
    b.scanner._host_limit_threshold = 0
    b.scanner._merge_threshold = 64
    yield b
    b.close()
    store.close()


def churn(b, n_keys=120, prefix=b"/registry/pods/"):
    """Superseded chains, tombstoned keys and clean singletons; returns the
    live key → revision map and the last revision."""
    live, last = {}, 0
    for i in range(n_keys):
        k = prefix + b"p%04d" % i
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
    assert wait_for_revision(b, last)
    return live, last


def borders():
    return coder.internal_range(b"", b"")


def listed(b):
    return {kv.key: kv.revision for kv in b.list_(b"/registry/", b"/registry0").kvs}


def test_compact_steady_path_stays_stored_domain(tb):
    live, last = churn(tb)
    sc = tb.scanner
    sc.publish()
    enc = sc._mirror.encoding
    assert enc is not None
    rebuilds = sc.full_rebuild_total
    assert tb.compact(last) == last
    assert sc.full_rebuild_total == rebuilds
    assert sc._mirror.encoding is enc, "steady-state compact must not re-dictionary"
    assert sc.compact_count == 1 and sc.compact_victims_total > 0
    assert listed(tb) == live
    assert tb.count(b"/registry/", b"/registry0")[0] == len(live)


def test_compact_differential_vs_generic_engine():
    """The port's device path against the port's own engine-generic host
    scanner over memkv: equal post-compact stores, equal reads."""
    g_store = t_new_storage("memkv")
    g = TBackend(g_store, TConfig(event_ring_capacity=8192))
    t_store = t_new_storage("cuda", inner="memkv", device="cpu",
                            merge_threshold=32)
    t = TBackend(t_store, TConfig(event_ring_capacity=8192))
    t.scanner._host_limit_threshold = 0
    try:
        for be in (g, t):
            _live, last = churn(be, n_keys=90)
            assert be.compact(last) == last
        assert dump(g_store) == dump(t_store._inner)
        assert g_store.version_count() == t_store._inner.version_count()
        assert rows(g.list_(b"/registry/", b"/registry0").kvs) == rows(
            t.list_(b"/registry/", b"/registry0").kvs)
        assert t.scanner.full_rebuild_total == 1
    finally:
        for be, st in ((g, g_store), (t, t_store)):
            be.close()
            st.close()


def test_compact_bulk_and_per_key_gc_agree():
    dumps, stats = [], []
    for hide_bulk in (False, True):
        store = t_new_storage("cuda", inner="memkv", device="cpu")
        b = TBackend(store, TConfig(event_ring_capacity=8192))
        b.scanner._host_limit_threshold = 0
        _live, last = churn(b, n_keys=60)
        if hide_bulk:
            with mock.patch.object(MemKv, "bulk_gc", None):
                st = b.scanner.compact(*borders(), last)
        else:
            st = b.scanner.compact(*borders(), last)
        dumps.append(dump(store._inner))
        stats.append(victim_fields(st))
        b.close()
        store.close()
    assert dumps[0] == dumps[1]
    assert stats[0] == stats[1] and stats[0][0] > 0


def test_compact_victim_only_decode(tb):
    live, last = churn(tb)
    sc = tb.scanner
    sc.publish()
    mirror = sc._mirror
    victims = {}
    orig_pull = teng.TorchScanner._pull_victim_indices

    def pull_spy(self, mask, counts, m):
        out = orig_pull(self, mask, counts, m)
        victims.update(out)
        return out

    decoded = []
    orig_decode = tblocks.Mirror.decoded_keys

    def decode_spy(self, p, idx):
        decoded.append((p, np.asarray(idx)))
        return orig_decode(self, p, idx)

    with mock.patch.object(teng.TorchScanner, "_pull_victim_indices", pull_spy), \
            mock.patch.object(tblocks.Mirror, "decoded_keys", decode_spy):
        tb.compact(last)
    n_victims = sum(len(v) for v in victims.values())
    assert decoded and sum(len(i) for _p, i in decoded) == n_victims
    for p, idx in decoded:
        assert set(idx.tolist()) <= set(victims[p].tolist())
    assert n_victims < mirror.rows
    assert listed(tb) == live


def test_compact_dirty_partition_only_republish():
    """Only partitions with victims re-upload; the successor mirror's
    device tensors are copies, so a reader holding the old mirror sees its
    tensors unchanged."""
    store = t_new_storage("cuda", inner="memkv", device="cpu", partitions=4)
    b = TBackend(store, TConfig(event_ring_capacity=16384))
    sc = b.scanner
    sc._host_limit_threshold = 0
    sc._merge_threshold = 10 ** 9
    try:
        last = 0
        for i in range(400):
            last = b.create(b"/registry/ds/k%04d" % i, b"v")
        r = b.create(b"/registry/ds/zzz", b"v0")
        for j in range(6):
            r = b.update(b"/registry/ds/zzz", b"v%d" % (j + 1), r)
        assert wait_for_revision(b, r)
        sc.publish()
        m0 = sc._mirror
        old = [t.clone() for t in (m0.keys_dev, m0.revs_dev, m0.tomb_dev)]
        uploads = []
        orig = tblocks.prepare_layout

        def spy(keys_h, revs_h, tomb_h):
            uploads.append(keys_h.shape[0])
            return orig(keys_h, revs_h, tomb_h)

        with mock.patch.object(tblocks, "prepare_layout", spy):
            assert b.compact(r) == r
        m1 = sc._mirror
        assert m1 is not m0 and uploads == [1], uploads
        dirty = [p for p in range(4)
                 if not torch.equal(m1.revs_dev[p], m0.revs_dev[p])]
        assert dirty == [3]
        for before, now in zip(old, (m0.keys_dev, m0.revs_dev, m0.tomb_dev)):
            assert torch.equal(before, now)
        res = b.list_(b"/registry/ds/", b"/registry/ds0").kvs
        assert len(res) == 401 and res[-1].value == b"v6"
    finally:
        b.close()
        store.close()


def test_compact_merges_pending_delta(tb):
    live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc.publish()
    sc._merge_threshold = 10 ** 9
    r1 = tb.create(b"/registry/pods/fresh-a", b"da")
    r2 = tb.create(b"/registry/pods/fresh-b", b"db")
    assert wait_for_revision(tb, r2)
    assert len(sc._delta) > 0
    rebuilds = sc.full_rebuild_total
    assert tb.compact(last) == last
    assert sc.full_rebuild_total == rebuilds and len(sc._delta) == 0
    assert listed(tb) == {**live, b"/registry/pods/fresh-a": r1,
                          b"/registry/pods/fresh-b": r2}


def test_compact_ttl_expiry_device_path(monkeypatch):
    store = t_new_storage("cuda", inner="memkv", device="cpu",
                          ttl_supported=False)
    b = TBackend(store, TConfig(event_ring_capacity=2048))
    b.scanner._host_limit_threshold = 0
    try:
        b.create(b"/events/ev1", b"event-payload")
        r2 = b.create(b"/registry/pods/a", b"pod")
        assert wait_for_revision(b, r2)
        assert b.compact(r2) == r2
        assert b.get(b"/events/ev1").value == b"event-payload"
        hist = b.scanner.compact_history
        monkeypatch.setattr(scanner_mod, "EVENTS_TTL_SECONDS", 0.5)
        with hist._lock:
            hist._entries = [(rev, t - 3600) for rev, t in hist._entries]
        r3 = b.create(b"/registry/pods/b", b"x")
        assert wait_for_revision(b, r3)
        assert b.compact(r3) == r3
        assert b"/events/ev1" not in {kv.key for kv in b.list_(b"/", b"").kvs}
        lo, hi = coder.internal_range(b"/events/", b"/events0")
        assert list(store._inner.iter(lo, hi)) == []
        assert b.get(b"/registry/pods/a").value == b"pod"
        assert b.scanner.full_rebuild_total == 1
    finally:
        b.close()
        store.close()


def _failing(times):
    """A stand-in for compact_partitions_stored failing ``times`` times."""
    orig = teng.compact_partitions_stored
    calls = {"n": 0}

    def fn(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= times:
            raise RuntimeError("injected mirror-half failure")
        return orig(*a, **kw)

    return fn, calls


def test_compact_retry_then_recover(tb):
    live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc.publish()
    rebuilds = sc.full_rebuild_total
    fn, calls = _failing(2)
    with mock.patch.object(teng, "compact_partitions_stored", fn):
        st = sc.compact(*borders(), last)
    assert st.mirror_path == "stored_incremental" and calls["n"] == 3
    assert sc.compact_retries_total == 2 and sc.compact_errors == 2
    assert sc.compact_escalations_total == 0
    assert sc.full_rebuild_total == rebuilds
    assert listed(tb) == live


def test_compact_escalates_to_quarantine_rebuild(tb):
    live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc._merge_max_retries = 2
    sc.publish()
    fn, calls = _failing(10 ** 9)
    with mock.patch.object(teng, "compact_partitions_stored", fn):
        st = sc.compact(*borders(), last)
        assert st.mirror_path == "escalated"
        assert sc.compact_escalations_total == 1 and calls["n"] >= 2
        assert listed(tb) == live    # degraded reads: the host store
    deadline = time.time() + 10
    while time.time() < deadline and sc._mirror_state != "serving":
        time.sleep(0.02)
    assert sc._mirror_state == "serving" and sc.rebuild_bg_count >= 1
    assert listed(tb) == live
    assert sc.full_rebuild_total == 1


def test_compact_mirror_half_runs_off_engine_lock(tb):
    live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc.publish()
    in_merge, release = threading.Event(), threading.Event()
    orig = teng.compact_partitions_stored

    def slow(*a, **kw):
        in_merge.set()
        assert release.wait(timeout=30)
        return orig(*a, **kw)

    result = {}

    def compactor():
        with mock.patch.object(teng, "compact_partitions_stored", slow):
            result["stats"] = sc.compact(*borders(), last)

    th = threading.Thread(target=compactor)
    th.start()
    try:
        assert in_merge.wait(timeout=30)
        assert listed(tb) == live    # served while the merge is parked
    finally:
        release.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert result["stats"].mirror_path == "stored_incremental"


def test_concurrent_merge_cannot_supersede_compact(tb):
    """A write burst crossing the merge threshold during a compaction
    neither supersedes it nor parks a reader: the pass holds the merge lock
    end to end, read-path merges skip, the kicked merge lands after."""
    live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc.publish()
    sc._merge_threshold = 8
    in_merge, release = threading.Event(), threading.Event()
    orig = teng.compact_partitions_stored

    def slow(*a, **kw):
        in_merge.set()
        assert release.wait(timeout=30)
        return orig(*a, **kw)

    result, fresh = {}, {}

    def compactor():
        with mock.patch.object(teng, "compact_partitions_stored", slow):
            result["stats"] = sc.compact(*borders(), last)

    th = threading.Thread(target=compactor)
    th.start()
    try:
        assert in_merge.wait(timeout=30)
        for i in range(12):
            k = b"/registry/pods/burst-%03d" % i
            fresh[k] = tb.create(k, b"fb")
        assert wait_for_revision(tb, max(fresh.values()))
        assert set(listed(tb)) == set(live) | set(fresh)
    finally:
        release.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert result["stats"].mirror_path == "stored_incremental"
    assert sc._mirror_state == "serving" and sc.compact_escalations_total == 0
    sc.publish()
    assert listed(tb) == {**live, **fresh}


def test_compact_under_concurrent_writes_and_merges(tb):
    """Eight writer threads (more than the cores here, with a short switch
    interval) keep crossing the merge threshold while compactions and reads
    run: no write is lost, nothing rebuilds from the store, no background
    merge fails, and the mirror ends equal to the host scanner."""
    import sys

    sc = tb.scanner
    live, _last = churn(tb, n_keys=60)
    sc.publish()
    sc._merge_threshold = 16
    rebuilds = sc.full_rebuild_total
    written: dict[bytes, int] = {}
    lock = threading.Lock()
    stop = threading.Event()
    errors: list[BaseException] = []

    def writer(w):
        try:
            for i in range(40):
                k = b"/registry/pods/w%d-%03d" % (w, i)
                r = tb.create(k, b"x%d" % i)
                if i % 4 == 0:
                    r = tb.update(k, b"y%d" % i, r)
                with lock:
                    written[k] = r
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    def compactor():
        try:
            while not stop.is_set():
                tb.compact(tb.current_revision())
                listed(tb)
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        comp = threading.Thread(target=compactor)
        comp.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stop.set()
        comp.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not comp.is_alive() and not any(th.is_alive() for th in threads)
    sc.publish()
    assert listed(tb) == {**live, **written}
    assert sc.full_rebuild_total == rebuilds and sc.merge_bg_errors == 0
    assert sc.compact_count > 0 and sc.compact_errors == 0
    host = Scanner(tb.store.untracked(), get_compact_revision=lambda _s: 0)
    try:
        head = tb.current_revision()
        assert rows(tb.list_(b"/", b"0").kvs) == rows(
            host.range_(b"/", b"0", head)[0])
    finally:
        host.close()


def test_compact_stats_contract(tb):
    _live, last = churn(tb, n_keys=60)
    sc = tb.scanner
    sc.publish()
    st = sc.compact(*borders(), last)
    assert st.mirror_path == "stored_incremental"
    assert st.dirty_partitions == 1 and st.survivor_rows > 0
    assert set(st.phase_seconds) == {"pre_merge", "mark", "gc", "merge",
                                     "publish"}
    assert st.deleted_versions == 80 and st.deleted_tombstones == 20
    assert st.deleted_rev_records == 20 and st.expired_ttl == 0
    assert st.survivor_rows == sc._mirror.rows


@pytest.mark.parametrize("shape", ["victims", "survivors", "dense"])
def test_pull_victim_indices_branches(shape):
    """The two-phase pull takes the victim indices when victims are fewer,
    the survivor indices when survivors are fewer, and the mask when both
    are dense; each gives the mask's exact victim rows."""
    rng = np.random.RandomState(3)
    n, nv = 4096, np.array([3000, 0, 4000], np.int32)
    frac = {"victims": 0.01, "survivors": 0.99, "dense": 0.5}[shape]
    mask = (rng.rand(3, n) < frac) & (np.arange(n)[None] < nv[:, None])
    sc = teng.TorchScanner(t_new_storage("memkv"),
                           get_compact_revision=lambda _s: 0, device="cpu")
    try:
        fake = mock.Mock(n_valid=nv, n_valid_dev=torch.from_numpy(nv))
        counts = torch.from_numpy(mask.sum(axis=1).astype(np.int32))
        pulls = []
        real = teng._host_pull
        with mock.patch.object(teng, "_host_pull",
                               lambda x: pulls.append(tuple(x.shape)) or real(x)):
            got = sc._pull_victim_indices(torch.from_numpy(mask), counts, fake)
        assert sorted(got) == [0, 2]
        for p in (0, 2):
            assert (got[p] == np.nonzero(mask[p])[0]).all()
        assert pulls[0] == (3,)  # the launch's counts, 4·P bytes
        assert (pulls[-1] == (3, n)) == (shape == "dense")
    finally:
        sc.close()
