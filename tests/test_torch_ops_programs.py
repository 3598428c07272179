"""The device programs that no serving path calls, ported to the port's
layout (ROADMAP item 11), held against the JAX programs on the CPU:
``ops/scan.py`` ``count_visible``, ``visible_mask`` (``visible_mask_jit``),
``visible_indices`` and ``point_lookup`` (``make_point_lookup``),
``ops/compact.py::compact_block`` and ``ops/fanout.py::fanout_mask``. The
inputs are those of ``tests/test_ops.py`` and seeded random MVCC blocks
(version chains, tombstones, rows past ``n_valid`` that copy real rows);
every output must equal the JAX one exactly, padded tails, not-found
answers and fill values included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubebrain_tpu.ops import compact as jcompact
from kubebrain_tpu.ops import fanout as jfanout
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu.ops import scan as jscan
from kubebrain_tpu_torch.ops import compact as tcompact
from kubebrain_tpu_torch.ops import fanout as tfanout
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan

from test_ops import _random_dataset

PAD = 7  # rows past n_valid: copies of real rows, which must never count


def block(rows, pad: int = PAD):
    """Sorted (key, rev, tomb) rows → the JAX block (chunks uint32[N, C],
    hi, lo, tomb bool) and the port's (keys_t int32[C, N], revs int64,
    tomb int8), N = len(rows) + pad, the pad rows copying the first ones."""
    full = list(rows) + [rows[i % len(rows)] for i in range(pad)]
    chunks, _ = jkeys.pack_keys([r[0] for r in full])
    revs = np.array([r[1] for r in full], dtype=np.uint64)
    tomb = np.array([r[2] for r in full])
    hi, lo = jkeys.split_revs(revs)
    jax_block = tuple(jnp.asarray(a) for a in (chunks, hi, lo, tomb))
    port_block = (torch.from_numpy(np.ascontiguousarray(
                      tscan.flip_sign(chunks).T)),
                  torch.from_numpy(revs.astype(np.int64)),
                  torch.from_numpy(tomb.astype(np.int8)))
    return jax_block, port_block


def jrev(rev: int):
    hi, lo = jkeys.split_revs(np.array([rev], dtype=np.uint64))
    return jnp.asarray(hi[0]), jnp.asarray(lo[0])


def flipped(key: bytes) -> torch.Tensor:
    return torch.from_numpy(tscan.flip_sign(tkeys.pack_one(key)))


RANGES = [(b"", b""), (b"/reg/c", b"/reg/p"), (b"/reg/zz", b""),
          (b"/reg/m", b"/reg/m"), (b"/reg/a", b"/reg/b")]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_visibility_programs_match_jax(seed):
    """``count_visible``, ``visible_mask`` and ``visible_indices`` (sizes
    from 1 to past the count, so the fill shows) over ranges and read
    revisions, rows past ``n_valid`` copying real rows."""
    rows, max_rev = _random_dataset(seed)
    (jk, jhi, jlo, jt), (tk, tr, tt) = block(rows)
    n_valid = len(rows)
    for read_rev in (0, 1, max_rev // 2, max_rev, max_rev + 5):
        for start, end in RANGES:
            jargs = (jk, jhi, jlo, jt, jnp.asarray(np.int32(n_valid)),
                     jnp.asarray(jkeys.pack_one(start)),
                     jnp.asarray(jkeys.pack_one(end)), jnp.asarray(not end),
                     *jrev(read_rev))
            targs = (tk, tr, tt, n_valid, flipped(start), flipped(end),
                     not end, read_rev)
            want = np.asarray(jscan.visible_mask_jit(*jargs))
            got = tscan.visible_mask(*targs)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)
            count = tscan.count_visible(*targs)
            assert count.dtype == torch.int32
            assert int(count) == int(jscan.count_visible(*jargs))
            for size in sorted({1, int(count), int(count) + 3, len(want)}):
                np.testing.assert_array_equal(
                    tscan.visible_indices(got, size).numpy(),
                    np.asarray(jscan.visible_indices(jnp.asarray(want), size)))


def test_visibility_padding_rows_excluded():
    """``tests/test_ops.py``'s padding case: rows past ``n_valid`` are
    never visible, and ``visible_indices`` pads with the mask's length."""
    rows = [(b"/a", 1, False), (b"/b", 2, False)]
    (jk, jhi, jlo, jt), (tk, tr, tt) = block(rows, pad=2)
    jargs = (jk, jhi, jlo, jt, jnp.asarray(np.int32(2)),
             jnp.asarray(jkeys.pack_one(b"")), jnp.asarray(jkeys.pack_one(b"")),
             jnp.asarray(True), *jrev(5))
    got = tscan.visible_mask(tk, tr, tt, 2, flipped(b""), flipped(b""), True, 5)
    assert got.tolist() == [True, True, False, False]
    assert got.tolist() == np.asarray(jscan.visible_mask_jit(*jargs)).tolist()
    assert tscan.visible_indices(got, 4).tolist() == [0, 1, 4, 4]
    assert tscan.visible_indices(got, 4).tolist() == np.asarray(
        jscan.visible_indices(jnp.asarray(got.numpy()), 4)).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_lookup_matches_jax(seed):
    """Every key of the block and absent ones (between keys, before the
    first, past the last, a key only the rows past ``n_valid`` hold) at
    read revisions from before the first write to past the last: found,
    revision, row and tombstone all equal, the not-found answer (row 0
    and its fields) included."""
    rows, max_rev = _random_dataset(seed)
    ghost = (b"/reg/~ghost", 1, False)  # sorts last: only past n_valid
    (jk, jhi, jlo, jt), (tk, tr, tt) = block(rows + [ghost], pad=0)
    n_valid = len(rows)
    lookup = jscan.make_point_lookup(jkeys.CHUNKS)
    keys = sorted({r[0] for r in rows})
    probes = keys + [b"/reg/", b"/reg/" + keys[3][5:] + b"a", b"/a", b"/zzz",
                     ghost[0]]
    founds = 0
    for key in probes:
        for read_rev in (0, 1, max_rev // 3, max_rev, max_rev + 1):
            jf, jh, jl, jrow, jtomb = lookup(
                jk, jhi, jlo, jt, jnp.asarray(np.int32(n_valid)),
                jnp.asarray(jkeys.pack_one(key)), *jrev(read_rev))
            found, rev, row, tomb = tscan.point_lookup(
                tk, tr, tt, n_valid, flipped(key), read_rev)
            assert bool(found) == bool(jf), (key, read_rev)
            assert int(rev) == int(jkeys.join_revs(np.asarray(jh),
                                                   np.asarray(jl)))
            assert int(row) == int(jrow)
            assert bool(tomb) == bool(jtomb)
            if not found:
                assert int(row) == 0 and int(rev) == rows[0][1]
            founds += bool(found)
    assert founds > 0


def _jax_compact(jk, jhi, jlo, jt, mask):
    k, h, lo, t, cnt = jcompact.compact_block(jk, jhi, jlo, jt,
                                              jnp.asarray(mask))
    return (np.asarray(k), jkeys.join_revs(np.asarray(h), np.asarray(lo)),
            np.asarray(t), int(cnt))


def _port_compact(tk, tr, tt, mask):
    """The port's compact_block, in the JAX block's layout (unflipped
    uint32 chunk rows, uint64 revisions, bool tombstones)."""
    k, r, t, cnt = tcompact.compact_block(tk, tr, tt,
                                          torch.from_numpy(np.array(mask)))
    assert cnt.dtype == torch.int32
    return (k.t().numpy().view(np.uint32) ^ np.uint32(0x80000000),
            r.numpy().astype(np.uint64), t.numpy() != 0, int(cnt))


def test_compact_block_on_the_victim_mask_of_test_ops():
    """``tests/test_ops.py``'s compaction case: the block shrunk by the
    victim mask at revision 3 keeps /a@3 and /events/e@4,5, and the tail
    repeats the last row."""
    rows = [(b"/a", 1, False), (b"/a", 3, False), (b"/b", 2, True),
            (b"/events/e", 4, False), (b"/events/e", 5, False)]
    (jk, jhi, jlo, jt), (tk, tr, tt) = block(rows, pad=0)
    ttl = jnp.asarray(np.array([r[0].startswith(b"/events/") for r in rows]))
    mask = np.asarray(jcompact.victim_mask(
        jk, jhi, jlo, jt, ttl, jnp.asarray(np.int32(len(rows))), *jrev(3),
        *jrev(0)))
    assert mask.tolist() == [True, False, True, False, False]
    want = _jax_compact(jk, jhi, jlo, jt, mask)
    got = _port_compact(tk, tr, tt, mask)
    assert got[3] == want[3] == 3
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [3, 4, 5, 5, 5]


@pytest.mark.parametrize("case", ["random", "all", "none", "last", "first"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_block_matches_jax(case, seed):
    """Random masks, a block with every row masked (count 0, every row
    the last one), nothing masked (the block unchanged), and masks that
    drop only the last or only the first row: keys, revisions, tombstones
    and counts equal the JAX program's, tails included."""
    rows, _ = _random_dataset(seed)
    (jk, jhi, jlo, jt), (tk, tr, tt) = block(rows)
    n = len(rows) + PAD
    rng = np.random.RandomState(seed)
    mask = {"random": rng.rand(n) < 0.4, "all": np.ones(n, bool),
            "none": np.zeros(n, bool),
            "last": np.arange(n) == n - 1, "first": np.arange(n) == 0}[case]
    want = _jax_compact(jk, jhi, jlo, jt, mask)
    got = _port_compact(tk, tr, tt, mask)
    assert got[3] == want[3] == int((~mask).sum())
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)


def test_fanout_mask_of_test_ops():
    """``tests/test_ops.py``'s fan-out case, through the port."""
    events = [b"/registry/pods/default/a", b"/registry/services/x",
              b"/registry/pods/kube/b"]
    prefixes = [b"/registry/pods/", b"/registry/", b"/registry/pods/kube"]
    got = _port_fanout(events, [10, 11, 12], prefixes, [0, 11, 0])
    assert got.tolist() == [[True, False, False], [False, True, False],
                            [True, True, True]]
    assert got.tolist() == _jax_fanout(events, [10, 11, 12], prefixes,
                                       [0, 11, 0]).tolist()


def _jax_fanout(events, ev_revs, prefixes, min_revs):
    ek, _ = jkeys.pack_keys(events)
    ehi, elo = jkeys.split_revs(np.array(ev_revs, dtype=np.uint64))
    pc, pm = jkeys.chunk_prefix_masks(prefixes)
    whi, wlo = jkeys.split_revs(np.array(min_revs, dtype=np.uint64))
    return np.asarray(jfanout.fanout_mask(*(jnp.asarray(a) for a in (
        ek, ehi, elo, pc, pm, whi, wlo))))


def _port_fanout(events, ev_revs, prefixes, min_revs) -> torch.Tensor:
    ek, _ = tkeys.pack_keys(events)
    pc, pm = tfanout.prefix_rows(*tkeys.chunk_prefix_masks(prefixes))
    return tfanout.fanout_mask(
        torch.from_numpy(tscan.flip_sign(ek)),
        torch.tensor(ev_revs, dtype=torch.int64), torch.from_numpy(pc),
        torch.from_numpy(pm), torch.tensor(min_revs, dtype=torch.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fanout_mask_matches_jax(seed):
    """Random events and prefix watchers: prefixes of every length from 0
    (every key) to whole keys and past them, cut inside a chunk and on
    chunk edges, bytes at and above 0x80 (the sign bit the port's layout
    flips), and ``min_rev`` at, below and above the event revisions."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"/abcz\x7f\x80\xfe", np.uint8)
    events = [b"/r/" + bytes(rng.choice(alphabet, rng.randint(0, 14)))
              for _ in range(60)]
    prefixes = [b""]
    for _ in range(50):
        k = events[rng.randint(len(events))]
        prefixes.append(k[: rng.randint(0, len(k) + 2)])
    prefixes += [events[0] + b"a", b"/r/\x80", b"/r/\xfe\xfe"]
    ev_revs = list(rng.randint(1, 40, len(events)))
    min_revs = list(rng.randint(0, 45, len(prefixes)))
    got = _port_fanout(events, ev_revs, prefixes, min_revs)
    want = _jax_fanout(events, ev_revs, prefixes, min_revs)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the byte rule itself
    oracle = np.array([[e.startswith(p) and r >= m
                        for p, m in zip(prefixes, min_revs)]
                       for e, r in zip(events, ev_revs)])
    np.testing.assert_array_equal(want, oracle)
    assert 0 < int(got.sum()) < got.numel()
