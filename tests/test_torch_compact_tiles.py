"""K3's tiled algorithm on the CPU: ``ops/compact.py`` ``victim_tile_classes``,
``victim_lookback`` and ``victim_mask_tiled`` state in plain PyTorch what the
CUDA kernel (``csrc/compact_victims.cu``) does: tiles classified against
[start, end) from their first and last valid key, and a TTL row whose group
is still open at its tile's last row given the verdict of the first group
end in a later tile, through the tiles' status words.

The tiled mask is held to the plain ``victim_mask``, to the JAX package's
jnp ``victim_mask`` with the engine's range restriction (chains of at most
64 rows, the jnp cap) and to ``victim_mask_pallas`` in interpret mode
(longer chains), on the tile-edge cases of the design: chains that start on
a tile's first row or end on its last, chains that span exactly 1, 2 and 5
tiles, tiles without a group end, bounds on tile edges, P = 3 partitions
(one empty, the others with n_valid no multiple of the tile), a capacity no
multiple of the kernel's rows per thread, and TTL cutoffs of 0 and past the
compact revision. Masks are booleans: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from test_torch_compact import (
    WIDTH,
    corpus,
    jnp_victims,
    pallas_victims,
    rows_arrays,
    stored_domain,
)
from kubebrain_tpu_torch.ops import compact, compact_kernels
from kubebrain_tpu_torch.ops import scan as tscan
from kubebrain_tpu_torch.storage.cuda import engine as teng

#: rows past the largest n_valid: the capacity is a multiple of neither the
#: tile nor the kernel's rows per thread
SLACK = 37


def edge_partitions(tile: int) -> list:
    """Three partitions of (user key, rows) chains, rows sorted by key:

    0: TTL chains a-f of tile-1, tile, tile+1, 2·tile, tile and 5·tile rows,
       then 37 singletons. b starts on tile 0's last row; c ends on tile 2's
       last row; d fills tiles 3-4, e tile 5 and f tiles 6-10 exactly, so
       tiles 3 and 6-9 hold no group end;
    1: empty;
    2: a TTL chain of 2·tile+5 rows, then chains of 3 rows without TTL."""
    part0 = [(b"/events/%s" % name, rows) for name, rows in (
        (b"a", tile - 1), (b"b", tile), (b"c", tile + 1), (b"d", 2 * tile),
        (b"e", tile), (b"f", 5 * tile))]
    part0 += [(b"/events/s%04d" % i, 1) for i in range(37)]
    part2 = [(b"/events/zlong", 2 * tile + 5)]
    part2 += [(b"/reg/k%04d" % i, 3) for i in range(20)]
    return [part0, [], part2]


def build(parts):
    """Port tensors (keys_t, revs, tomb, ttl, n_valid) of ``parts`` (raw
    keys), and each partition's rows for the references: (chunks, revs,
    tomb, ttl) or None where it is empty. Revisions ascend with the row in
    each partition; every seventh row is a tombstone."""
    nv = np.array([sum(m for _k, m in chains) for chains in parts], np.int32)
    cap = int(nv.max()) + SLACK
    n_parts = len(parts)
    k = np.zeros((n_parts, cap, WIDTH // 4), np.uint32)
    r = np.zeros((n_parts, cap), np.uint64)
    t = np.zeros((n_parts, cap), bool)
    x = np.zeros((n_parts, cap), np.int8)
    per = []
    for p, chains in enumerate(parts):
        keys = [key for key, m in chains for _ in range(m)]
        if not keys:
            per.append(None)
            continue
        u8, lens, revs, tomb, ttl = rows_arrays(
            keys, np.arange(1, len(keys) + 1), np.arange(len(keys)) % 7 == 6)
        chunks, _enc = stored_domain(u8, lens, False)
        m = len(keys)
        k[p, :m], r[p, :m], t[p, :m], x[p, :m] = chunks, revs, tomb, ttl
        per.append((chunks, revs, tomb, ttl))
    kt, rv, t8 = tscan.prepare_layout(k, r, t)
    cols = tuple(torch.from_numpy(a) for a in (kt, rv, t8, x, nv))
    return cols, per


def bound_args(start: bytes, end: bytes):
    """(start row, end row, unbounded) as the references take them, and
    the port's flipped int32 rows."""
    s_row, e_row, unb = teng.bound_rows(None, WIDTH, start, end)
    flip = lambda a: torch.from_numpy(tscan.flip_sign(a))
    return (s_row, e_row, unb), (flip(s_row), flip(e_row), unb)


def key_of_row(parts, p: int, row: int) -> bytes:
    for key, m in parts[p]:
        if row < m:
            return key
        row -= m
    raise IndexError(row)


def check(cols, per, ref_bounds, port_bounds, crev, tcut, tile, refs):
    """The tiled mask equals the plain mask and, partition by partition,
    each reference in ``refs``; every look-back stays on tiles in range.
    Returns (mask, tile classes, reach)."""
    keys_t, revs, tomb, ttl, nv = cols
    args = (keys_t, revs, tomb, ttl, nv, *port_bounds, crev, tcut)
    plain = compact.victim_mask(*args)
    tiled = compact.victim_mask_tiled(*args, tile=tile)
    assert torch.equal(tiled, plain), torch.nonzero(tiled != plain)[:10]
    for p, rows in enumerate(per):
        if rows is None:
            assert not plain[p].any()
            continue
        m = int(nv[p])
        for ref in refs:
            want = ref(*rows, crev, tcut, *ref_bounds)
            got = plain[p, :m].numpy()
            assert (got == want).all(), (ref.__name__, p, np.nonzero(got != want)[0][:10])
    assert not plain[:, int(nv.max()):].any()
    cls, reach = compact.victim_lookback(keys_t, revs, ttl, nv, *port_bounds,
                                         tcut, tile=tile)
    for p, b in zip(*torch.nonzero(reach >= 0, as_tuple=True)):
        stop = int(reach[p, b])
        assert stop < cls.shape[1], "a look-back ran past its partition"
        walked = cls[p, int(b) + 1 : stop + 1]
        assert ((walked == compact.INSIDE) | (walked == compact.STRADDLE)).all(), \
            "an in-range TTL row's look-back reached a tile out of range"
    return plain, cls, reach


#: (label, bounds as (partition 0 row of start, of end) in tiles and rows,
#: compact revision, TTL cutoff), revisions and rows in units of the tile
CASES = [
    ("unbounded, a and b expire", None, 8, 2),
    ("unbounded, a-e expire", None, 8, 6),
    ("tiles 3-4 exactly", ((3, 0), (5, 0)), 8, 6),
    ("tiles 6-10 exactly", ((6, 0), (11, 0)), 8, 12),
    ("from tile 0's last row to tile 1's last row", ((1, -1), (2, -1)), 8, 6),
    ("cutoff 0", None, 8, 0),
    ("cutoff past the compact revision", None, 2, 12),
]


def case_args(parts, bounds, crev, tcut, tile):
    if bounds is None:
        ref_b, port_b = bound_args(b"", b"")
    else:
        (s_tile, s_off), (e_tile, e_off) = bounds
        ref_b, port_b = bound_args(key_of_row(parts, 0, s_tile * tile + s_off),
                                   key_of_row(parts, 0, e_tile * tile + e_off))
    return ref_b, port_b, crev * tile, tcut * tile


@pytest.mark.parametrize("label,bounds,crev,tcut", CASES, ids=[c[0] for c in CASES])
def test_tile_edges_match_jnp_and_pallas(label, bounds, crev, tcut):
    """Small tiles (8 rows), so every chain is at most 64 rows long: the
    tiled mask equals the plain, jnp and Pallas-interpret masks."""
    tile = 8
    parts = edge_partitions(tile)
    cols, per = build(parts)
    assert cols[0].shape[2] % compact.ROWS_PER_THREAD != 0
    ref_b, port_b, c, t = case_args(parts, bounds, crev, tcut, tile)
    check(cols, per, ref_b, port_b, c, t, tile, (jnp_victims, pallas_victims))


@pytest.mark.parametrize("label,bounds,crev,tcut", CASES, ids=[c[0] for c in CASES])
def test_tile_edges_at_the_kernel_tile_match_pallas(label, bounds, crev, tcut):
    """The kernel's own tile (``TILE_ROWS``): chains of up to 5 tiles, past
    the jnp cap, against the Pallas kernel in interpret mode."""
    tile = compact.TILE_ROWS
    parts = edge_partitions(tile)
    cols, per = build(parts)
    ref_b, port_b, c, t = case_args(parts, bounds, crev, tcut, tile)
    mask, cls, reach = check(cols, per, ref_b, port_b, c, t, tile,
                             (pallas_victims,))
    assert (cls[1] == compact.PAST).all()          # the empty partition
    if t and bounds is None:
        # b starts on tile 0's last row and c on tile 1's: both look one tile
        # ahead; c ends on tile 2's last row, d fills tiles 3-4, e tile 5;
        # f's tiles 6-9 hold no group end and walk to tile 10
        assert reach[0, :12].tolist() == [1, 2, -1, 4, -1, -1, 10, 10, 10,
                                          10, -1, -1]


def test_tile_classes_on_tile_edges():
    """Bounds on the first rows of tiles 3 and 5 of partition 0: tiles 3 and
    4 are inside, the rest of partition 0 and all of partition 2 outside,
    the empty partition and the tiles past n_valid past."""
    tile = 8
    parts = edge_partitions(tile)
    (keys_t, _r, _t, _x, nv), _per = build(parts)
    _ref, (s, e, unb) = bound_args(key_of_row(parts, 0, 3 * tile),
                                   key_of_row(parts, 0, 5 * tile))
    cls = compact.victim_tile_classes(keys_t, nv, s, e, unb, tile)
    nt = cls.shape[1]
    want = torch.full((3, nt), compact.PAST, dtype=torch.int8)
    n0, n2 = compact.n_tiles(int(nv[0]), tile), compact.n_tiles(int(nv[2]), tile)
    want[0, :n0] = compact.OUTSIDE
    want[0, 3:5] = compact.INSIDE
    want[2, :n2] = compact.OUTSIDE
    assert torch.equal(cls, want)
    # one row earlier on each side, [c, d): c starts on tile 1's last row,
    # so tile 1 straddles and tile 2 (all c) is inside; d is out
    _ref, (s, e, unb) = bound_args(key_of_row(parts, 0, 3 * tile - 1),
                                   key_of_row(parts, 0, 5 * tile - 1))
    cls = compact.victim_tile_classes(keys_t, nv, s, e, unb, tile)
    assert cls[0, :5].tolist() == [compact.OUTSIDE, compact.STRADDLE,
                                   compact.INSIDE, compact.OUTSIDE,
                                   compact.OUTSIDE]


@pytest.mark.parametrize("tile", [4, 16, compact.TILE_ROWS])
@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("bounds", [(b"", b""), (b"/events/m", b"/reg/q")])
@pytest.mark.parametrize("seed", [1, 2])
def test_random_corpus_matches_jnp(seed, bounds, encoded, tile):
    """Random sorted corpora (chains of 1-5 rows, TTL and plain keys,
    tombstones, revisions at random across chains, so that neighbouring
    groups take different TTL verdicts) in one partition: tiled == plain ==
    jnp, every look-back in range."""
    u8, lens, revs, tomb, ttl = corpus(seed, n_keys=400)
    # revisions at random across chains, ascending inside each
    rng = np.random.RandomState(seed)
    key_id = np.cumsum(np.r_[True, (u8[1:] != u8[:-1]).any(axis=1)])
    shuffled = rng.permutation(len(revs)).astype(np.uint64) + 1
    revs = shuffled[np.lexsort((shuffled, key_id))]
    chunks, enc = stored_domain(u8, lens, encoded)
    s_row, e_row, unb = teng.bound_rows(enc, WIDTH, *bounds)
    n = len(chunks)
    kt, rv, t8 = tscan.prepare_layout(chunks[None], revs[None], tomb[None])
    pad = lambda a: torch.from_numpy(np.concatenate(
        [a, np.zeros((1, SLACK) + a.shape[2:], a.dtype)], axis=1))
    cols = (torch.from_numpy(np.concatenate(
        [kt, np.zeros((1, kt.shape[1], SLACK), kt.dtype)], axis=2)),
        pad(rv), pad(t8), pad(ttl[None].astype(np.int8)),
        torch.tensor([n], dtype=torch.int32))
    top = int(revs.max())
    port_b = (torch.from_numpy(tscan.flip_sign(s_row)),
              torch.from_numpy(tscan.flip_sign(e_row)), unb)
    for crev, tcut in ((top // 2, top // 3), (top // 4, top // 2), (top, 0)):
        check(cols, [(chunks, revs, tomb, ttl)], (s_row, e_row, unb), port_b,
              crev, tcut, tile, (jnp_victims,))


def test_wrapper_returns_the_counts_and_takes_32_chunks():
    """On CPU tensors the K3 wrapper returns the plain mask and its
    per-partition counts, and launches nothing; the kernel takes at most 32
    key chunks."""
    tile = 8
    parts = edge_partitions(tile)
    cols, _per = build(parts)
    _ref, port_b = bound_args(b"", b"")
    mask, counts = compact_kernels.victim_mask_batch(*cols, *port_b, 8 * tile,
                                                     6 * tile)
    assert torch.equal(mask, compact.victim_mask(*cols, *port_b, 8 * tile,
                                                 6 * tile))
    assert counts.dtype == torch.int32 and counts.tolist() == mask.sum(1).tolist()
    assert counts[1] == 0 and counts[0] > 0
    assert compact_kernels.victim_mask_batch.launches == 0
    kt = torch.zeros((1, 33, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32"):
        compact_kernels._check_layout(
            kt, torch.zeros((1, 8), dtype=torch.int64),
            torch.zeros((1, 8), dtype=torch.int8),
            torch.zeros((1, 8), dtype=torch.int8),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(33, dtype=torch.int32), torch.zeros(33, dtype=torch.int32))
