"""The port's rank-space fan-out (``kubebrain_tpu_torch.ops.fanout``:
``RankIndex``, ``rank_index_plain``, ``rank_index_update``,
``event_ranks_plain``, the rank-space mask, and ``fanout_dispatch_ranked``,
the emulation of K4's design) and the watcher table's index under churn on
the CPU against the chunk-compare plain versions, the JAX
package's jnp ``fanout_mask_range_wmajor``, ``fanout_mask_range`` and
``fanout_dispatch`` on the same inputs, and ``match_oracle`` on raw bytes.

Inputs are made from a numpy seed and are adversarial for the rank index:
keys over a five-byte alphabet (so keys share prefixes, are prefixes of
each other and equal each other), 0xFF bytes and all-0xFF keys, event keys
equal to a start or an end, NUL-bound single-key watches, bounded empty
ranges (the free-slot sentinel's shape), start == end, inverted ranges,
duplicate bounds across watchers and revisions at and one below a
``min_rev``. Masks, counts and indices are integers: every comparison is
exact."""

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kubebrain_tpu.backend.common import WatchEvent as JWatchEvent
from kubebrain_tpu.fanout import dispatch as jdispatch
from kubebrain_tpu.fanout.matcher import DeviceFanout as JDeviceFanout
from kubebrain_tpu.ops import fanout as jfanout
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu_torch.backend.common import WatchEvent
from kubebrain_tpu_torch.fanout import DeviceFanout, match_oracle
from kubebrain_tpu_torch.ops import fanout as tfanout
from kubebrain_tpu_torch.ops import fanout_kernels
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan

CHUNKS = [1, 2, 4, 8, 16, 64]
ALPHABET = b"/ab\x01\xff"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that the test run's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_key(rng, max_len: int) -> bytes:
    n = rng.randint(0, max_len + 1)
    return bytes(ALPHABET[i] for i in rng.randint(0, len(ALPHABET), n))


def prefix_end(k: bytes) -> bytes:
    """The end of the prefix range of ``k`` (b"" = unbounded)."""
    k = k.rstrip(b"\xff")
    return k[:-1] + bytes([k[-1] + 1]) if k else b""


def population(rng, n_w: int, width: int) -> list:
    """Specs (wid, start, end, min_rev) of every shape the hub holds, with
    bounds that fit ``width`` after the NUL canonicalization."""
    lim = width - 2
    specs = []
    for w in range(n_w):
        k = rand_key(rng, lim)
        roll = rng.rand()
        if roll < 0.2:
            start, end = k, prefix_end(k)
        elif roll < 0.35:
            start, end = k, k + b"\x00"             # a single-key watch
        elif roll < 0.45:
            start, end = k, b""                     # unbounded
        elif roll < 0.65:
            start, end = k, rand_key(rng, lim)      # maybe inverted
        elif roll < 0.7:
            start, end = b"", b""                   # the sentinel's shape
        elif roll < 0.75:
            start, end = k, k                       # empty
        elif roll < 0.8:
            start, end = b"\xff" * lim, b""         # all-0xFF start
        elif specs:                                 # a duplicate's bounds
            _w, start, end, _r = specs[rng.randint(len(specs))]
        else:
            start, end = k, b""
        specs.append((w, start, end, int(rng.randint(0, 40))))
    return specs


def event_keys(rng, n_e: int, specs, width: int) -> list:
    """Event keys (NUL-free, at most ``width`` bytes): starts, ends, their
    prefixes and one-byte extensions, all-0xFF keys, random keys."""
    out = []
    for _ in range(n_e):
        _w, s, e, _r = specs[rng.randint(len(specs))]
        b = s if rng.rand() < 0.5 or not e or b"\x00" in e else e
        roll = rng.rand()
        if roll < 0.3:
            k = b
        elif roll < 0.45:
            k = b[:rng.randint(0, len(b) + 1)]
        elif roll < 0.6:
            k = b + bytes([ALPHABET[rng.randint(len(ALPHABET))]])
        elif roll < 0.65:
            k = b"\xff" * width
        else:
            k = rand_key(rng, width)
        out.append(k[:width].replace(b"\x00", b"\x01"))
    return out


class Case:
    """One block and watcher table for both packages."""

    def __init__(self, specs, keys, revs, width):
        self.specs, self.keys, self.revs = specs, keys, revs
        starts = [jkeys.canonicalize_bound(s) for _, s, _, _ in specs]
        ends = [jkeys.canonicalize_bound(e) for _, _, e, _ in specs]
        unb = np.array([not e for _, _, e, _ in specs])
        min_rev = np.array([r for *_x, r in specs], dtype=np.uint64)
        revs = np.asarray(revs, dtype=np.uint64)
        ek, _ = jkeys.pack_keys(keys, width)
        ws, _ = jkeys.pack_keys(starts, width)
        we, _ = jkeys.pack_keys(ends, width)
        ehi, elo = jkeys.split_revs(revs)
        whi, wlo = jkeys.split_revs(min_rev)
        self.jax = (jnp.asarray(ek), jnp.asarray(ehi), jnp.asarray(elo),
                    jnp.asarray(ws), jnp.asarray(we), jnp.asarray(unb),
                    jnp.asarray(whi), jnp.asarray(wlo))
        flip = lambda a: torch.from_numpy(tscan.flip_sign(a))
        self.ev = (flip(tkeys.pack_keys(keys, width)[0]),
                   torch.from_numpy(tfanout.revisions(revs)))
        self.table = (flip(tkeys.pack_keys(starts, width)[0]),
                      flip(tkeys.pack_keys(ends, width)[0]),
                      torch.from_numpy(unb),
                      torch.from_numpy(tfanout.revisions(min_rev)))

    def oracle(self, n_ev=None) -> np.ndarray:
        """bool[W, E] by match_oracle on raw bytes, events past n_ev
        False."""
        n_ev = len(self.keys) if n_ev is None else n_ev
        evs = [JWatchEvent(revision=int(r), key=k)
               for k, r in zip(self.keys, self.revs)]
        mask = match_oracle(evs, self.specs).T
        mask[:, n_ev:] = False
        return mask


def make_case(seed: int, n_w: int, n_e: int, chunks: int) -> Case:
    rng = np.random.RandomState(seed)
    width = 4 * chunks
    specs = population(rng, n_w, width)
    keys = event_keys(rng, n_e, specs, width)
    revs = rng.randint(0, 40, n_e)
    for i in range(0, n_e, 5):   # revisions at a min_rev and one below
        r = specs[rng.randint(n_w)][3]
        revs[i] = max(r - (i // 5) % 2, 0)
    return Case(specs, keys, revs, width)


def rank_mask(case: Case, n_ev: int, index=None) -> np.ndarray:
    return tfanout.fanout_mask_rank_plain(*case.ev, n_ev, *case.table,
                                          index=index).numpy().T


# --------------------------------------------------------------- the index
@pytest.mark.parametrize("chunks", CHUNKS)
def test_index_rows_sorted_distinct_and_each_slot_exact(chunks):
    """U holds every bound row once, strictly ascending in key order, and
    each slot's rs/re name its own start and end rows."""
    case = make_case(chunks, 48, 8, chunks)
    ws, we = case.table[:2]
    index = tfanout.rank_index_plain(ws, we)
    rows = [tuple(r) for r in index.rows.tolist()]
    assert rows == sorted(set(rows))
    assert set(rows) == {tuple(r) for r in torch.cat([ws, we]).tolist()}
    assert torch.equal(index.rows[index.rs.long()], ws)
    assert torch.equal(index.rows[index.re.long()], we)
    assert index.rs.dtype == index.re.dtype == index.rows.dtype == torch.int32


@pytest.mark.parametrize("chunks", [1, 4, 16])
def test_event_ranks_are_upper_bounds(chunks):
    """r(k) = the number of rows of U that are <= k (bisect_right over the
    rows as tuples of flipped chunks); padding events rank 0."""
    case = make_case(100 + chunks, 40, 64, chunks)
    index = tfanout.rank_index_plain(*case.table[:2])
    ranks = tfanout.event_ranks_plain(case.ev[0], 50, index).tolist()
    rows = [tuple(r) for r in index.rows.tolist()]
    want = [bisect.bisect_right(rows, tuple(k))
            for k in case.ev[0][:50].tolist()]
    assert ranks[:50] == want and ranks[50:] == [0] * 14


def test_empty_table_ranks_everything_zero():
    ws = torch.empty((0, 4), dtype=torch.int32)
    index = tfanout.rank_index_plain(ws, ws)
    assert index.rows.shape == (0, 4) and index.rs.numel() == 0
    keys = torch.zeros((3, 4), dtype=torch.int32)
    assert tfanout.event_ranks_plain(keys, 3, index).tolist() == [0, 0, 0]


# ------------------------------------------------- rank space, four ways
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_rank_space_equals_chunk_compare_jax_and_oracle(chunks, seed):
    """The match in rank space == the chunk compare == the JAX package's
    jnp watcher-major and event-major masks == match_oracle on raw
    bytes."""
    case = make_case(seed * 97 + chunks, 56, 40, chunks)
    e = len(case.keys)
    got = rank_mask(case, e)
    chunk = tfanout.fanout_mask_range_wmajor(*case.ev, *case.table).numpy()
    jw = np.asarray(jfanout.fanout_mask_range_wmajor(*case.jax))
    je = np.asarray(jfanout.fanout_mask_range(*case.jax))
    assert (got == chunk).all() and (got == jw).all() and (got == je.T).all()
    assert (got == case.oracle()).all()
    assert got.any() and not got.all()


@pytest.mark.parametrize("size_mode", ["below", "at", "above"])
@pytest.mark.parametrize("chunks", [1, 4, 16, 64])
def test_rank_dispatch_equals_jax_dispatch(chunks, size_mode):
    """J4 in rank space (counts and compacted indices, E-padding masked by
    n_ev, truncated at size) == the JAX dispatch == the chunk-compare
    plain version."""
    case = make_case(7 * chunks, 40, 32, chunks)
    n_ev = 27
    total = int(case.oracle(n_ev).sum())
    size = {"below": max(total // 2, 1), "at": total,
            "above": 2 * total + 5}[size_mode]
    want = jdispatch.fanout_dispatch(*case.jax[:3], np.int32(n_ev),
                                     *case.jax[3:], size=size)
    counts, idx = tfanout.fanout_dispatch_ranked(*case.ev, n_ev,
                                                 *case.table, size)
    plain = tfanout.fanout_dispatch_plain(*case.ev, n_ev, *case.table, size)
    assert (counts.numpy() == np.asarray(want[0])).all()
    assert (idx.numpy() == np.asarray(want[1])).all()
    assert torch.equal(counts, plain[0]) and torch.equal(idx, plain[1])
    assert int(counts.sum()) == total


# ------------------------------------------------------ sentinels and pads
@pytest.mark.parametrize("kind", ["sentinel", "pad"])
def test_sentinel_and_pad_rows_never_match(kind):
    """A free slot (start = end = the empty key) and a legacy pad row
    (start the largest key, end the empty key) are ordinary rows of U and
    match no event: not the empty key, not the all-0xFF key at full width,
    not at revision 0."""
    width = 16
    lo = np.int32(-0x80000000)
    hi = np.int32(0x7FFFFFFF)
    start = np.full((3, width // 4), lo if kind == "sentinel" else hi,
                    np.int32)
    end = np.full((3, width // 4), lo, np.int32)
    ws, we = torch.from_numpy(start), torch.from_numpy(end)
    # one live unbounded watcher beside them, from the empty key on
    empty = torch.full((1, width // 4), int(lo), dtype=torch.int32)
    ws, we = torch.cat([ws, empty]), torch.cat([we, empty])
    unb = torch.tensor([False, False, False, True])
    mr = torch.zeros(4, dtype=torch.int64)
    keys = [b"", b"\xff" * width, b"/a", b"\x01"]
    ek = torch.from_numpy(tscan.flip_sign(tkeys.pack_keys(keys, width)[0]))
    er = torch.zeros(4, dtype=torch.int64)
    mask = tfanout.fanout_mask_rank_plain(ek, er, 4, ws, we, unb, mr)
    assert not mask[:, :3].any() and mask[:, 3].all()
    chunk = tfanout.fanout_mask_range(ek, er, ws, we, unb, mr)
    assert torch.equal(mask, chunk)


# ----------------------------------------------------- K4's emulated design
@pytest.mark.parametrize("resident", [1, 40, 1000])
@pytest.mark.parametrize("n_blocks", [1, 33, 100])
def test_lookback_offsets_are_the_exclusive_scan(n_blocks, resident):
    """The decoupled look-back finds every block's exclusive offset, with
    the blocks run one at a time, 40 at a time (windows of 32 walked past)
    and all at once."""
    rng = np.random.RandomState(n_blocks + resident)
    sums = rng.randint(0, 50, n_blocks).tolist()
    got = tfanout.lookback_offsets(sums, resident)
    assert got == np.concatenate([[0], np.cumsum(sums)[:-1]]).tolist()


@pytest.mark.parametrize("resident", [1, 2, 264])
@pytest.mark.parametrize("n_w,n_e,n_ev,size_frac", [
    (64, 8, 8, 2.0),       # two blocks of 32, E below one ballot
    (257, 96, 70, 0.5),    # many blocks, truncated
    (100, 64, 0, 1.0),     # no live event: every index is fill
    (300, 128, 128, 1.0),  # exact size
])
def test_ranked_emulation_equals_compact_flat(n_w, n_e, n_ev, size_frac,
                                              resident):
    """K4's design (ranks → count → look-back → ranked write), in plain
    PyTorch, equals the direct compaction of the rank-space mask, with
    truncation and fill, with the blocks run one, two (so that look-backs
    walk back over windows of aggregates) or all at a time."""
    case = make_case(n_w + n_e, n_w, n_e, 4)
    mask = torch.from_numpy(rank_mask(case, n_ev))
    total = int(mask.sum())
    size = max(int(total * size_frac), 1)
    counts, idx = tfanout.fanout_dispatch_ranked(
        *case.ev, n_ev, *case.table, size, resident=resident)
    assert torch.equal(counts, mask.sum(dim=1, dtype=torch.int32))
    assert torch.equal(idx, tfanout.compact_flat(mask.reshape(-1), size))
    assert (idx[min(size, total):] == n_w * n_e).all()


# ------------------------------------------------------- the wrappers (CPU)
def test_wrapper_builds_an_index_when_none_is_passed():
    case = make_case(5, 70, 24, 8)
    index = tfanout.rank_index_plain(*case.table[:2])
    a = fanout_kernels.fanout_dispatch(*case.ev, 20, *case.table, 512)
    b = fanout_kernels.fanout_dispatch(*case.ev, 20, *case.table, 512,
                                       index=index, with_total=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert b[2].tolist() == [int(a[0].sum())]
    m = fanout_kernels.fanout_mask_range(*case.ev, 20, *case.table)
    assert torch.equal(m, fanout_kernels.fanout_mask_range(
        *case.ev, 20, *case.table, index=index))


@pytest.mark.parametrize("wrong", ["width", "slots", "dtype"])
def test_an_index_that_does_not_fit_is_refused(wrong):
    """An index built at another width, for another table size or of
    another type would rank wrongly and silently: the wrappers raise."""
    case = make_case(6, 40, 16, 4)
    index = tfanout.rank_index_plain(*case.table[:2])
    if wrong == "width":
        other = make_case(6, 40, 16, 8)
        index = tfanout.rank_index_plain(*other.table[:2])
    elif wrong == "slots":
        index = tfanout.RankIndex(index.rows, index.rs[:-1], index.re[:-1])
    else:
        index = tfanout.RankIndex(index.rows.long(), index.rs, index.re)
    with pytest.raises(ValueError, match="rank index"):
        fanout_kernels.fanout_dispatch(*case.ev, 16, *case.table, 64,
                                       index=index)
    with pytest.raises(ValueError, match="rank index"):
        fanout_kernels.fanout_mask_range(*case.ev, 16, *case.table,
                                         index=index)


# ------------------------------------------- the matchers over the index
def _events(keys, rev0=20):
    return [WatchEvent(revision=rev0 + i, key=k, value=b"v")
            for i, k in enumerate(keys)]


def _jevents(keys, rev0=20):
    return [JWatchEvent(revision=rev0 + i, key=k, value=b"v")
            for i, k in enumerate(keys)]


def _want(events, specs):
    mask = match_oracle(events, specs)
    out = {}
    for j, (wid, *_r) in enumerate(specs):
        hits = [events[i].revision for i in np.flatnonzero(mask[:, j])]
        if hits:
            out[wid] = hits
    return out


def _revs(d):
    return {w: [e.revision for e in evs] for w, evs in d.items()}


def _kube_specs(rng, n, wid0=0):
    specs = []
    for w in range(n):
        ns = b"/registry/pods/ns%02d/" % rng.randint(8)
        roll = rng.rand()
        if roll < 0.1:
            k = ns + b"o%02d" % rng.randint(20)
            specs.append((wid0 + w, k, k + b"\x00", int(rng.randint(0, 30))))
        elif roll < 0.2:
            specs.append((wid0 + w, b"/registry/", b"", 0))
        else:
            specs.append((wid0 + w, ns, prefix_end(ns),
                          int(rng.randint(0, 30))))
    return specs


def _kube_keys(rng, n):
    return [b"/registry/pods/ns%02d/o%02d" % (rng.randint(8), rng.randint(20))
            for _ in range(n)]


def index_fits(table) -> tfanout.RankIndex:
    """The table's rank index names each slot's own bound rows, its rows
    are sorted and distinct, and the table's host copy of them is theirs;
    returns it."""
    ws, we, _u, _r, index, _wids, _v = table.ranked_view()
    rows = [tuple(r) for r in index.rows.tolist()]
    assert rows == sorted(set(rows))
    assert (table._index_keys == tfanout.row_keys(index.rows.numpy())).all()
    assert torch.equal(index.rows[index.rs.long()], ws)
    assert torch.equal(index.rows[index.re.long()], we)
    return index


@pytest.mark.parametrize("change", ["churn", "width", "capacity"])
def test_matcher_keeps_the_index_with_the_table(change):
    """The table's rank index follows its columns in the publication step:
    updated after a churn sync (dirty rows), rebuilt after a width growth
    (an event key past the packed width) and a capacity growth; deliveries
    then equal match_oracle and the JAX matcher's."""
    rng = np.random.RandomState(11)
    specs = _kube_specs(rng, 70)
    port = DeviceFanout(device="cpu")
    keys = _kube_keys(rng, 12)
    assert _revs(port.deliver(_events(keys), specs, 1)) == _want(
        _events(keys), specs)
    stats0 = port.table.stats()
    view0 = port.table.ranked_view()[4]
    if change == "churn":
        specs = specs[::2] + _kube_specs(rng, 10, wid0=500)
    elif change == "width":
        keys = keys + [b"/registry/pods/ns01/" + b"x" * 60]
    else:
        specs = specs + _kube_specs(rng, 100, wid0=1000)
    got = port.deliver(_events(keys), specs, 2)
    stats = port.table.stats()
    rebuilt = change != "churn"
    assert stats["index_builds"] == stats0["index_builds"] + rebuilt
    assert stats["index_updates"] == stats0["index_updates"] + (not rebuilt)
    index = index_fits(port.table)
    assert index is not view0
    ws, we = port.table.device_view()[:2]
    fresh = tfanout.rank_index_plain(ws, we)
    if rebuilt:
        assert all(torch.equal(a, b) for a, b in zip(index, fresh))
    else:  # rows no slot holds any more stay until the next rebuild
        assert {tuple(r) for r in fresh.rows.tolist()} <= {
            tuple(r) for r in index.rows.tolist()}
    if change == "width":
        assert stats["width"] > stats0["width"]
        assert index.rows.shape[1] == stats["width"] // 4
    if change == "capacity":
        assert stats["capacity"] > stats0["capacity"]
        assert index.rs.shape[0] == stats["capacity"]
    want = _want(_events(keys), specs)
    assert _revs(got) == want
    jgot = JDeviceFanout().deliver(_jevents(keys), specs, version=2)
    assert _revs(jgot) == want
    # an unchanged table publishes nothing and keeps its index
    port.deliver(_events(keys), specs, 2)
    assert port.table.ranked_view()[4] is index


# ------------------------------------------------- the index under churn
@pytest.mark.parametrize("chunks", [1, 4, 16])
def test_row_keys_order_is_the_rows_order(chunks):
    """The host copy of the index's rows: byte strings that numpy sorts
    and searches in the rows' key order (first chunk first, signed)."""
    case = make_case(300 + chunks, 40, 30, chunks)
    rows = torch.cat([*case.table[:2], case.ev[0]]).numpy()
    keys = tfanout.row_keys(rows)
    want = sorted(range(len(rows)), key=lambda i: (tuple(rows[i]), i))
    assert np.argsort(keys, kind="stable").tolist() == want
    u = tfanout.rank_index_plain(*case.table[:2]).rows.numpy()
    assert (np.searchsorted(tfanout.row_keys(u), tfanout.row_keys(
        case.ev[0].numpy()), side="right") == tfanout.event_ranks_plain(
        case.ev[0], 30, tfanout.rank_index_plain(*case.table[:2])).numpy()
    ).all()


@pytest.mark.parametrize("where", ["front", "middle", "back", "repeated",
                                   "present", "mixed"])
def test_rank_index_update_inserts_each_new_row_at_its_place(where):
    """``rank_index_update`` puts the rows not in U yet at their place
    (before every row, between rows, past every row, a new row named by
    several slots, no new row at all, all of these at once): U is then
    the sorted union of the old rows and the new, each slot names its own
    rows, and the slots not changed keep theirs."""
    rng = np.random.RandomState(len(where))
    width = 16
    mid = [b"/m/%02d" % i for i in range(0, 40, 2)]
    specs = [(w, k, k + b"\x00", 0) for w, k in enumerate(mid)]
    case = Case(specs, [b"/m/00"], [0], width)
    ws, we = (t.clone() for t in case.table[:2])
    index = tfanout.rank_index_plain(ws, we)
    new = {"front": [b"/a", b"/b"], "middle": [b"/m/05", b"/m/051"],
           "back": [b"/z", b"\xff" * 12], "repeated": [b"/m/07"] * 2,
           "present": [b"/m/04", b"/m/04\x01"],
           "mixed": [b"/a", b"/m/04", b"/m/07", b"/z"]}[where]
    slots = np.sort(rng.choice(len(mid), len(new), replace=False))
    starts = tscan.flip_sign(tkeys.pack_keys(new, width)[0])
    ends = tscan.flip_sign(tkeys.pack_keys(
        [jkeys.canonicalize_bound(k + b"\x00") for k in new], width)[0])
    cand = torch.from_numpy(np.concatenate([starts, ends]))
    keys = tfanout.row_keys(index.rows.numpy())
    got, got_keys = tfanout.rank_index_update(index, keys, slots, starts,
                                              ends)
    assert (got_keys == tfanout.row_keys(got.rows.numpy())).all()
    ws[slots], we[slots] = torch.from_numpy(starts), torch.from_numpy(ends)
    rows = [tuple(r) for r in got.rows.tolist()]
    old = {tuple(r) for r in index.rows.tolist()}
    assert rows == sorted(old | {tuple(r) for r in cand.tolist()})
    assert torch.equal(got.rows[got.rs.long()], ws)
    assert torch.equal(got.rows[got.re.long()], we)
    assert got.rs.dtype == got.re.dtype == got.rows.dtype == torch.int32
    # the published index is never written
    assert torch.equal(index.rows[index.rs.long()], case.table[0])


@pytest.mark.parametrize("width", [4, 8, 16, 64])
def test_table_index_under_random_churn(width):
    """A pinned-width table through 60 random watcher-set changes (new
    watchers, unwatches, min_rev changes, bounds that come and go): after
    each publication its index fits it, and K4's emulation over it equals
    the chunk-compare dispatch and match_oracle on events at and beside
    the bounds."""
    rng = np.random.RandomState(width)
    lim = width - 2
    port = DeviceFanout(width=width, device="cpu")
    live: dict = {}
    for step in range(60):
        for _ in range(rng.randint(1, 5)):
            roll = rng.rand()
            if live and roll < 0.3:
                del live[list(live)[rng.randint(len(live))]]
            elif live and roll < 0.45:
                w = list(live)[rng.randint(len(live))]
                s, e, r = live[w]
                live[w] = (s, e, r + 1)
            else:
                (_w, s, e, r), = population(rng, 1, width)
                live[1000 * step + len(live)] = (s[:lim], e[:lim], r)
        specs = [(w, *v) for w, v in sorted(live.items())]
        port.table.sync(specs, version=step)
        index = index_fits(port.table)
        if not specs:
            continue
        keys = event_keys(rng, 24, specs, width)
        events = _events(keys, rev0=0)
        got = port.deliver(events, specs, step)
        assert _revs(got) == _want(events, specs)
        ws, we, wu, wr = port.table.device_view()[:4]
        case = Case(specs, keys, [ev.revision for ev in events], width)
        ek = case.ev[0]
        er = case.ev[1]
        a = tfanout.fanout_dispatch_plain(ek, er, 20, ws, we, wu, wr, 200)
        b = tfanout.fanout_dispatch_ranked(ek, er, 20, ws, we, wu, wr, 200,
                                           index=index, resident=2)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert port.table.stats()["index_updates"] > 30


def test_a_min_rev_change_leaves_the_index():
    """A change of min_rev alone publishes its row and keeps the index:
    the bounds, and so every rank, are the same."""
    rng = np.random.RandomState(3)
    specs = _kube_specs(rng, 40)
    table = DeviceFanout(device="cpu").table
    table.sync(specs, version=1)
    index = index_fits(table)
    stats = table.stats()
    specs = [(w, s, e, r + 7) for w, s, e, r in specs]
    table.sync(specs, version=2)
    assert table.ranked_view()[4] is index
    after = table.stats()
    assert after["index_updates"] == stats["index_updates"]
    assert after["index_builds"] == stats["index_builds"]
    assert table.device_view()[3].tolist()[:40] == [r for *_x, r in specs]


def test_the_index_is_rebuilt_past_its_slack():
    """Rows no slot holds any more pile up in the index until it holds
    ``INDEX_SLACK`` rows per slot of capacity; then the publication
    rebuilds it from the live rows alone."""
    from kubebrain_tpu_torch.fanout.table import INDEX_SLACK

    table = DeviceFanout(device="cpu").table
    cap = table.stats()["capacity"]
    builds = None
    for step in range(2 * INDEX_SLACK * cap):
        key = b"/registry/pods/ns/o%05d" % step
        table.sync([(step, key, key + b"\x00", 0)], version=step)
        index_fits(table)
        stats = table.stats()
        builds = stats["index_builds"] if builds is None else builds
        assert stats["index_rows"] <= INDEX_SLACK * cap
    assert table.stats()["index_builds"] > builds
    assert table.stats()["capacity"] == cap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_fanout_under_churn_equals_the_jax_matcher(seed):
    """The block path through ten watcher-set changes, some with new
    single-key bounds, some re-watches of the same ranges, some unwatches:
    every block's deliveries equal match_oracle and the JAX DeviceFanout's
    on the same specs and events."""
    rng = np.random.RandomState(20 + seed)
    specs = _kube_specs(rng, 60)
    port = DeviceFanout(device="cpu")
    jax_matcher = JDeviceFanout()
    wid = 5000
    for version in range(10):
        keys = _kube_keys(rng, 16)
        want = _want(_events(keys), specs)
        assert _revs(port.deliver(_events(keys), specs, version)) == want
        assert _revs(jax_matcher.deliver(_jevents(keys), specs,
                                         version=version)) == want
        index_fits(port.table)
        drop = set(rng.choice(len(specs), 6, replace=False).tolist())
        again = [(wid + i, *specs[j][1:]) for i, j in enumerate(sorted(drop))]
        specs = ([sp for j, sp in enumerate(specs) if j not in drop]
                 + again[:3] + _kube_specs(rng, 3, wid0=wid + 100))
        wid += 1000
    assert port.table.stats()["index_updates"] >= 9


def test_legacy_matcher_over_the_index():
    """The legacy FanoutMatcher ranks its events against the index of its
    cached table, rebuilt when the watcher set changes; its mask equals
    match_oracle and the JAX FanoutMatcher's."""
    rng = np.random.RandomState(12)
    specs = _kube_specs(rng, 90)
    port = tfanout.FanoutMatcher(device="cpu")
    jmatcher = jfanout.FanoutMatcher()
    for version in (1, 2):
        keys = _kube_keys(rng, 11)
        got = port(_events(keys), specs, version=version)
        assert (got == match_oracle(_events(keys), specs)).all()
        assert (got == np.asarray(jmatcher(_jevents(keys), specs))).all()
        ws, we = port._cached[:2]
        assert all(torch.equal(a, b) for a, b in zip(
            port._index, tfanout.rank_index_plain(ws, we)))
        first = port._index
        specs = specs[1:] + _kube_specs(rng, 3, wid0=900 + version)
    port(_events(keys), specs, version=3)
    assert port._index is not first


# --------------------------------------------------------------- property
@st.composite
def populations(draw):
    chunks = draw(st.sampled_from([1, 2, 4]))
    width = 4 * chunks
    key = st.binary(max_size=width - 2).map(
        lambda b: b.replace(b"\x00", b"\x01"))
    spec = st.tuples(key, st.one_of(key, st.just(b""),
                                    key.map(lambda k: k + b"\x00")),
                     st.integers(0, 5))
    specs = [(w, s, e, r) for w, (s, e, r) in
             enumerate(draw(st.lists(spec, min_size=1, max_size=12)))]
    ev_key = st.binary(max_size=width).map(
        lambda b: b.replace(b"\x00", b"\x01"))
    events = draw(st.lists(st.tuples(ev_key, st.integers(0, 6)), min_size=1,
                           max_size=12))
    return specs, events, width


@settings(max_examples=60, deadline=None)
@given(populations())
def test_rank_space_property(pop):
    """For any population and block: rank space == chunk compare ==
    match_oracle."""
    specs, events, width = pop
    case = Case(specs, [k for k, _r in events], [r for _k, r in events],
                width)
    got = rank_mask(case, len(events))
    chunk = tfanout.fanout_mask_range_wmajor(*case.ev, *case.table).numpy()
    assert (got == chunk).all() and (got == case.oracle()).all()
