"""The port's plain PyTorch fan-out (kubebrain_tpu_torch.ops.fanout) on the
CPU against the JAX package's jnp programs: the E-major and watcher-major
range masks (J5 and J4's compare), the block dispatch with its compaction
(J4), and ``_compact``; K4's own algorithm in plain PyTorch (count →
exclusive offsets → ranked write) against the direct plain version; and
the edge cases of the kernels' match rule through the port's matcher, the
JAX matcher and the raw-bytes oracle. Inputs are made from a numpy seed:
the JAX side gets uint32 chunks and hi/lo revisions, the port sign-flipped
int32 chunks and int64 revisions. Masks, counts and indices are integers,
so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubebrain_tpu.backend.common import WatchEvent as JWatchEvent
from kubebrain_tpu.fanout import dispatch as jdispatch
from kubebrain_tpu.fanout.matcher import DeviceFanout as JDeviceFanout
from kubebrain_tpu.ops import fanout as jfanout
from kubebrain_tpu.ops import keys as jkeys
from kubebrain_tpu_torch.backend.common import WatchEvent
from kubebrain_tpu_torch.fanout import DeviceFanout, WatcherTable, match_oracle
from kubebrain_tpu_torch.ops import fanout as tfanout
from kubebrain_tpu_torch.ops import fanout_kernels
from kubebrain_tpu_torch.ops import keys as tkeys
from kubebrain_tpu_torch.ops import scan as tscan



def one_slot_view(table) -> tuple:
    """A one-slot table's published ``(starts, ends, unbounded, min_rev,
    index, wids, version)``."""
    (shard,), wids, version = table.shard_views()
    return (*shard[1:], wids, version)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread, so that the test
    run's parallel workers do not oversubscribe the cores (with every
    worker's threads spinning, a small op can take a hundred times
    longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SEGMENTS = (b"pods", b"leases", b"ns-00", b"ns-01", b"ns-02", b"obj-1",
            b"obj-2", b"a", b"b", b"~")


def random_key(rng, max_len):
    """A NUL-free key under /r/ of at most ``max_len`` bytes, made of a few
    shared segments so that keys often share prefixes or equal a bound."""
    parts = [SEGMENTS[rng.randint(len(SEGMENTS))]
             for _ in range(rng.randint(1, 5))]
    return (b"/r/" + b"/".join(parts))[:max_len]


def population(rng, n_w, max_len, rev_hi):
    """Watcher specs (wid, start, end, min_rev) of every shape the hub
    holds: prefix ranges, single-key watches (end = key + NUL), unbounded
    from-key watches, arbitrary (possibly empty or inverted) ranges, and
    bounded empty ranges (the never-match sentinel's shape)."""
    specs = []
    for w in range(n_w):
        k = random_key(rng, max_len - 2)
        roll = rng.rand()
        if roll < 0.3:
            start, end = k, k[:-1] + bytes([k[-1] + 1])
        elif roll < 0.45:
            start, end = k, k + b"\x00"
        elif roll < 0.6:
            start, end = k, b""
        elif roll < 0.9:
            start, end = k, random_key(rng, max_len - 2)
        else:
            start, end = b"", b""
        specs.append((w, start, end, int(rng.randint(0, rev_hi))))
    return specs


def event_keys(rng, n_e, max_len, specs):
    """Event keys, a third of them equal to some watcher's start or end."""
    keys = []
    for _ in range(n_e):
        roll = rng.rand()
        _w, s, e, _r = specs[rng.randint(len(specs))]
        if roll < 0.15 and s:
            keys.append(s)
        elif roll < 0.3 and e and b"\x00" not in e:
            keys.append(e)
        else:
            keys.append(random_key(rng, max_len))
    return keys


class Case:
    """One packed block and watcher table, for both packages."""

    def __init__(self, specs, keys, revs, width):
        self.specs, self.keys, self.revs = specs, keys, revs
        starts = [jkeys.canonicalize_bound(s) for _, s, _, _ in specs]
        ends = [jkeys.canonicalize_bound(e) for _, _, e, _ in specs]
        unb = np.array([not e for _, _, e, _ in specs])
        min_rev = np.array([r for *_x, r in specs], dtype=np.uint64)
        revs = np.asarray(revs, dtype=np.uint64)
        ek_j, _ = jkeys.pack_keys(keys, width)
        ws_j, _ = jkeys.pack_keys(starts, width)
        we_j, _ = jkeys.pack_keys(ends, width)
        ehi, elo = jkeys.split_revs(revs)
        whi, wlo = jkeys.split_revs(min_rev)
        self.jax = (jnp.asarray(ek_j), jnp.asarray(ehi), jnp.asarray(elo),
                    jnp.asarray(ws_j), jnp.asarray(we_j), jnp.asarray(unb),
                    jnp.asarray(whi), jnp.asarray(wlo))
        ek_t, _ = tkeys.pack_keys(keys, width)
        ws_t, _ = tkeys.pack_keys(starts, width)
        we_t, _ = tkeys.pack_keys(ends, width)
        flip = lambda a: torch.from_numpy(tscan.flip_sign(a))
        self.ev = (flip(ek_t), torch.from_numpy(tfanout.revisions(revs)))
        self.table = (flip(ws_t), flip(we_t), torch.from_numpy(unb),
                      torch.from_numpy(tfanout.revisions(min_rev)))

    def jax_dispatch(self, n_ev, size):
        ek, ehi, elo, ws, we, wu, whi, wlo = self.jax
        counts, idx = jdispatch.fanout_dispatch(
            ek, ehi, elo, np.int32(n_ev), ws, we, wu, whi, wlo, size=size)
        return np.asarray(counts), np.asarray(idx)


def random_case(seed, n_w, n_e, width):
    rng = np.random.RandomState(seed)
    specs = population(rng, n_w, width, 300)
    keys = event_keys(rng, n_e, width, specs)
    revs = rng.randint(0, 300, n_e)
    # some revisions exactly at a watcher's min_rev, some one below
    for i in range(0, n_e, 7):
        r = specs[rng.randint(n_w)][3]
        revs[i] = max(r - (i // 7) % 2, 0)
    return Case(specs, keys, revs, width)


def oracle_mask(case):
    evs = [JWatchEvent(revision=int(r), key=k)
           for k, r in zip(case.keys, case.revs)]
    return match_oracle(evs, case.specs)


@pytest.mark.parametrize("width", [32, 64, 128, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_match_jax_and_oracle(seed, width):
    """fanout_mask_range (E-major, J5) and fanout_mask_range_wmajor (J4's
    compare) against jnp and the raw-bytes oracle, C = 8 to 64."""
    case = random_case(seed, 96, 80, width)
    got_e = tfanout.fanout_mask_range(*case.ev, *case.table).numpy()
    got_w = tfanout.fanout_mask_range_wmajor(*case.ev, *case.table).numpy()
    want_e = np.asarray(jfanout.fanout_mask_range(*case.jax))
    want_w = np.asarray(jfanout.fanout_mask_range_wmajor(*case.jax))
    assert got_e.shape == (80, 96) and got_w.shape == (96, 80)
    assert (got_e == want_e).all() and (got_w == want_w).all()
    assert (got_e == oracle_mask(case)).all()
    assert 0 < got_e.sum() < got_e.size


@pytest.mark.parametrize("size_mode", ["below", "at", "above"])
@pytest.mark.parametrize("n_ev_mode", ["all", "padded"])
@pytest.mark.parametrize("seed", [3, 4])
def test_dispatch_matches_jax(seed, n_ev_mode, size_mode):
    """J4: counts and compacted indices of the plain dispatch and of K4's
    ranked algorithm against the JAX dispatch, with E-padding masked by
    n_ev and ``size`` below, at and above the total."""
    case = random_case(seed, 70, 64, 64)
    n_ev = 64 if n_ev_mode == "all" else 41
    total = int(jfanout.fanout_mask_range_wmajor(*case.jax)[:, :n_ev].sum())
    size = {"below": total // 3, "at": total, "above": 2 * total + 5}[size_mode]
    want_counts, want_idx = case.jax_dispatch(n_ev, size)
    for fn in (tfanout.fanout_dispatch_plain, tfanout.fanout_dispatch_ranked,
               fanout_kernels.fanout_dispatch):
        counts, idx = fn(*case.ev, n_ev, *case.table, size)
        assert counts.dtype == idx.dtype == torch.int32
        assert (counts.numpy() == want_counts).all(), fn.__name__
        assert (idx.numpy() == want_idx).all(), fn.__name__
    assert int(want_counts.sum()) == total


@pytest.mark.parametrize("size_mode", ["below", "at", "above"])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_compact_matches_jax(density, size_mode):
    """``compact_flat`` against JAX's ``_compact`` over densities 0,
    sparse, half and full, ``size`` below, at and above the total."""
    rng = np.random.RandomState(int(density * 100) + 7)
    flat = rng.rand(2048) < density
    total = int(flat.sum())
    size = {"below": max(total // 2, 1), "at": max(total, 1),
            "above": total + 100}[size_mode]
    got = tfanout.compact_flat(torch.from_numpy(flat), size).numpy()
    want = np.asarray(jdispatch._compact(jnp.asarray(flat), size))
    assert got.dtype == np.int32 and (got == want).all()
    k = min(size, total)
    assert (got[:k] == np.flatnonzero(flat)[:k]).all() and (got[k:] == 2048).all()


@pytest.mark.parametrize("n_w,n_e,n_ev,size_frac", [
    (64, 8, 8, 2.0),       # E below one ballot
    (33, 64, 37, 1.0),     # W one past a block, n_ev inside a ballot
    (100, 96, 96, 0.5),    # truncated
    (31, 40, 0, 1.0),      # no real event: every index is fill
    (257, 128, 100, 0.9),  # many blocks, truncated by a little
    (96, 512, 300, 3.0),   # the EVENT_BATCH drain depth in a 512 bucket
])
def test_ranked_algorithm_matches_plain(n_w, n_e, n_ev, size_frac):
    """K4's count → exclusive offsets → ranked write, in plain PyTorch,
    equals the direct compaction: the same counts and the same indices,
    truncation and fill included."""
    case = random_case(n_w + n_e, n_w, n_e, 64)
    counts, _ = tfanout.fanout_dispatch_plain(*case.ev, n_ev, *case.table, 1)
    size = max(int(int(counts.sum()) * size_frac), 1)
    a = tfanout.fanout_dispatch_plain(*case.ev, n_ev, *case.table, size)
    b = tfanout.fanout_dispatch_ranked(*case.ev, n_ev, *case.table, size)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[1][min(size, int(counts.sum())):] == n_w * n_e).all()


def test_mask_wrapper_masks_padding_events():
    """K5's wrapper on the CPU: rows at and past n_ev are all False, the
    rest equal jnp's E-major mask."""
    case = random_case(9, 64, 16, 64)
    got = fanout_kernels.fanout_mask_range(*case.ev, 11, *case.table).numpy()
    want = np.asarray(jfanout.fanout_mask_range(*case.jax))
    assert (got[:11] == want[:11]).all() and not got[11:].any()


def test_int32_flat_index_overflow_raises():
    """W * E >= 2^31 would wrap the JAX package's int32 flat index
    silently; the wrapper refuses it on every device (meta tensors: no
    memory is allocated)."""
    meta = torch.device("meta")
    ek = torch.empty((4096, 16), dtype=torch.int32, device=meta)
    er = torch.empty(4096, dtype=torch.int64, device=meta)
    ws = torch.empty((524_288, 16), dtype=torch.int32, device=meta)
    wu = torch.empty(524_288, dtype=torch.bool, device=meta)
    wr = torch.empty(524_288, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="int32 flat index"):
        fanout_kernels.fanout_dispatch(ek, er, 4096, ws, ws, wu, wr, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        fanout_kernels.fanout_dispatch(ek[:8], er[:8], 8, ws[:64], ws[:64],
                                       wu[:64], wr[:64], 128)


def test_revision_past_int64_is_rejected():
    with pytest.raises(ValueError, match="2\\^63"):
        tfanout.revisions([2**63])
    table = WatcherTable(device="cpu")
    with pytest.raises(ValueError, match="2\\^63"):
        table.sync([(1, b"/a", b"/b", 2**63)], version=1)


# ------------------------------------------------------- edge cases, three ways
BASE = b"/registry/pods/ns-001/obj-00007"


def _ev(rev, key):
    return rev, key


EDGE_CASES = {
    # an event key equal to a start (matches) and to an end (does not)
    "key_equals_start": ([(1, BASE, BASE + b"9", 0)],
                         [_ev(10, BASE), _ev(11, BASE + b"8")]),
    "key_equals_end": ([(1, b"/registry/pods/", BASE, 0)],
                       [_ev(10, BASE), _ev(11, BASE[:-1])]),
    # single-key watch: end = key + NUL, canonicalized for the padded compare
    "nul_bound_single_key": ([(1, BASE, BASE + b"\x00", 0),
                              (2, BASE + b"\x00", b"", 0)],
                             [_ev(10, BASE), _ev(11, BASE + b"0"),
                              _ev(12, BASE + b"\x01")]),
    # rev == min_rev matches, rev == min_rev - 1 does not
    "revision_at_min_rev": ([(1, b"/registry/", b"", 20),
                             (2, b"/registry/", b"/registry0", 21)],
                            [_ev(19, BASE), _ev(20, BASE), _ev(21, BASE)]),
    # 5 events in an 8 bucket: the padding's empty key at revision 0 must
    # not reach the unbounded min_rev = 0 watchers
    "padding_events": ([(1, b"", b"", 0), (2, b"", b"", 0),
                        (3, b"/registry/pods/", b"", 0)],
                       [_ev(10 + i, BASE + b"%d" % i) for i in range(5)]),
    # a 200-byte key grows the packed width to 256 bytes (C = 64)
    "key_of_200_bytes": ([(1, b"/registry/", b"", 0),
                          (2, b"/registry/pods/", b"/registry/pods0", 0)],
                         [_ev(10, b"/registry/pods/" + b"x" * 185),
                          _ev(11, BASE)]),
}


def _three_ways(specs, events_raw):
    t_events = [WatchEvent(revision=r, key=k, value=b"v") for r, k in events_raw]
    j_events = [JWatchEvent(revision=r, key=k, value=b"v")
                for r, k in events_raw]
    port = DeviceFanout(device="cpu")
    got = port.deliver(t_events, specs, version=1)
    jgot = JDeviceFanout().deliver(j_events, specs, version=1)
    mask = match_oracle(t_events, specs)
    want = {}
    for j, (wid, *_r) in enumerate(specs):
        hits = [events_raw[i][0] for i in np.flatnonzero(mask[:, j])]
        if hits:
            want[wid] = hits
    revs = lambda d: {w: [e.revision for e in evs] for w, evs in d.items()}
    assert revs(got) == want == revs(jgot)
    assert (port(t_events, specs, version=1) == mask).all()
    return port, want


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_case_port_jax_and_oracle_agree(name):
    specs, events = EDGE_CASES[name]
    port, want = _three_ways(specs, events)
    if name == "key_of_200_bytes":
        assert port.table.width == 256
    if name == "padding_events":
        assert sum(len(v) for v in want.values()) == 15


def test_edge_case_freed_slots_after_churn():
    """Slots freed by a churn sync hold the sentinel (start = end = the
    empty key, bounded): they match nothing, even unbounded-looking
    events at revision 0, and their wids read -1."""
    specs = [(w, b"/registry/", b"", 0) for w in range(40)]
    events = [_ev(10 + i, BASE + b"%d" % i) for i in range(6)]
    port = DeviceFanout(device="cpu")
    port.deliver([WatchEvent(revision=r, key=k) for r, k in events], specs, 1)
    kept = specs[::3]
    _ws, _we, _wu, _wr, _index, wids, _v = one_slot_view(port.table)
    port.table.sync(kept, version=2)
    ws, we, wu, wr, _index, wids, _v = one_slot_view(port.table)
    freed = [slot for slot in range(len(wids)) if wids[slot] < 0]
    assert len(freed) == len(wids) - len(kept)
    ek = torch.from_numpy(tscan.flip_sign(
        tkeys.pack_keys([b"", BASE], port.table.width)[0]))
    counts, _idx = tfanout.fanout_dispatch_plain(
        ek, torch.tensor([0, 5]), 2, ws, we, wu, wr, 64)
    live = torch.from_numpy(wids >= 0)
    # the empty key at revision 0 matches no kept watcher either
    assert not counts[freed].any() and (counts[live] == 1).all()
    _three_ways(kept, events)


def test_edge_case_truncation_regrows():
    """A size below the total: the dispatch is truncated (the counts say
    so), and the matcher re-dispatches with a doubled bucket."""
    specs = [(w, b"/registry/", b"", 0) for w in range(64)]
    events = [_ev(10 + i, BASE + b"%d" % i) for i in range(30)]
    port = DeviceFanout(device="cpu")
    port._idx_size = 16
    got = port.deliver([WatchEvent(revision=r, key=k) for r, k in events],
                       specs, version=1)
    assert port.stats["redispatches"] == 1 and port._idx_size == 2048
    assert all([e.revision for e in evs] == [r for r, _k in events]
               for evs in got.values()) and len(got) == 64
