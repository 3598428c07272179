"""Watch fan-out in plain PyTorch: the range-match masks, the block
dispatch's compaction, and the legacy per-batch matcher.

Counterpart of ``kubebrain_tpu/ops/fanout.py:46-218`` and of the jnp
program of ``kubebrain_tpu/fanout/dispatch.py:68-125``. These are the CPU
path and the oracle the CUDA kernels of ``csrc/fanout_match.cu`` (K4, K5;
wrappers in ``ops/fanout_kernels.py``) are held to.

Layout, the scan path's (``ops/scan.py``):

- event keys ``int32[E, C]`` and watcher bounds ``int32[W, C]``: big-endian
  uint32 chunks with the sign bit flipped (``scan.flip_sign``), so a signed
  compare is unsigned byte order;
- revisions one ``int64`` column (no 31-bit hi/lo split); 2**63 and above
  are rejected where they are packed;
- ``w_unbounded bool[W]``: the watcher ignores its end bound.

A watcher w matches an event e when ``start[w] <= key[e]`` and
(``unbounded[w]`` or ``key[e] < end[w]``) and ``rev[e] >= min_rev[w]``
(etcd watch semantics). A never-match row is a bounded empty range: end =
the all-zero key, which flipped is INT_MIN in every chunk, and no key is
below it.

Rank space (what K4 and K5 compute in): the bound rows change only with the
watcher set, so a :class:`RankIndex` sorts the table's distinct bound rows
once, ``U``, and gives each slot the ranks of its start and end in ``U``.
An event key's rank ``r(k)`` is the number of rows of ``U`` that are ``<=
k``; then ``start <= k`` iff ``r(k) > rs`` and ``k < end`` iff ``r(k) <=
re``, so a pair costs three integer compares, exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import keys as keyops
from . import scan
from ..device import _host_pull, resolve_device
from ..trace import TRACER

#: flat indices are int32, as in the JAX package: a dispatch over more than
#: this many (watcher, event) pairs would wrap there, and raises here
MAX_FLAT = 2**31 - 1

#: K4's structure (csrc/fanout_match.cu): a block of 8 warps takes 32
#: watcher slots, 4 per warp, and a warp compares 32 events per ballot
WATCHERS_PER_BLOCK = 32
LANES = 32


def pow2_at_least(n: int, lo: int = 1) -> int:
    """The smallest power-of-two multiple of ``lo`` that is at least ``n``
    (the buckets of event blocks, index transfers and table widths)."""
    b = lo
    while b < n:
        b *= 2
    return b


def revisions(revs) -> np.ndarray:
    """Revisions → int64, rejecting what one int64 column cannot hold (the
    check ``scan.prepare_layout`` makes for the mirror)."""
    r = np.asarray(revs, dtype=np.uint64)
    if r.size and int(r.max()) >= 2**63:
        raise ValueError("revision exceeds 2^63")
    return r.astype(np.int64)


def fanout_mask_range_wmajor(ev_keys: torch.Tensor, ev_revs: torch.Tensor,
                             w_start: torch.Tensor, w_end: torch.Tensor,
                             w_unbounded: torch.Tensor,
                             w_min_rev: torch.Tensor) -> torch.Tensor:
    """bool[W, E]: watcher-major delivery mask (``fanout_mask_range_wmajor``
    of the JAX package). The events are the scan's rows (one partition,
    chunk-major) and the watchers its queries, so ``scan.lex_less`` gives
    the compare for the whole block."""
    e, c = ev_keys.shape
    rows = ev_keys.t().reshape(1, c, e)
    ge = ~scan.lex_less(rows, w_start)[:, 0]                        # [W, E]
    lt = scan.lex_less(rows, w_end)[:, 0]
    rev_ok = w_min_rev.view(-1, 1) <= ev_revs.view(1, -1)
    return ge & (w_unbounded.to(torch.bool).view(-1, 1) | lt) & rev_ok


def fanout_mask_range(ev_keys, ev_revs, w_start, w_end, w_unbounded,
                      w_min_rev) -> torch.Tensor:
    """bool[E, W]: the event-major mask of the legacy matcher (J5,
    ``fanout_mask_range`` of the JAX package)."""
    return fanout_mask_range_wmajor(ev_keys, ev_revs, w_start, w_end,
                                    w_unbounded, w_min_rev).t().contiguous()


class RankIndex(NamedTuple):
    """The rank index of a watcher table (see the module docstring)."""

    rows: torch.Tensor  # int32[n_u, C]: the distinct bound rows, ascending
    rs: torch.Tensor    # int32[W]: each slot's start, as an index into rows
    re: torch.Tensor    # int32[W]: each slot's end, as an index into rows


def rank_index_plain(w_start: torch.Tensor, w_end: torch.Tensor) -> RankIndex:
    """The rank index of bound rows ``int32[W, C]`` (sign-flipped, so the
    order of signed chunks, first chunk first, is key order), on their
    device: C stable sorts of the 2W rows from the last chunk to the first,
    flags where a row differs from the one before it, and the inverse
    permutation. Every row is in ``U``, the sentinel and pad rows too: a
    free slot (start = end = the empty key) and a legacy pad row (start
    the largest key, end the empty key) rank so that nothing matches."""
    w, c = w_start.shape
    both = torch.cat([w_start, w_end])
    dev = both.device
    perm = torch.arange(2 * w, device=dev)
    for ci in range(c - 1, -1, -1):
        perm = perm[torch.sort(both[perm, ci], stable=True)[1]]
    srt = both[perm]
    new = torch.ones(2 * w, dtype=torch.bool, device=dev)
    new[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    rank = torch.empty(2 * w, dtype=torch.int32, device=dev)
    rank[perm] = (torch.cumsum(new, 0) - 1).to(torch.int32)
    return RankIndex(srt[new].contiguous(), rank[:w].contiguous(),
                     rank[w:].contiguous())


def row_keys(rows: np.ndarray) -> np.ndarray:
    """Sign-flipped bound rows ``int32[N, C]`` as ``N`` byte strings of
    ``4C`` bytes (the packed keys) whose byte order is the rows' key order:
    the host's copy of ``RankIndex.rows``, searched with numpy."""
    keys = (np.ascontiguousarray(rows).view(np.uint32)
            ^ np.uint32(0x80000000)).astype(">u4")
    return keys.view(f"S{4 * rows.shape[1]}").reshape(-1)


def rank_index_update(index: RankIndex, keys: np.ndarray, slots: np.ndarray,
                      starts: np.ndarray, ends: np.ndarray
                      ) -> tuple[RankIndex, np.ndarray]:
    """The rank index, and its rows' :func:`row_keys` ``keys``, after the
    slots ``slots`` (int64[d]) took the bound rows ``starts`` and ``ends``
    (host ``int32[d, C]``).

    Each new row is looked up in ``keys`` on the host (an upper-bound
    search; a row already in ``U`` is the one just below its rank). A row
    not in ``U`` goes in at its rank, so every rank at or past it moves up
    by the rows inserted at or below it. A row that no slot holds any more
    stays in ``U``: it changes no answer, since a slot's ranks still name
    its own rows and an event's rank still counts the rows below it, so
    ``U`` only grows until the table rebuilds it. The device gets the slots
    and their ranks in one transfer (with the new rows and their places
    when rows go in); it is never waited on, and the published index is
    never written."""
    rows_u, rs, re = index
    dev = rows_u.device
    d = len(slots)
    cand = np.concatenate([starts, ends])
    ck = row_keys(cand)
    r = np.searchsorted(keys, ck, side="right")
    found = (r > 0) & (keys[np.maximum(r - 1, 0)] == ck)
    pos = r - 1                      # a found row's index in U
    miss = np.flatnonzero(~found)
    # what the device gets, in one int32 transfer: the slots (int64), their
    # ranks, then, when rows go in, their places (int64), the rows of U
    # below each (int32) and the new rows
    parts = [np.asarray(slots, dtype=np.int64).view(np.int32), None]
    if len(miss):
        # the new rows, sorted and distinct
        order = miss[np.argsort(ck[miss], kind="stable")]
        first = np.ones(len(order), dtype=bool)
        first[1:] = ck[order][1:] != ck[order][:-1]
        at = r[order][first]         # rows of U below each new row
        new_pos = at + np.arange(len(at))
        pos[found] += np.searchsorted(at, pos[found], side="right")
        pos[order] = new_pos[np.cumsum(first) - 1]
        keys = np.insert(keys, at, ck[order][first])
        parts += [new_pos.view(np.int32), at.astype(np.int32),
                  cand[order][first].reshape(-1)]
    parts[1] = pos.astype(np.int32)
    up = torch.from_numpy(np.concatenate(parts)).to(dev)
    at_slots = up[:2 * d].view(torch.int64)
    vals = up[2 * d:4 * d]
    if len(miss):
        k = len(at)
        new_at = up[4 * d:4 * d + 2 * k].view(torch.int64)
        at_dev = up[4 * d + 2 * k:4 * d + 3 * k]

        def moved(ix):
            return ix + torch.searchsorted(at_dev, ix, right=True,
                                           out_int32=True)

        n_u, c = rows_u.shape
        grown = torch.empty((n_u + k, c), dtype=torch.int32, device=dev)
        old = torch.arange(n_u, dtype=torch.int32, device=dev)
        grown.index_copy_(0, moved(old).long(), rows_u)
        grown.index_copy_(0, new_at, up[4 * d + 3 * k:].view(k, c))
        rows_u, rs, re = grown, moved(rs), moved(re)
    # out of place, so that the published columns stay as they are
    return (RankIndex(rows_u, rs.index_copy(0, at_slots, vals[:d]),
                      re.index_copy(0, at_slots, vals[d:])), keys)


def _rows_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[N]: row a[i] < row b[i] over the chunks of ``int32[N, C]``."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for ci in range(a.shape[1] - 1, -1, -1):
        x, y = a[:, ci], b[:, ci]
        less = (x < y) | ((x == y) & less)
    return less


def event_ranks_plain(ev_keys: torch.Tensor, n_ev: int,
                      index: RankIndex) -> torch.Tensor:
    """int32[E]: the rank of each live event key, the number of rows of
    ``index.rows`` that are ``<=`` it (an upper-bound binary search, as the
    rank kernel does it); 0 for the padding events ``e >= n_ev``, which then
    match nothing."""
    e = ev_keys.shape[0]
    dev = ev_keys.device
    n_u = index.rows.shape[0]
    lo = torch.zeros(e, dtype=torch.int64, device=dev)
    hi = torch.full((e,), n_u, dtype=torch.int64, device=dev)
    for _ in range(max(n_u, 1).bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        row = index.rows[mid.clamp(max=max(n_u - 1, 0))] if n_u else ev_keys
        le = ~_rows_less(ev_keys, row)       # row <= key
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    ranks = lo.to(torch.int32)
    ranks[n_ev:] = 0
    return ranks


def rank_match_wmajor(ranks: torch.Tensor, ev_revs: torch.Tensor, n_ev: int,
                      index: RankIndex, w_unbounded: torch.Tensor,
                      w_min_rev: torch.Tensor) -> torch.Tensor:
    """bool[W, E]: the match rule in rank space, events ``e >= n_ev``
    False."""
    r = ranks.view(1, -1)
    hit = ((index.rs.view(-1, 1) < r)
           & (w_unbounded.to(torch.bool).view(-1, 1) | (r <= index.re.view(-1, 1)))
           & (w_min_rev.view(-1, 1) <= ev_revs.view(1, -1)))
    return hit & (torch.arange(r.shape[1], device=r.device) < n_ev).view(1, -1)


def check_index(index: RankIndex, w: int, c: int, dev) -> None:
    """Raise unless ``index`` is a rank index of ``w`` slots built at ``c``
    key chunks on ``dev`` (events packed at another width would rank
    wrongly, and silently)."""
    rows, rs, re = index
    ok = (rows.dtype == rs.dtype == re.dtype == torch.int32
          and rows.dim() == 2 and rows.shape[1] == c
          and tuple(rs.shape) == tuple(re.shape) == (w,)
          and rows.device == rs.device == re.device == dev
          and rows.is_contiguous() and rs.is_contiguous()
          and re.is_contiguous())
    if not ok:
        raise ValueError(
            f"rank index does not fit a table of {w} slots at C={c} on {dev}: "
            f"rows {rows.dtype}{list(rows.shape)}, rs {list(rs.shape)}, "
            f"re {list(re.shape)} on {rows.device}")


def _ranked(ev_keys, n_ev, w_start, w_end, index):
    if index is None:
        index = rank_index_plain(w_start, w_end)
    check_index(index, w_start.shape[0], ev_keys.shape[1], ev_keys.device)
    return index, event_ranks_plain(ev_keys, n_ev, index)


def compact_flat(flat: torch.Tensor, size: int) -> torch.Tensor:
    """int32[size]: the ``True`` positions of a flat bool mask, ascending,
    truncated at ``size``, then ``fill = len(flat)`` (``_compact`` of the
    JAX dispatch: the j-th match is the first position whose running count
    reaches j + 1)."""
    csum = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32)
    q = torch.arange(1, size + 1, dtype=torch.int32, device=flat.device)
    return torch.searchsorted(csum, q).to(torch.int32)


def _check_flat(w: int, e: int) -> None:
    if w * e > MAX_FLAT:
        raise ValueError(
            f"fan-out over {w} watcher slots x {e} events exceeds the int32 "
            f"flat index (W*E <= 2^31 - 1)")


def _block_mask(ev_keys, ev_revs, n_ev, w_start, w_end, w_unbounded,
                w_min_rev):
    mask = fanout_mask_range_wmajor(ev_keys, ev_revs, w_start, w_end,
                                    w_unbounded, w_min_rev)
    e = mask.shape[1]
    return mask & (torch.arange(e, device=mask.device) < n_ev).view(1, -1)


def fanout_dispatch_plain(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                          w_unbounded, w_min_rev, size: int):
    """J4 (``fanout_dispatch`` of the JAX package on one device): match one
    E-padded drain block against every watcher slot → ``(counts int32[W],
    idx int32[size])``. Events ``e >= n_ev`` are padding and match nothing
    (a padding event's empty key at revision 0 would match every unbounded
    ``min_rev = 0`` watcher); ``idx`` holds the ascending flat positions
    ``w * E + e`` of the matches over the padded E, the first ``size`` of
    them, then ``W * E``."""
    mask = _block_mask(ev_keys, ev_revs, n_ev, w_start, w_end, w_unbounded,
                       w_min_rev)
    _check_flat(*mask.shape)
    counts = mask.sum(dim=1, dtype=torch.int32)
    return counts, compact_flat(mask.reshape(-1), size)


def fanout_mask_rank_plain(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                           w_unbounded, w_min_rev,
                           index: RankIndex | None = None) -> torch.Tensor:
    """The E-major mask ``bool[E, W]`` in rank space, the math of K5; rows
    ``e >= n_ev`` False."""
    index, ranks = _ranked(ev_keys, n_ev, w_start, w_end, index)
    return rank_match_wmajor(ranks, ev_revs, n_ev, index, w_unbounded,
                             w_min_rev).t().contiguous()


#: status words of the look-back: the aggregate of one block, or the
#: inclusive prefix of every block up to it
_AGGREGATE, _PREFIX = 1, 2


def lookback_offsets(block_sums: list[int], resident: int) -> list[int]:
    """The exclusive offset of each block as K4's decoupled look-back finds
    it. Blocks take tickets in launch order and run ``resident`` at a time;
    each publishes its aggregate, then its warp reads the status words of
    the 32 nearest earlier blocks (lane l: block b - 1 - l), sums the
    values up to and including the nearest inclusive prefix, or all 32
    aggregates and moves the window back; at last it publishes its own
    inclusive prefix. Before the start of the grid reads as a prefix of
    0."""
    n = len(block_sums)
    status: list[tuple[int, int]] = [(0, 0)] * n
    out = [0] * n
    for w0 in range(0, n, resident):
        wave = range(w0, min(n, w0 + resident))
        for b in wave:
            status[b] = (_PREFIX if b == 0 else _AGGREGATE, block_sums[b])
        for b in wave:
            excl, j = 0, b - 1
            while b > 0:
                window = [status[j - lane] if j - lane >= 0 else (_PREFIX, 0)
                          for lane in range(LANES)]
                assert all(flag for flag, _v in window), "unpublished"
                stop = next((lane for lane, (flag, _v) in enumerate(window)
                             if flag == _PREFIX), None)
                excl += sum(v for _f, v in window[:LANES if stop is None
                                                   else stop + 1])
                if stop is not None:
                    break
                j -= LANES
            out[b] = excl
        for b in wave:
            status[b] = (_PREFIX, out[b] + block_sums[b])
    return out


def fanout_dispatch_ranked(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                           w_unbounded, w_min_rev, size: int,
                           index: RankIndex | None = None,
                           resident: int = 264):
    """:func:`fanout_dispatch_plain` computed the way K4 computes it, in
    the rank space of the table's index (built here when ``index`` is
    None); K4's wrapper computes it on the CPU:

    - the rank kernel: each live event's rank by binary search over the
      index's rows (the padding events rank 0);
    - one fused launch, a block per ``WATCHERS_PER_BLOCK`` watcher slots:
      phase A, each slot's warp takes the events 32 at a time, one lane
      each, and counts the hits of the three compares;
      the block's sum finds its offset by the decoupled look-back
      (:func:`lookback_offsets`, blocks ``resident`` at a time), and a slot
      its offset within the block by an exclusive scan of the slots'
      counts; phase B, the same ballots again (slots without a match are
      skipped), a lane's hit going to the slot's offset + the hits of the
      earlier ballots + the hits of the lanes below it in its ballot,
      while that is below ``size``; the positions from the total on hold
      the fill ``W * E``.

    The ranks are exactly the row-major order of the mask, so ``idx`` is
    :func:`compact_flat`'s (a rank that collided or skipped would show as a
    permutation or a gap)."""
    index, ranks = _ranked(ev_keys, n_ev, w_start, w_end, index)
    mask = rank_match_wmajor(ranks, ev_revs, n_ev, index, w_unbounded,
                             w_min_rev)
    w, e = mask.shape
    _check_flat(w, e)
    dev = mask.device
    pad_e = -e % LANES
    ballots = torch.nn.functional.pad(mask, (0, pad_e)).view(w, -1, LANES)
    pops = ballots.sum(dim=2, dtype=torch.int32)                # [W, E/32]
    counts = pops.sum(dim=1, dtype=torch.int32)
    nb = -(-w // WATCHERS_PER_BLOCK)
    per_block = torch.nn.functional.pad(
        counts, (0, nb * WATCHERS_PER_BLOCK - w)).view(nb, WATCHERS_PER_BLOCK)
    block_off = torch.tensor(
        lookback_offsets(per_block.sum(dim=1).tolist(), resident),
        dtype=torch.int32, device=dev)
    in_block = torch.cumsum(per_block, 1, dtype=torch.int32) - per_block
    offset = (block_off.view(-1, 1) + in_block).reshape(-1)[:w]
    earlier = torch.cumsum(pops, 1, dtype=torch.int32) - pops
    below = torch.cumsum(ballots, 2, dtype=torch.int32) - ballots.to(torch.int32)
    pos = offset.view(w, 1, 1) + earlier.unsqueeze(2) + below
    hit = ballots & (pos < size)
    flat = (torch.arange(w, dtype=torch.int32, device=dev).view(w, 1) * e
            + torch.arange(e + pad_e, dtype=torch.int32, device=dev).view(1, -1))
    idx = torch.full((size,), w * e, dtype=torch.int32, device=dev)
    idx[pos[hit].long()] = flat.view(w, -1, LANES)[hit]
    return counts, idx


# ------------------------------------------------------------- legacy matcher
#: the legacy table's padding rows: start = the largest key, end = the
#: empty key, bounded — they can never match
_PAD_START = np.int32(0x7FFFFFFF)
_PAD_END = np.int32(-0x80000000)


class FanoutMatcher:
    """Host adapter: WatcherHub-compatible matcher backed by the E-major
    range mask (``--fanout-impl legacy``).

    Callable as (events, [(wid, start, end, min_rev)], version=None) ->
    bool[E, W] in spec order (the hub's ``fanout_matcher`` hook). Re-packs
    the watcher table only when the watcher set changes; event batches are
    packed per call. The mask comes from K5 on a CUDA device and from
    :func:`fanout_mask_rank_plain` on the CPU (``fanout_kernels``), both in
    the rank space of the cached table's index.

    ``mesh``: a multi-device watcher table waits for multi-GPU support, so
    only ``None`` is taken and the ``kb.fanout.sharded`` gauge reads 0.
    ``device=None`` means ``cuda`` and raises without a card.
    """

    def __init__(self, width: int = keyops.KEY_WIDTH, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError("a sharded watcher table needs "
                                      "multi-GPU support")
        self.device = resolve_device(device)
        self._width = width
        self._cache_key: tuple | None = None
        self._cached = None
        self._index: RankIndex | None = None  # of the cached columns

    def set_metrics(self, metrics) -> None:
        """Arm the ``kb.fanout.sharded`` gauge: 1 when the watcher table is
        distributed over several devices, which the port does not do yet."""
        if metrics is not None:
            metrics.emit_gauge("kb.fanout.sharded", 0.0)
            metrics.register_gauge_fn("kb.fanout.sharded", lambda: 0.0)

    def _watcher_table(self, specs: list[tuple[int, bytes, bytes, int]],
                       version=None):
        """Packed watcher columns, W-padded to a power-of-2 bucket of at
        least 64 with never-match rows. ``version`` (the hub's watcher-set
        counter) makes the cache check O(1); it is widened with the
        population's count and first and last wid, because a restarted hub
        reuses versions from 0 and a bare version match could serve a dead
        population. Without it the key is the O(W) spec tuple. The rank
        index of the columns is rebuilt in the same step (``_index``)."""
        if version is not None:
            cache_key = (version, len(specs),
                         specs[0][0] if specs else None,
                         specs[-1][0] if specs else None)
        else:
            cache_key = tuple(specs)
        if cache_key != self._cache_key:
            w = len(specs)
            wpad = pow2_at_least(w, 64)
            starts = np.full((wpad, self._width // 4), _PAD_START, np.int32)
            ends = np.full((wpad, self._width // 4), _PAD_END, np.int32)
            unbounded = np.zeros(wpad, bool)
            min_rev = np.zeros(wpad, np.int64)
            if w:
                # NUL-bearing bounds (single-key watches end at key + b"\0")
                # are canonicalized for the zero-padded compare
                s, _ = keyops.pack_keys(
                    [keyops.canonicalize_bound(s) for _, s, _, _ in specs],
                    self._width)
                e, _ = keyops.pack_keys(
                    [keyops.canonicalize_bound(e) for _, _, e, _ in specs],
                    self._width)
                starts[:w], ends[:w] = scan.flip_sign(s), scan.flip_sign(e)
                unbounded[:w] = [not e for _, _, e, _ in specs]
                min_rev[:w] = revisions([r for _, _, _, r in specs])
            dev = self.device
            self._cached = tuple(torch.from_numpy(a).to(dev) for a in
                                 (starts, ends, unbounded, min_rev))
            self._index = rank_index_plain(self._cached[0], self._cached[1])
            check_index(self._index, wpad, self._width // 4,
                        self._cached[0].device)
            self._cache_key = cache_key
        return self._cached

    def __call__(self, events, watcher_specs, version=None) -> np.ndarray:
        from . import fanout_kernels

        ws, we, wu, wr = self._watcher_table(watcher_specs, version)
        e = len(events)
        # E-pad to a bucket, as the JAX matcher does for its compile cache;
        # the padding events are masked out by n_ev
        epad = pow2_at_least(e, 8)
        keys = [ev.key for ev in events] + [b""] * (epad - e)
        revs = [ev.revision for ev in events] + [0] * (epad - e)
        ek, _ = keyops.pack_keys(keys, self._width)
        dev = self.device
        ek = torch.from_numpy(scan.flip_sign(ek)).to(dev)
        er = torch.from_numpy(revisions(revs)).to(dev)
        with TRACER.stage("fanout_dispatch"):
            mask = fanout_kernels.fanout_mask_range(ek, er, e, ws, we, wu, wr,
                                                    index=self._index)
        with TRACER.stage("fanout_copy"):
            return _host_pull(mask)[:e, :len(watcher_specs)]
