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
"""

from __future__ import annotations

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


def fanout_dispatch_ranked(ev_keys, ev_revs, n_ev: int, w_start, w_end,
                           w_unbounded, w_min_rev, size: int):
    """:func:`fanout_dispatch_plain` computed the way K4 computes it:

    - count pass: each watcher slot's warp takes the events 32 at a time,
      one lane each, and adds the popcount of each ballot;
    - offsets: the counts of each block of 32 slots are summed, the block
      sums scanned exclusively (one block of the kernel), and each slot's
      offset is its block's plus the counts of the slots before it in the
      block;
    - write pass: the same ballots again; a lane's hit goes to the slot's
      offset + the hits of the earlier ballots + the hits of the lanes
      below it in its ballot, while that is below ``size``; the positions
      from the total on hold the fill ``W * E``.

    The ranks are exactly the row-major order of the mask, so ``idx`` is
    :func:`compact_flat`'s (a rank that collided or skipped would show as a
    permutation or a gap)."""
    mask = _block_mask(ev_keys, ev_revs, n_ev, w_start, w_end, w_unbounded,
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
    block_sums = per_block.sum(dim=1, dtype=torch.int32)
    block_off = torch.cumsum(block_sums, 0, dtype=torch.int32) - block_sums
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
    :func:`fanout_mask_range` on the CPU (``fanout_kernels``).

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
        population. Without it the key is the O(W) spec tuple."""
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
            mask = fanout_kernels.fanout_mask_range(ek, er, e, ws, we, wu, wr)
        with TRACER.stage("fanout_copy"):
            return _host_pull(mask)[:e, :len(watcher_specs)]
