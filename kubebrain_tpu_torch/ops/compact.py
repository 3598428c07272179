"""Compaction victim mask in plain PyTorch — the CPU path and the oracle the
CUDA kernel K3 (``ops/compact_kernels.py``) is held to.

Counterpart of ``kubebrain_tpu/ops/compact.py::victim_mask`` with the range
restriction of the engine's ``_victim_batch`` folded in, on the layout the
kernels read (``ops/scan.py``): keys int32[P, C, N] chunk-major and
sign-flipped, revisions int64[P, N], tombstone and TTL-key flags int8[P, N].

Rows are sorted by (key, revision) inside each partition, and no partition
splits a key's version chain. Per valid row i::

    le[i]        = rev[i] <= compact_rev
    same_next[i] = row i+1 is valid and holds the same key
    superseded   = le[i] & same_next[i] & le[i+1]
    dead_tomb    = le[i] & !(same_next[i] & le[i+1]) & tomb[i]
    ttl_expired  = ttl[i] & rev[last row of i's group] <= ttl_cutoff
    victim       = (superseded | dead_tomb | ttl_expired)
                   & start <= key[i] & (unbounded | key[i] < end)

A TTL group expires whole however long its chain is: these are the
semantics of the Pallas kernel (``ops/compact_pallas.py``), not the jnp
kernel's 64-row cap on the backward broadcast.

:func:`victim_mask` computes this directly. :func:`victim_tile_classes`,
:func:`victim_lookback` and :func:`victim_mask_tiled` compute it the way the
CUDA kernel does: each tile of ``TILE_ROWS`` rows is classified from its
first and last valid key, and a TTL row whose group is still open at its
tile's last row takes the verdict of the first group end in a later tile,
found by a walk over the tiles' published status words.
"""

from __future__ import annotations

import torch

from .scan import INSIDE, OUTSIDE, STRADDLE, lex_less


def victim_mask(keys_t: torch.Tensor, revs: torch.Tensor, tomb: torch.Tensor,
                ttl: torch.Tensor, n_valid: torch.Tensor, start: torch.Tensor,
                end: torch.Tensor, unbounded: bool, compact_rev: int,
                ttl_cutoff: int) -> torch.Tensor:
    """bool[P, N]: version rows deletable when compacting to ``compact_rev``.

    start/end int32[C] flipped bounds (start inclusive, end exclusive,
    ``unbounded`` ignores ``end``); ``ttl_cutoff`` 0 skips the TTL pass."""
    p, _c, n = keys_t.shape
    dev = keys_t.device
    rows = torch.arange(n, device=dev)
    valid = rows.unsqueeze(0) < n_valid.to(torch.int64).unsqueeze(1)   # [P, N]
    le = valid & (revs <= int(compact_rev))
    same_next = torch.zeros((p, n), dtype=torch.bool, device=dev)
    le_next = torch.zeros((p, n), dtype=torch.bool, device=dev)
    if n > 1:
        same_next[:, :-1] = ((keys_t[:, :, :-1] == keys_t[:, :, 1:]).all(dim=1)
                             & valid[:, 1:])
        le_next[:, :-1] = le[:, 1:]
    newer_le = same_next & le_next
    victims = (le & newer_le) | (le & ~newer_le & (tomb != 0))
    if ttl_cutoff > 0:
        # each group's verdict is that of its last row: a reverse running
        # minimum over the group-end indices gives every row the index of
        # the first group end at or after it (the last valid row always
        # ends a group), and a gather brings that row's verdict back
        is_last = valid & ~same_next
        end_at = torch.where(is_last, rows, n).flip(1).cummin(dim=1).values.flip(1)
        last_expired = is_last & (revs <= int(ttl_cutoff))
        victims |= (last_expired.gather(1, end_at.clamp(max=n - 1))
                    & (ttl != 0) & valid)
    bounds = torch.stack([start, end])                                  # [2, C]
    less = lex_less(keys_t, bounds)                                     # [2, P, N]
    in_range = ~less[0] & (less[1] | bool(unbounded))
    return victims & in_range


#: threads of a K3 block and the consecutive rows each owns
#: (csrc/compact_victims.cu); a block owns one tile of TILE_ROWS rows
THREADS = 256
ROWS_PER_THREAD = 8
TILE_ROWS = THREADS * ROWS_PER_THREAD
#: tile classes: OUTSIDE, INSIDE and STRADDLE as for K1/K2's blocks; PAST:
#: the tile starts at or past n_valid (the kernel treats it as outside)
PAST = 3
#: a tile's status word, and a group end's TTL verdict
NO_END, KEPT, EXPIRED = 1, 2, 3


def n_tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def victim_tile_classes(keys_t: torch.Tensor, n_valid: torch.Tensor,
                        start: torch.Tensor, end: torch.Tensor,
                        unbounded: bool, tile: int = TILE_ROWS) -> torch.Tensor:
    """int8[P, ceil(N / tile)]: each kernel tile's class.

    Tile b owns rows b·tile .. b·tile + tile - 1 and is classified from the
    keys of its first row and of its last row below ``n_valid``: PAST when
    it starts at or past ``n_valid``; OUTSIDE when the last key < start or
    the first key >= a bounded end; INSIDE when the first key >= start and
    the last key < end (or no end); else STRADDLE. Exact only on sorted
    partitions, the kernel's precondition."""
    p, c, n = keys_t.shape
    nt = n_tiles(n, tile)
    b0 = (torch.arange(nt, device=keys_t.device) * tile).expand(p, nt)
    nv = n_valid.to(torch.int64).view(p, 1)
    last = (torch.minimum(b0 + tile, nv) - 1).clamp(min=0)

    def edge_keys(rows):                                             # [P, C, T]
        rows = rows.clamp(max=n - 1).unsqueeze(1).expand(p, c, nt)
        return keys_t.gather(2, rows)

    bounds = torch.stack([start, end])
    less_first = lex_less(edge_keys(b0), bounds)                     # [2, P, T]
    less_last = lex_less(edge_keys(last), bounds)
    unb = bool(unbounded)
    outside = less_last[0] | (~less_first[1] & (not unb))
    inside = ~outside & ~less_first[0] & (less_last[1] | unb)
    out = torch.full((p, nt), STRADDLE, dtype=torch.int8, device=keys_t.device)
    out[inside] = INSIDE
    out[outside] = OUTSIDE
    out[b0 >= nv] = PAST
    return out


def _tiled(keys_t, revs, ttl, n_valid, start, end, unbounded, ttl_cutoff,
           tile):
    """The kernel's per-tile plan → (tile classes int8[P, T], rows in
    range bool[P, N], each row's TTL verdict int8[P, N] (0 where
    ``ttl_cutoff`` <= 0), the tile where each tile's look-back stops
    int64[P, T], -1 where it looks back at none)."""
    p, _c, n = keys_t.shape
    dev = keys_t.device
    nt = n_tiles(n, tile)
    cls = victim_tile_classes(keys_t, n_valid, start, end, unbounded, tile)
    rows = torch.arange(n, device=dev)
    owner = rows // tile
    valid = rows.unsqueeze(0) < n_valid.to(torch.int64).unsqueeze(1)   # [P, N]
    k = cls[:, owner]
    exact = ~lex_less(keys_t, start.view(1, -1))[0]
    if not unbounded:
        exact &= lex_less(keys_t, end.view(1, -1))[0]
    in_range = valid & ((k == INSIDE) | ((k == STRADDLE) & exact))
    reach = torch.full((p, nt), -1, dtype=torch.int64, device=dev)
    if ttl_cutoff <= 0:
        no_ttl = torch.zeros((p, n), dtype=torch.int8, device=dev)
        return cls, in_range, no_ttl, reach
    # group ends and their verdicts, in the tiles that are not outside
    same_next = torch.zeros((p, n), dtype=torch.bool, device=dev)
    if n > 1:
        same_next[:, :-1] = ((keys_t[:, :, :-1] == keys_t[:, :, 1:]).all(dim=1)
                             & valid[:, 1:])
    live = (k == INSIDE) | (k == STRADDLE)
    gend = valid & live & ~same_next
    verdict = torch.zeros((p, n + 1), dtype=torch.int8, device=dev)  # [:, n]: 0
    verdict[:, :n] = torch.where(gend, torch.where(revs <= int(ttl_cutoff),
                                                   EXPIRED, KEPT), 0)
    # inside each tile, the first group end at or after each row (n: none)
    ends = torch.full((p, nt * tile), n, dtype=torch.int64, device=dev)
    ends[:, :n] = torch.where(gend, rows, n)
    ends = ends.view(p, nt, tile).flip(2).cummin(dim=2).values.flip(2)
    status = torch.full((p, nt + 1), KEPT, dtype=torch.int8, device=dev)
    status[:, :nt] = verdict.gather(1, ends[:, :, 0])
    status[:, :nt][status[:, :nt] == 0] = NO_END
    # the first tile at or after each tile with a group end (nt: none, read
    # as KEPT), by a reverse pass over the tiles
    tiles = torch.arange(nt + 1, device=dev).expand(p, nt + 1)
    first = torch.where(status != NO_END, tiles, nt)
    first = first.flip(1).cummin(dim=1).values.flip(1)
    tail = status.gather(1, first)[:, 1:]                               # [P, T]
    ends = ends.view(p, nt * tile)[:, :n]
    row_v = torch.where(ends < n, verdict.gather(1, ends), tail[:, owner])
    # a tile looks back where a TTL row in range has no group end after it
    open_ttl = (ttl != 0) & in_range & (ends == n)
    waits = torch.zeros((p, nt), dtype=torch.int64, device=dev).scatter_add_(
        1, owner.expand(p, n), open_ttl.to(torch.int64)) > 0
    reach = torch.where(waits, first[:, 1:], -1)
    return cls, in_range, row_v, reach


def victim_lookback(keys_t: torch.Tensor, revs: torch.Tensor, ttl: torch.Tensor,
                    n_valid: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                    unbounded: bool, ttl_cutoff: int, tile: int = TILE_ROWS):
    """(tile classes int8[P, T], reach int64[P, T]): for each tile that
    looks back (it holds an in-range TTL row whose group is still open at
    its last row), the tile whose status ends the walk; -1 for the others."""
    cls, _r, _v, reach = _tiled(keys_t, revs, ttl, n_valid, start, end,
                                unbounded, ttl_cutoff, tile)
    return cls, reach


def victim_mask_tiled(keys_t: torch.Tensor, revs: torch.Tensor,
                      tomb: torch.Tensor, ttl: torch.Tensor,
                      n_valid: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor, unbounded: bool, compact_rev: int,
                      ttl_cutoff: int, tile: int = TILE_ROWS) -> torch.Tensor:
    """bool[P, N]: :func:`victim_mask` assembled as the kernel assembles
    it. A row is in range when its tile is INSIDE, or when its tile
    STRADDLES and the row's key compares in range; OUTSIDE and PAST tiles
    contribute nothing. A TTL row takes the verdict of the first group end
    at or after it inside its tile; without one, that of the first group
    end in a later tile (the status words, read by a reverse pass over the
    tiles). Equal to :func:`victim_mask` on sorted partitions."""
    p, _c, n = keys_t.shape
    _cls, in_range, row_v, _reach = _tiled(keys_t, revs, ttl, n_valid, start,
                                           end, unbounded, ttl_cutoff, tile)
    rows = torch.arange(n, device=keys_t.device)
    valid = rows.unsqueeze(0) < n_valid.to(torch.int64).unsqueeze(1)
    le = revs <= int(compact_rev)
    newer_le = torch.zeros((p, n), dtype=torch.bool, device=keys_t.device)
    if n > 1:
        newer_le[:, :-1] = ((keys_t[:, :, :-1] == keys_t[:, :, 1:]).all(dim=1)
                            & valid[:, 1:] & le[:, 1:])
    return in_range & ((le & (newer_le | (tomb != 0)))
                       | ((ttl != 0) & (row_v == EXPIRED)))
