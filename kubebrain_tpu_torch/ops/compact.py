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
"""

from __future__ import annotations

import torch

from .scan import lex_less


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
