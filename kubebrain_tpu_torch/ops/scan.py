"""MVCC visibility scan in plain PyTorch — the CPU path and the oracle the
CUDA kernels (``ops/scan_kernels.py``) are held to.

Counterpart of ``kubebrain_tpu/ops/scan.py``, batched explicitly over P
partitions and Q queries, on the layout the kernels read:

- keys ``int32[P, C, N]``: chunk-major, big-endian uint32 chunks with the
  sign bit flipped, so a signed compare is unsigned byte order;
- revisions ``int64[P, N]`` (one column; no 31-bit split);
- tombstones ``int8[P, N]``; valid rows per partition ``int32[P]``.

Rows are sorted by (key, revision) inside each partition and partitions
never split a key's version chain, so per query and row::

    cand[i]    = i < n_valid & start <= key[i] & (unbounded | key[i] < end)
                 & rev[i] <= read_rev
    visible[i] = cand[i] & !(key[i] == key[i+1] & cand[i+1]) & !tomb[i]

:func:`visibility_mask` computes this directly. :func:`block_classes` and
:func:`visibility_mask_blocked` compute it the way the CUDA kernel does: the
rows of a key range are one contiguous run of each sorted partition, so each
256-row block is classified per query from its first and last key, and only
the blocks a range's edge falls in compare keys with bounds.
"""

from __future__ import annotations

import numpy as np
import torch


def flip_sign(chunks: np.ndarray) -> np.ndarray:
    """uint32 chunks → order-preserving int32 (big-endian unsigned order)."""
    return (np.asarray(chunks).astype(np.uint32)
            ^ np.uint32(0x80000000)).view(np.int32)


def prepare_layout(keys_host: np.ndarray, revs_host: np.ndarray,
                   tomb_host: np.ndarray):
    """Row-major mirror arrays → the kernel layout, on the host, once per
    mirror publish (counterpart of ``scan_pallas.prepare_mirror``; no row
    padding is needed, blocks mask the ragged edge themselves).

    keys_host uint32[P, N, C], revs_host uint64[P, N], tomb_host bool[P, N]
    → (keys_t int32[P, C, N], revs int64[P, N], tomb int8[P, N])."""
    keys_t = np.ascontiguousarray(np.transpose(flip_sign(keys_host), (0, 2, 1)))
    revs = np.asarray(revs_host, dtype=np.uint64)
    if revs.size and int(revs.max()) >= 2**63:
        raise ValueError("revision exceeds 2^63")
    return keys_t, revs.astype(np.int64), np.asarray(tomb_host).astype(np.int8)


def lex_less(keys_t: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """keys_t int32[P, C, N] < bounds int32[Q, C], lexicographically over
    the chunk axis → bool[Q, P, N]. The first differing chunk decides:
    folded from the last chunk to the first, so memory stays O(Q·P·N)."""
    q = bounds.shape[0]
    p, c, n = keys_t.shape
    less = torch.zeros((q, p, n), dtype=torch.bool, device=keys_t.device)
    for ci in range(c - 1, -1, -1):
        k = keys_t[:, ci, :].unsqueeze(0)          # [1, P, N]
        b = bounds[:, ci].view(q, 1, 1)            # [Q, 1, 1]
        less = (k < b) | ((k == b) & less)
    return less


def key_in_range(keys_t: torch.Tensor, starts: torch.Tensor,
                 ends: torch.Tensor, unbounded: torch.Tensor) -> torch.Tensor:
    """bool[Q, P, N]: start <= key < end (or no end) for each query."""
    unb = unbounded.to(torch.bool).view(-1, 1, 1)
    return ~lex_less(keys_t, starts) & (unb | lex_less(keys_t, ends))


def visibility_mask(keys_t: torch.Tensor, revs: torch.Tensor,
                    tomb: torch.Tensor, n_valid: torch.Tensor,
                    starts: torch.Tensor, ends: torch.Tensor,
                    unbounded: torch.Tensor,
                    read_revs: torch.Tensor) -> torch.Tensor:
    """bool[Q, P, N]: rows visible to each query.

    starts/ends int32[Q, C] flipped bounds (start inclusive, end
    exclusive), unbounded bool[Q] (ignore ``ends``), read_revs int64[Q]."""
    p, _c, n = keys_t.shape
    dev = keys_t.device
    rows = torch.arange(n, device=dev)
    valid = rows.unsqueeze(0) < n_valid.to(torch.int64).unsqueeze(1)   # [P, N]
    in_range = key_in_range(keys_t, starts, ends, unbounded)
    rev_le = revs.unsqueeze(0) <= read_revs.to(torch.int64).view(-1, 1, 1)
    cand = valid.unsqueeze(0) & in_range & rev_le                      # [Q, P, N]
    same_next = torch.zeros((p, n), dtype=torch.bool, device=dev)
    if n > 1:
        same_next[:, :-1] = (keys_t[:, :, :-1] == keys_t[:, :, 1:]).all(dim=1)
    cand_next = torch.zeros_like(cand)
    cand_next[..., :-1] = cand[..., 1:]
    return cand & ~(same_next.unsqueeze(0) & cand_next) & (tomb == 0).unsqueeze(0)


#: rows a kernel block reads, and rows it owns: the last row it reads is
#: read only as the next row of its last owned row (csrc/scan_visibility.cu)
BLOCK_ROWS = 256
BLOCK_OWNED = BLOCK_ROWS - 1
#: block classes: no row the block reads is in range, every row is, or some
OUTSIDE, INSIDE, STRADDLE = 0, 1, 2


def block_classes(keys_t: torch.Tensor, n_valid: torch.Tensor,
                  starts: torch.Tensor, ends: torch.Tensor,
                  unbounded: torch.Tensor) -> torch.Tensor:
    """int8[Q, P, ceil(N / 255)]: each kernel block's class per query.

    Block b reads rows b·255 .. b·255 + 255 below ``n_valid`` (the last one
    only as a look-ahead row) and is classified from the keys of the first
    and the last of them: OUTSIDE when the last key < start, the first key
    >= a bounded end, or the block lies past ``n_valid``; INSIDE when the
    first key >= start and the last key < end (or no end); else STRADDLE.
    Exact only on sorted partitions, the kernel's precondition."""
    p, c, n = keys_t.shape
    dev = keys_t.device
    nb = (n + BLOCK_OWNED - 1) // BLOCK_OWNED
    b0 = (torch.arange(nb, device=dev) * BLOCK_OWNED).expand(p, nb)
    nv = n_valid.to(torch.int64).view(p, 1)
    past = b0 >= nv                                                  # [P, NB]
    last = torch.minimum(b0 + BLOCK_ROWS - 1, nv - 1).clamp(min=0)

    def edge_keys(rows):                                             # [P, C, NB]
        return keys_t.gather(2, rows.clamp(max=n - 1).unsqueeze(1).expand(p, c, nb))

    first_k, last_k = edge_keys(b0), edge_keys(last)
    unb = unbounded.to(torch.bool).view(-1, 1, 1)
    outside = (past.unsqueeze(0) | lex_less(last_k, starts)
               | (~unb & ~lex_less(first_k, ends)))
    inside = (~outside & ~lex_less(first_k, starts)
              & (unb | lex_less(last_k, ends)))
    out = torch.full(outside.shape, STRADDLE, dtype=torch.int8, device=dev)
    out[inside] = INSIDE
    out[outside] = OUTSIDE
    return out


def visibility_mask_blocked(keys_t: torch.Tensor, revs: torch.Tensor,
                            tomb: torch.Tensor, n_valid: torch.Tensor,
                            starts: torch.Tensor, ends: torch.Tensor,
                            unbounded: torch.Tensor,
                            read_revs: torch.Tensor) -> torch.Tensor:
    """bool[Q, P, N]: :func:`visibility_mask` assembled as the kernel
    assembles it. A row is in range when its block is INSIDE, or when its
    block STRADDLES and the row's key compares in range; OUTSIDE blocks
    contribute nothing. Each row's candidate bit is taken under the class of
    the block that owns it, and its next row's bit under the same block's
    class, as the kernel's look-ahead thread computes it. Equal to
    :func:`visibility_mask` on sorted partitions."""
    p, _c, n = keys_t.shape
    dev = keys_t.device
    cls = block_classes(keys_t, n_valid, starts, ends, unbounded)   # [Q, P, NB]
    exact = key_in_range(keys_t, starts, ends, unbounded)           # [Q, P, N]
    rev_le = revs.unsqueeze(0) <= read_revs.to(torch.int64).view(-1, 1, 1)
    nv = n_valid.to(torch.int64).view(1, p, 1)
    rows = torch.arange(n, device=dev)
    owner = rows // BLOCK_OWNED

    def cand(rws, blocks):
        k = cls[..., blocks]
        in_range = (k == INSIDE) | ((k == STRADDLE) & exact[..., rws])
        return in_range & rev_le[..., rws] & (rws < nv)

    own = cand(rows, owner)
    cand_next = torch.zeros_like(own)
    same_next = torch.zeros((p, n), dtype=torch.bool, device=dev)
    if n > 1:
        cand_next[..., :-1] = cand(rows[1:], owner[:-1])
        same_next[:, :-1] = (keys_t[:, :, :-1] == keys_t[:, :, 1:]).all(dim=1)
    return own & ~(same_next.unsqueeze(0) & cand_next) & (tomb == 0).unsqueeze(0)
