"""The single fan-out dispatch funnel.

:func:`fanout_dispatch` is the ONE place the block-batched path reaches the
fan-out kernel K4 (``ops/fanout_kernels.fanout_dispatch``, which computes
the plain version for CPU tensors). Everything above it (matcher, hub,
backend) works in terms of compacted (watcher, event) index pairs and never
sees the [W, E] mask: K4 never writes it.

Contract (``kubebrain_tpu/fanout/dispatch.py:68-104`` on one device):

- events arrive E-padded to a bucket, with ``n_ev`` the real ones; the
  padding events (empty key, revision 0) are masked out on the device,
  since they would otherwise match every unbounded ``min_rev = 0`` watcher;
- it returns ``(counts int32[W], idx int32[size])``: per-slot match counts,
  then the watcher-major flat indices ``w * E + e`` (padded E) of the
  matches, ascending, real ones first, then ``fill = W * E``;
- ``sum(counts) > size`` means the indices were truncated: the caller
  re-dispatches with a bigger ``size``. With ``with_total=True`` the call
  also returns that sum as ``int32[1]``, written by the same launch, and
  the host reads it and the first ``total`` entries only, so a transfer is
  O(matched pairs);
- the caller passes the table's rank index (``WatcherTable.shard_views``:
  one per slot of a sharded table, each dispatched on its own watcher
  slice) as ``index``; without it the call builds one from the bound rows;
- the flat indices are int32, as in the JAX package, so ``W * E`` must not
  pass ``ops.fanout.MAX_FLAT`` (K4's wrapper raises): a caller with a
  longer block splits it into pieces of :func:`max_block_events`.
"""

from __future__ import annotations

from ..ops import fanout
from ..ops.fanout_kernels import fanout_dispatch

__all__ = ["fanout_dispatch", "max_block_events"]


def max_block_events(capacity: int) -> int:
    """The longest pow2 E bucket whose flat indices over ``capacity`` watcher
    slots stay within int32 (16,384 events at 100,352 slots)."""
    e = 1
    while capacity * e * 2 <= fanout.MAX_FLAT:
        e *= 2
    return e
