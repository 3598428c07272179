"""Kernel launches counted by owner.

Every kernel wrapper adds one to its own count (``fn.launches``) where it
launches its kernel, and calls :func:`count` there too: the launch is then
also counted under the owner that the calling thread named with
:func:`owned_by`, where it named one. A scanner or a matcher wraps its
kernel calls in ``owned_by(self.launch_owner)`` (None by default, which
counts nothing more), so a process that runs two engines, such as a
leader and its follower, can tell their launches apart."""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()  # (owner, kernel) → n


@contextlib.contextmanager
def owned_by(owner: str | None):
    """Count the kernel launches this thread makes inside the block under
    ``owner`` (None: under nobody)."""
    prev = getattr(_local, "owner", None)
    _local.owner = owner
    try:
        yield
    finally:
        _local.owner = prev


def count(kernel: str) -> None:
    """One launch of ``kernel``, counted under the calling thread's owner."""
    owner = getattr(_local, "owner", None)
    if owner is not None:
        with _lock:
            _counts[(owner, kernel)] += 1


def take(owner: str) -> dict[str, int]:
    """``{kernel: launches}`` counted under ``owner`` since the last take;
    sets them to 0."""
    with _lock:
        out = {k: n for (o, k), n in _counts.items() if o == owner}
        for k in out:
            del _counts[(owner, k)]
    return out
